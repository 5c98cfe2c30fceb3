"""The plain reference of the benchmark's cells: plain PyTorch, which
imports nothing of the system under test and takes nothing that it made.

* :mod:`.dataset` — QRec's data semantics on the benchmark's own records:
  the id maps in first-appearance order (``data/rating.py:48-54``), the
  rated sets and the test sets;
* :mod:`.graph_cf` — LightGCN's and SimGCL's propagation, losses and Adam,
  and a training run that follows the system's first chunk of epochs from
  the benchmark's weights and the run's random stream;
* :mod:`.ranking` — the masked full-catalogue top-k and QRec's ranking
  measures.

Every function takes a :class:`Precision`: the reference computes in the
precision that the configuration states, the control one step below it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Precision(NamedTuple):
    """``dtype``: the tables, the state, the losses and the scores;
    ``operand``: what the propagation rounds its scaled inputs to before
    the product (its sums are float32)."""

    name: str
    dtype: torch.dtype
    operand: torch.dtype


# what the configurations state: float32, the propagation's operands bf16
REFERENCE = Precision("reference", torch.float32, torch.bfloat16)
# the nearest precision below it, part by part: bf16 for the float32 parts,
# fp8 (e4m3) for the bf16 operands
CONTROL = Precision("control", torch.bfloat16, torch.float8_e4m3fn)
