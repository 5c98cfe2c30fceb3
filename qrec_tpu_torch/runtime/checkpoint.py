"""Checkpoint / resume of a training run (counterpart of the JAX package's
``runtime/checkpoint.py``).

``Checkpointer`` keeps one ``torch.save`` file per step, ``step_<n>.pt``
in its directory, written to a temporary name and renamed into place, and
the newest ``max_to_keep`` of them. The JAX package's orbax step
directories are not read. Opt-in through the config surface, as in the
JAX package:

    checkpoint.setup=on -dir ./checkpoints/ -every 10
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

_STEP_FILE = re.compile(r"step_(\d+)\.pt$")


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def steps(self) -> List[int]:
        """The saved steps, oldest first."""
        found = (_STEP_FILE.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        tmp = f"{self.path(step)}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, self.path(step))
        for old in self.steps()[: -self.max_to_keep]:
            os.remove(self.path(old))

    def restore(self, step: Optional[int] = None) -> Any:
        """The state saved at ``step`` (the latest by default; None when
        there is none), its tensors on the CPU."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return torch.load(self.path(step), map_location="cpu", weights_only=True)


def from_config(conf) -> Optional[Checkpointer]:
    """A Checkpointer from ``checkpoint.setup`` (None when off)."""
    if not conf.contains("checkpoint.setup"):
        return None
    opts = conf.options("checkpoint.setup")
    if not opts.isMainOn():
        return None
    return Checkpointer(opts.get("-dir", "./checkpoints/"))


def checkpoint_every(conf) -> int:
    if not conf.contains("checkpoint.setup"):
        return 0
    return conf.options("checkpoint.setup").get_int("-every", 10)
