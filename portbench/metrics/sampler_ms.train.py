"""sampler_ms.train: the sampler's device time in an epoch, in ms.

Layer: sampler (``ops/sampling.py``'s ``pairwise_epoch``, run inside the
epoch's CUDA graph). Moves ``train_examples_per_s``. Read from the
program's device marks (``runtime/trainer.EpochProgram``: a timing event
at the epoch's start and one after its sampler, nodes of the graph), which
``ChunkedLoop`` reads once a chunk after its host read, for the chunk's
last epoch (``runtime/profiling.recorder().readings``): the median over
the run's fit's chunks. None where the program keeps no such reading.
"""

import statistics

from portbench import harness

NAME = "sampler_ms.train"
UNIT = "ms"
LAYER = "sampler"
MOVES = "train_examples_per_s"
PHASE = "sampler_ms"


def fit_readings():
    """The mark readings of the program's latest fit; empty where there are
    none."""
    rec = harness.metric_module("warmup_s").recorder()
    fit = getattr(rec, "last_fit", None)
    if fit is None:
        return []
    return [r for r in list(rec.readings) if r.get("fit") == fit]


def median_of(phase):
    values = [r[phase] for r in fit_readings() if phase in r]
    return statistics.median(values) if values else None


def read(record, summary):
    return median_of(PHASE)
