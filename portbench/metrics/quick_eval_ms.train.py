"""quick_eval_ms.train: the per-epoch quick evaluation's device time, in
ms.

Layer: ranker (``models/base.quick_eval_vector``: ``finalize``, the
ranker's top-k on K2 and the measures, then the device vote, inside the
epoch's CUDA graph). Moves ``train_examples_per_s``. Read from the
program's device marks (``runtime/trainer.EpochProgram``: after the steps
and after the evaluation), read once a chunk for the chunk's last epoch:
the median over the run's fit's chunks. None where the program keeps no
such reading, or the epochs evaluate nothing.
"""

from portbench import harness

NAME = "quick_eval_ms.train"
UNIT = "ms"
LAYER = "ranker"
MOVES = "train_examples_per_s"
PHASE = "eval_ms"


def read(record, summary):
    return harness.metric_module("sampler_ms.train").median_of(PHASE)
