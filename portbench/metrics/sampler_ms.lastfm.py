"""sampler_ms.lastfm: ``sampler_ms.train`` in the cells that report
``train_examples_per_s.lastfm``, which it moves; read by ``sampler_ms.train``'s
reader (``portbench/metrics/sampler_ms.train.py``).
"""

from portbench import harness

NAME = "sampler_ms.lastfm"
UNIT = "ms"
LAYER = "sampler"
MOVES = "train_examples_per_s.lastfm"


def read(record, summary):
    return harness.metric_module("sampler_ms.train").read(record, summary)
