"""propagation_roofline.lastfm: ``propagation_roofline.train`` in the cells that report
``train_examples_per_s.lastfm``, which it moves; read by ``propagation_roofline.train``'s
reader (``portbench/metrics/propagation_roofline.train.py``).
"""

from portbench import harness

NAME = "propagation_roofline.lastfm"
UNIT = "%"
LAYER = "propagation"
MOVES = "train_examples_per_s.lastfm"


def read(record, summary):
    return harness.metric_module("propagation_roofline.train").read(record, summary)
