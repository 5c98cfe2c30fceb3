"""optimizer_share.lastfm: ``optimizer_share.train`` in the cells that report
``train_examples_per_s.lastfm``, which it moves; read by ``optimizer_share.train``'s
reader (``portbench/metrics/optimizer_share.train.py``).
"""

from portbench import harness

NAME = "optimizer_share.lastfm"
UNIT = "%"
LAYER = "trainer"
MOVES = "train_examples_per_s.lastfm"


def read(record, summary):
    return harness.metric_module("optimizer_share.train").read(record, summary)
