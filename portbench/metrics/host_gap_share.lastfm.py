"""host_gap_share.lastfm: ``host_gap_share.train`` in the cells that report
``train_examples_per_s.lastfm``, which it moves; read by ``host_gap_share.train``'s
reader (``portbench/metrics/host_gap_share.train.py``).
"""

from portbench import harness

NAME = "host_gap_share.lastfm"
UNIT = "%"
LAYER = "trainer"
MOVES = "train_examples_per_s.lastfm"


def read(record, summary):
    return harness.metric_module("host_gap_share.train").read(record, summary)
