"""device_idle_share.lastfm: ``device_idle_share.train`` in the cells that report
``train_examples_per_s.lastfm``, which it moves; read by ``device_idle_share.train``'s
reader (``portbench/metrics/device_idle_share.train.py``).
"""

from portbench import harness

NAME = "device_idle_share.lastfm"
UNIT = "%"
LAYER = "device"
MOVES = "train_examples_per_s.lastfm"


def read(record, summary):
    return harness.metric_module("device_idle_share.train").read(record, summary)
