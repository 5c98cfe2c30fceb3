"""train_mfu.lastfm: ``train_mfu`` in the cells that report
``train_examples_per_s.lastfm``, which it moves; read by ``train_mfu``'s
reader (``portbench/metrics/train_mfu.py``).
"""

from portbench import harness

NAME = "train_mfu.lastfm"
UNIT = "%"
LAYER = "whole step"
MOVES = "train_examples_per_s.lastfm"


def read(record, summary):
    return harness.metric_module("train_mfu").read(record, summary)
