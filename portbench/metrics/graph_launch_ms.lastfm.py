"""graph_launch_ms.lastfm: ``graph_launch_ms.train`` in the cells that report
``train_examples_per_s.lastfm``, which it moves; read by ``graph_launch_ms.train``'s
reader (``portbench/metrics/graph_launch_ms.train.py``).
"""

from portbench import harness

NAME = "graph_launch_ms.lastfm"
UNIT = "ms"
LAYER = "trainer"
MOVES = "train_examples_per_s.lastfm"


def read(record, summary):
    return harness.metric_module("graph_launch_ms.train").read(record, summary)
