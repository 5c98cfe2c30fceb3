"""graph_launch_ms.train: the host's launch of one epoch's CUDA graph, in
ms.

Layer: trainer (``runtime/trainer.GraphProgram.run``: ``CUDAGraph.replay``,
once an epoch inside ``ChunkedLoop``'s chunk). Moves
``train_examples_per_s``. Read from the program's own spans: the median of
the run's fit's ``graph.replay`` spans, almost all of them in the
unprofiled chunks. None where the program keeps no such span.
"""

import statistics

from portbench import harness

NAME = "graph_launch_ms.train"
UNIT = "ms"
LAYER = "trainer"
MOVES = "train_examples_per_s"
SPAN = "graph.replay"


def read(record, summary):
    spans = harness.metric_module("warmup_s").fit_spans(SPAN)
    if not spans:
        return None
    return statistics.median(s.end_ns - s.start_ns for s in spans) / 1e6
