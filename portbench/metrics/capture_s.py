"""capture_s: the recording of the fit's CUDA graphs, in seconds.

Layer: trainer (``runtime/trainer.GraphProgram.capture``: the epoch
recorded into a CUDA graph on its side stream, after the warm-up, and the
graph's instantiation). Moves ``setup_s``. Read from the program's own
spans: the ``graph.capture`` spans of the run's fit, summed (the
warm-up's are ``warmup_s``). None where the program keeps no such span.
"""

from portbench import harness

NAME = "capture_s"
UNIT = "s"
LAYER = "trainer"
MOVES = "setup_s"
SPAN = "graph.capture"


def read(record, summary):
    spans = harness.metric_module("warmup_s").fit_spans(SPAN)
    return sum(s.end_ns - s.start_ns for s in spans) / 1e9 if spans else None
