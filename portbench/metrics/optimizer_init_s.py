"""optimizer_init_s: the making of the fit's first optimizer, in seconds.

Layer: trainer (``runtime/trainer.make_optimizer``: ``runtime/adam.Adam``,
whose construction, the first of a ``torch.optim`` optimizer in the
process, imports ``torch._dynamo``). Moves ``setup_s``. Read from the
program's own spans: the first ``trainer.optimizer`` span of the run's
fit. None where the program keeps no such span.
"""

from portbench import harness

NAME = "optimizer_init_s"
UNIT = "s"
LAYER = "trainer"
MOVES = "setup_s"
SPAN = "trainer.optimizer"


def read(record, summary):
    spans = harness.metric_module("warmup_s").fit_spans(SPAN)
    return (spans[0].end_ns - spans[0].start_ns) / 1e9 if spans else None
