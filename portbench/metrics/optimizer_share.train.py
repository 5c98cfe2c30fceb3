"""optimizer_share.train: the optimizer's share of one training step's
device time, in %.

Layer: trainer (``runtime/adam.Adam``'s step on ``csrc/adam.cu`` and the
step's ``after_step``). Moves ``train_examples_per_s``. Read from the
program's device marks around the middle step of an epoch
(``runtime/trainer.run_epoch``: at the step's start, after the forward,
after the backward, after the optimizer), read once a chunk for the
chunk's last epoch: the median over the run's fit's chunks of the time
from the backward's end to the optimizer's end over the step's. None
where the program keeps no such reading.
"""

import statistics

from portbench import harness

NAME = "optimizer_share.train"
UNIT = "%"
LAYER = "trainer"
MOVES = "train_examples_per_s"


def read(record, summary):
    readings = harness.metric_module("sampler_ms.train").fit_readings()
    shares = [r["optimizer_ms"] / r["step_ms"] * 100.0 for r in readings
              if "optimizer_ms" in r and r.get("step_ms", 0) > 0]
    return statistics.median(shares) if shares else None
