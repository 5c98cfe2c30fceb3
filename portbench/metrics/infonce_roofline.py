"""infonce_roofline: the InfoNCE's share of its roofline in the profiled
training chunk, in %.

Layer: losses (``ops/losses.InfoNCELoss``: K3 forward, K4 backward). Moves
``train_examples_per_s``. The least time of the chunk's InfoNCE
(``work.epoch_infonce``: 2 B^2 d forward and 6 B^2 d backward for the B
distinct users and, apart, the B distinct items of each step, B the mean
over the reference's run of the first epochs; operations at 495 TFLOP/s,
the fastest float32-keeping rate), over the device time that the trace
gives the kernels whose names hold ``infonce``.
"""

from portbench import work

NAME = "infonce_roofline"
UNIT = "%"
LAYER = "losses"
MOVES = "train_examples_per_s"
KERNELS = ("infonce",)


def read(record, summary):
    epochs = record.get("profiled_epochs")
    if summary is None or not epochs or "unique_users" not in record["shapes"]:
        return None
    spent = sum(ms for name, ms in summary.by_name_ms.items()
                if any(k in name for k in KERNELS)) / 1e3
    need = work.epoch_infonce(record["shapes"]).scaled(epochs)
    if spent <= 0 or need.flops <= 0:
        return None
    return need.least_s(work.PEAK_TF32) / spent * 100.0
