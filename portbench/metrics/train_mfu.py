"""train_mfu: the model's operations in the training window over the
window's wall at the card's bf16 peak, in %.

Layer: whole step. Moves ``train_examples_per_s``. The operations are the
model's, not the implementation's (``work.epoch_model``: the propagation's
products forward and backward, BPR, InfoNCE and the per-epoch evaluation's
ranking), times the window's epochs; the wall is the unprofiled window of
the same run; the peak is 989 TFLOP/s.
"""

from portbench import work

NAME = "train_mfu"
UNIT = "%"
LAYER = "whole step"
MOVES = "train_examples_per_s"


def read(record, summary):
    epochs, window = record.get("epochs"), record.get("window_s")
    if not epochs or not window or "unique_users" not in record["shapes"]:
        return None
    flops = work.epoch_model(record["shapes"]).flops * epochs
    return flops / (window * work.PEAK_BF16) * 100.0
