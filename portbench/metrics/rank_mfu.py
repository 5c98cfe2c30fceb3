"""rank_mfu: the model's operations in the ranking window over the
window's wall at the card's bf16 peak, in %.

Layer: whole step. Moves ``rank_ms``. The operations of one evaluation
(``work.evaluation``: the main encoder's products and the catalogue's
scores) times the evaluations of the unprofiled window, over its wall at
989 TFLOP/s.
"""

from portbench import work

NAME = "rank_mfu"
UNIT = "%"
LAYER = "whole step"
MOVES = "rank_ms"


def read(record, summary):
    n, window = record.get("evaluations"), record.get("window_s")
    if not n or not window:
        return None
    return work.evaluation(record["shapes"]).flops * n / (window * work.PEAK_BF16) * 100.0
