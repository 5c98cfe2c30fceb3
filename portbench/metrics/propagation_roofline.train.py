"""propagation_roofline.train: the propagation's share of its roofline in
the profiled training chunk, in %.

Layer: propagation (``models/graph.py`` through ``ops/spmm.spmm``: K1, the
dual kernel, on the dense form; K5, the segment kernel, on the sparse
one). Moves ``train_examples_per_s``. The least time of the products the
chunk's epochs need (``work.epoch_propagation``: every step's forward and
backward products, and the per-epoch evaluation's; bytes at 3.35 TB/s,
operations at 989 TFLOP/s for the bf16 operands), over the device time
that the trace gives the kernels whose names hold one of ``KERNELS``. The
needed work is the same whatever kernel computes the product, so a path
that moves a graph from K1 to K5 moves this number and keeps it.
"""

from portbench import work

NAME = "propagation_roofline.train"
UNIT = "%"
LAYER = "propagation"
MOVES = "train_examples_per_s"
# K1 (csrc/dual_matmul.cu: its tile kernel and its reduction), K5
# (csrc/segment_matmul.cu)
KERNELS = ("dual_regions", "reduce_partials", "segmm")


def device_s(summary, kernels) -> float:
    return sum(ms for name, ms in summary.by_name_ms.items()
               if any(k in name for k in kernels)) / 1e3


def read(record, summary):
    epochs = record.get("profiled_epochs")
    if summary is None or not epochs:
        return None
    spent = device_s(summary, KERNELS)
    if spent <= 0:
        return None
    need = work.epoch_propagation(record["shapes"]).scaled(epochs)
    return need.least_s(work.PEAK_BF16) / spent * 100.0
