"""propagation_roofline.rank: the propagation's share of its roofline over
the profiled evaluations, in %.

Layer: propagation (``models/graph.py`` through ``ops/spmm.spmm``: K1 or
K5). Moves ``rank_ms``. The least time of the main encoder's products of
the profiled evaluations (``work.propagation`` at d, one a layer; bytes at
3.35 TB/s, operations at 989 TFLOP/s for the bf16 operands), over the
device time that the trace gives the kernels whose names hold one of
``KERNELS``.
"""

from portbench import work

NAME = "propagation_roofline.rank"
UNIT = "%"
LAYER = "propagation"
MOVES = "rank_ms"
KERNELS = ("dual_regions", "reduce_partials", "segmm")


def read(record, summary):
    n = record.get("profiled_evaluations")
    if summary is None or not n:
        return None
    spent = sum(ms for name, ms in summary.by_name_ms.items()
                if any(k in name for k in KERNELS)) / 1e3
    if spent <= 0:
        return None
    s = record["shapes"]
    need = work.propagation(s["users"], s["items"], s["edges"], s["d"]).scaled(s["layers"] * n)
    return need.least_s(work.PEAK_BF16) / spent * 100.0
