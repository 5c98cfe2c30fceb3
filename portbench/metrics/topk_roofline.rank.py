"""topk_roofline.rank: the ranker's share of its roofline over the
profiled evaluations, in %.

Layer: ranker (``ops/topk.CatalogRanker`` on K2's fused masked top-k,
``csrc/masked_scores.cu``). Moves ``rank_ms``. The least time of the
evaluations' top-k (``work.topk``: 2 U_test I d operations at 495 TFLOP/s,
the fastest float32-keeping rate; the user rows, the item table and the
bitmask read once, the lists written once), over the device time that the
trace gives the kernels whose names hold ``catalog_tiles``.
"""

from portbench import work

NAME = "topk_roofline.rank"
UNIT = "%"
LAYER = "ranker"
MOVES = "rank_ms"
KERNELS = ("catalog_tiles",)


def read(record, summary):
    n = record.get("profiled_evaluations")
    if summary is None or not n:
        return None
    spent = sum(ms for name, ms in summary.by_name_ms.items()
                if any(k in name for k in KERNELS)) / 1e3
    if spent <= 0:
        return None
    s = record["shapes"]
    need = work.topk(s["test_users"], s["items"], s["d"], s["top_n"]).scaled(n)
    return need.least_s(work.PEAK_TF32) / spent * 100.0
