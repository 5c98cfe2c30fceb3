"""device_idle_share.rank: the share of the evaluations' wall in which
the device runs nothing, in %.

Layer: device. Moves ``rank_ms``. Busy is the union of the device's
intervals over the profiled evaluations (``trace.summarise``); the wall is
as many evaluations at the window's unprofiled mean (``rank_ms``), from
the same run.
"""

NAME = "device_idle_share.rank"
UNIT = "%"
LAYER = "device"
MOVES = "rank_ms"


def read(record, summary):
    n = record.get("profiled_evaluations")
    if summary is None or not n:
        return None
    wall = record["window_s"] / record["evaluations"] * n
    return (1.0 - summary.busy_s / wall) * 100.0
