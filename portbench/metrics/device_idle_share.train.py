"""device_idle_share.train: the share of a chunk's wall in which the
device runs nothing, in %.

Layer: device. Moves ``train_examples_per_s``. Busy is the union of the
device's intervals in the profiled chunk (``trace.summarise``); the wall
is the mean boundary-to-boundary wall of the window's chunks, which ran
unprofiled in the same run (a profiled chunk's own wall carries the
profiler's cost on the host).
"""

NAME = "device_idle_share.train"
UNIT = "%"
LAYER = "device"
MOVES = "train_examples_per_s"


def read(record, summary):
    walls = record.get("boundary_walls")
    if summary is None or not walls:
        return None
    wall = sum(walls) / len(walls)
    return (1.0 - summary.busy_s / wall) * 100.0
