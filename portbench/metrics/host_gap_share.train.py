"""host_gap_share.train: the share of the training window outside the
chunks' intervals, in %.

Layer: trainer (``ChunkedLoop``, ``runtime/profiling.StepTimer``): what
happens between one chunk's host read and the next chunk's enqueue (the
commit of the loop state, the epoch lines). Moves
``train_examples_per_s``. The chunks' intervals are the walls that
``ChunkedLoop`` hands the epoch hook (its ``StepTimer``'s, each
synchronised on the device), the window the benchmark's clock from the
first chunk boundary to the last.
"""

NAME = "host_gap_share.train"
UNIT = "%"
LAYER = "trainer"
MOVES = "train_examples_per_s"


def read(record, summary):
    walls = record.get("chunk_walls")
    window = record.get("window_s")
    if not walls or not window:
        return None
    return (1.0 - sum(walls) / window) * 100.0
