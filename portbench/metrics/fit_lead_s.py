"""fit_lead_s: the set-up inside ``Recommender.fit`` before its first
chunk, in seconds.

Layer: trainer (``models/base.py`` ``fit_phases``: the spec, the quick
evaluation's ranker; ``runtime/trainer.py``: the optimizer and its state,
``GraphProgram.capture`` with its warm-up epoch under sync-debug "error",
rolled back, then the capture). Moves ``setup_s``. The benchmark's clock
from the call of ``fit`` to the first chunk's boundary, less that chunk's
wall as the loop hands it to the epoch hook.
"""

NAME = "fit_lead_s"
UNIT = "s"
LAYER = "trainer"
MOVES = "setup_s"


def read(record, summary):
    lead = record.get("fit_lead_s")
    return lead if lead is not None and lead > 0 else None
