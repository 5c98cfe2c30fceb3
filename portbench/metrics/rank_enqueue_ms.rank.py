"""rank_enqueue_ms.rank: the host's time to enqueue one final evaluation,
in ms.

Layer: ranker (``Recommender.finalize``: the forward pass to the scoring
tables, its propagation's launches; ``ops/topk.CatalogRanker.topk_device``:
one K2 launch a block of users). Moves ``rank_ms``. Read from the
program's own spans: each ``ranker.enqueue`` span with the
``model.finalize`` span that ended last before it, their host ms summed;
the median over the run's evaluations. None where the program keeps no
such span.
"""

import statistics

from portbench import harness

NAME = "rank_enqueue_ms.rank"
UNIT = "ms"
LAYER = "ranker"
MOVES = "rank_ms"


def read(record, summary):
    rec = harness.metric_module("warmup_s").recorder()
    if rec is None:
        return None
    totals, finalize = [], None
    for s in list(rec.spans):
        if s.end_ns is None:
            continue
        if s.name == "model.finalize":
            finalize = s.end_ns - s.start_ns
        elif s.name == "ranker.enqueue" and finalize is not None:
            totals.append(finalize + s.end_ns - s.start_ns)
            finalize = None
    return statistics.median(totals) / 1e6 if totals else None
