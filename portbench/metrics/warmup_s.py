"""warmup_s: the warm-up epochs before the fit's CUDA graph captures, in
seconds.

Layer: trainer (``runtime/trainer.GraphProgram.capture``: one epoch on a
side stream under CUDA's sync-debug mode "error", which sizes the
kernels' scratch and makes the libraries' handles, rolled back before
the capture). Moves ``setup_s``. Read from the program's own spans
(``runtime/profiling.recorder()``): the ``graph.warmup`` spans of the
run's fit, each ending after one synchronise, summed. None where the
program keeps no such span.
"""

NAME = "warmup_s"
UNIT = "s"
LAYER = "trainer"
MOVES = "setup_s"
SPAN = "graph.warmup"


def recorder():
    """The program's span recorder, or None where it has none."""
    try:
        from qrec_tpu_torch.runtime import profiling
    except ImportError:
        return None
    make = getattr(profiling, "recorder", None)
    return make() if make is not None else None


def fit_spans(name):
    """The closed spans ``name`` of the program's latest fit, oldest first;
    empty where there is no recorder or no fit."""
    rec = recorder()
    fit = getattr(rec, "last_fit", None)
    if fit is None:
        return []
    return [s for s in list(rec.spans)
            if s.name == name and s.fit == fit and s.end_ns is not None]


def read(record, summary):
    spans = fit_spans(SPAN)
    return sum(s.end_ns - s.start_ns for s in spans) / 1e9 if spans else None
