"""Step timing, spans and device marks (counterpart of the JAX package's
``runtime/profiling.py``, which has the first and the last of the
pieces below).

``StepTimer`` records per-epoch wall time and examples/s. On a CUDA device
it synchronises before it reads the clock on entry and on exit, so an
interval covers the device work launched inside it, not just its enqueue;
with ``sync=False`` (the lag-1 loop, whose read of the previous epoch's
loss lies inside the interval) it reads the clock alone.
A chunk of E epochs run as one dispatch (``with timer.chunk(E)``) is one
interval, kept in ``chunks``; each of its epochs gets the chunk's wall / E,
as the JAX package's chunked loops report them. ``with timer.capture()``
times a CUDA graph's build as a ``graph.build`` span; ``captures`` are the
seconds of those spans.

``recorder()`` is the process's :class:`Recorder`: named host spans on
``time.perf_counter_ns()``, each with its parent (the span open when it
started on that thread), the fit it belongs to (``begin_fit``) and a few
attributes, kept in memory in a bounded buffer; and the readings of the
device marks (:class:`DeviceMarks`) that the chunked loops take once a
chunk. Nothing is written to a file. While ``torch.profiler`` records, a
span also opens ``record_function("qrec.<name>")``, so the span lies in
the profiler's trace on the device trace's clock; otherwise it costs two
clock reads and an append.

``trace(log_dir)`` records what runs inside it with ``torch.profiler`` and
writes a Chrome/Perfetto trace file into ``log_dir`` (the JAX package's
``trace``, which writes a TensorBoard profile); the spans appear in it
under their ``qrec.`` names.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import threading
import time
from typing import Callable, Deque, Dict, Iterator, List, Optional

import torch
from torch.profiler import record_function

# the spans a recorder keeps, newest last; older ones are dropped and counted
SPAN_CAPACITY = 65536
# the mark readings it keeps (one a chunk)
READING_CAPACITY = 16384

_profiler_enabled = torch._C._autograd._profiler_enabled
_now_ns = time.perf_counter_ns


class Span:
    """One named interval of host time (``start_ns``, ``end_ns`` on
    ``time.perf_counter_ns()``; ``end_ns`` None while open), with its
    ``id``, its ``parent``'s id (None at the top), its ``fit`` (None
    outside any) and ``attrs``; ``attrs["error"]`` names the exception
    that ended it, if one did. A context manager: the recorder's
    :meth:`Recorder.span` makes it."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "fit", "attrs", "_rec", "_stack",
                 "_rf")

    def __init__(self, rec: "Recorder", name: str, attrs: Optional[Dict], stack: List["Span"]):
        self._rec = rec
        self._stack = stack
        self.name = name
        self.attrs = attrs
        self.end_ns = None
        self._rf = None

    @property
    def seconds(self) -> Optional[float]:
        return None if self.end_ns is None else (self.end_ns - self.start_ns) / 1e9

    def __enter__(self) -> "Span":
        rec, stack = self._rec, self._stack
        self.parent = stack[-1].id if stack else None
        self.id = rec._ids
        rec._ids += 1
        self.fit = rec.fit
        stack.append(self)
        rec.spans.append(self)
        if _profiler_enabled():
            self._rf = record_function("qrec." + self.name)
            self._rf.__enter__()
        self.start_ns = _now_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end_ns = _now_ns()
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
            self._rf = None
        if exc_type is not None:
            self.attrs = dict(self.attrs or (), error=exc_type.__name__)
        self._stack.pop()
        return False


class _Stacks(threading.local):
    """The open spans of each thread, innermost last."""

    def __init__(self):
        self.stack: List[Span] = []


class Recorder:
    """The spans and mark readings of one process (``recorder()``): the
    last ``capacity`` spans in ``spans``, in the order they started, and
    ``dropped``, the number pushed out; the last mark readings in
    ``readings``. A span opened directly inside an open span of the same
    name is folded into it (a method that calls its parent class's)."""

    def __init__(self, capacity: int = SPAN_CAPACITY, readings: int = READING_CAPACITY):
        self.spans: Deque[Span] = collections.deque(maxlen=capacity)
        self.readings: Deque[Dict] = collections.deque(maxlen=readings)
        # the fit running now (None outside any) and the fits begun
        self.fit: Optional[int] = None
        self._fits = 0
        # ids given, and ids given before the last clear
        self._ids = self._cleared = 0
        self._local = _Stacks()

    @property
    def dropped(self) -> int:
        return self._ids - self._cleared - len(self.spans)

    def span(self, name: str, **attrs):
        """A context manager that records a span ``name`` over its block."""
        stack = self._local.stack
        if stack and stack[-1].name == name:
            return contextlib.nullcontext(stack[-1])
        return Span(self, name, attrs or None, stack)

    def begin_fit(self) -> int:
        """A new fit's id, given to every span that starts from here to
        :meth:`end_fit`."""
        self._fits += 1
        self.fit = self._fits
        return self.fit

    def end_fit(self) -> None:
        self.fit = None

    @property
    def last_fit(self) -> Optional[int]:
        """The id of the latest fit begun, None before any."""
        return self._fits or None

    def reading(self, **values) -> None:
        """Keep one reading of a program's device marks (ms by phase, with
        the epoch and the epochs of its chunk), under the current fit."""
        self.readings.append(dict(values, fit=self.fit))

    def clear(self) -> None:
        """Forget the spans and readings kept so far."""
        self.spans.clear()
        self.readings.clear()
        self._cleared = self._ids


_RECORDER = Recorder()


def recorder() -> Recorder:
    """The process's span recorder."""
    return _RECORDER


def spanned(name: str) -> Callable:
    """Decorator: every call of the function is a span ``name``."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with _RECORDER.span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


class DeviceMarks:
    """Named points in a body of device work, read once the work is known
    to have run (:meth:`read`). On a CUDA device a mark is a timing event
    recorded on the current stream; inside a CUDA graph's capture it
    becomes one of the graph's event-record nodes (``external=True``), so
    every replay records it again and a read gives the last replay's
    times. Elsewhere the device is the host, and a mark reads its clock.
    Between :meth:`steps` and its end a loop marks one step
    (:func:`step_marks`)."""

    # (phase, first mark, last mark) of a reading
    PHASES = (("sampler_ms", "start", "sampled"), ("steps_ms", "sampled", "stepped"),
              ("eval_ms", "stepped", "evaluated"), ("step_ms", "step", "optimized"),
              ("forward_ms", "step", "forward"), ("backward_ms", "forward", "backward"),
              ("optimizer_ms", "backward", "optimized"))

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self._at: Dict[str, object] = {}

    def mark(self, name: str) -> None:
        if not self.cuda:
            self._at[name] = time.perf_counter_ns()
            return
        event = self._at.get(name)
        if event is None:
            event = self._at[name] = torch.cuda.Event(enable_timing=True, external=True)
        event.record()

    def ms(self, first: str, last: str) -> Optional[float]:
        """Milliseconds from mark ``first`` to mark ``last``; None where
        either was never made."""
        a, b = self._at.get(first), self._at.get(last)
        if a is None or b is None:
            return None
        return a.elapsed_time(b) if self.cuda else (b - a) / 1e6

    @contextlib.contextmanager
    def steps(self) -> Iterator[None]:
        """These marks are :func:`step_marks` over the block."""
        before = getattr(_STEPS, "marks", None)
        _STEPS.marks = self
        try:
            yield
        finally:
            _STEPS.marks = before

    def read(self) -> Dict[str, float]:
        """The phases between the marks that were made, in ms (a host
        read: only after the marked work is known to have run)."""
        out = {}
        for phase, first, last in self.PHASES:
            ms = self.ms(first, last)
            if ms is not None:
                out[phase] = ms
        return out


_STEPS = threading.local()


def step_marks() -> Optional[DeviceMarks]:
    """The marks that the loop running now puts around one step, or None."""
    return getattr(_STEPS, "marks", None)


class StepTimer:
    """Accumulates epoch wall-times and derived throughput."""

    def __init__(self, examples_per_epoch: int = 0, device=None, sync: bool = True):
        self.examples_per_epoch = examples_per_epoch
        self.device = torch.device(device) if device is not None else None
        self.sync = sync
        self.times: List[float] = []
        # (seconds, epochs) of every interval
        self.chunks: List[tuple] = []
        # the graph.build span of every capture
        self._builds: List[Span] = []
        self._t0: Optional[float] = None
        self._epochs = 1

    def _sync(self) -> None:
        if self.sync and self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is not None:
            # a failed interval ran no whole epoch
            self._epochs = 1
            return False
        self._sync()
        wall = time.perf_counter() - self._t0
        self.chunks.append((wall, self._epochs))
        self.times += [wall / self._epochs] * self._epochs
        self._epochs = 1
        return False

    def chunk(self, epochs: int) -> "StepTimer":
        """The next interval covers ``epochs`` epochs."""
        self._epochs = int(epochs)
        return self

    @contextlib.contextmanager
    def capture(self) -> Iterator[None]:
        """A CUDA graph's build (its warm-up included) as a ``graph.build``
        span, synchronised at both ends; one that fails is not among
        ``captures``."""
        with recorder().span("graph.build") as span:
            self._sync()
            yield
            self._sync()
        self._builds.append(span)

    @property
    def captures(self) -> List[float]:
        """Seconds of every capture (its ``graph.build`` span)."""
        return [s.seconds for s in self._builds]

    @property
    def last(self) -> float:
        return self.times[-1] if self.times else 0.0

    def steady_state(self, skip: int = 1) -> float:
        """Mean epoch time excluding the first ``skip`` (warm-up) epochs."""
        rest = self.times[skip:] or self.times
        return sum(rest) / len(rest) if rest else 0.0

    def summary(self) -> Dict[str, float]:
        t = self.steady_state()
        return {
            "epochs": len(self.times),
            "epoch_seconds": t,
            "examples_per_second": (
                self.examples_per_epoch / t if t > 0 else 0.0
            ),
        }


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator:
    """Profile the block: host activity, and the card's kernels when CUDA
    is available; on exit (also by an exception) write ``trace-<pid>-<ns>.json`` (Chrome trace
    format, opened by Perfetto or ``chrome://tracing``) into ``log_dir``.
    Yields the profiler; its ``trace_path`` names the file once written."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.trace_path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
        prof.export_chrome_trace(prof.trace_path)
