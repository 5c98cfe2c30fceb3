"""Step timing and throughput (counterpart of the JAX package's
``runtime/profiling.py``).

``StepTimer`` records per-epoch wall time and examples/s. On a CUDA device
it synchronises before it reads the clock on entry and on exit, so an
interval covers the device work launched inside it, not just its enqueue;
with ``sync=False`` (the lag-1 loop, whose read of the previous epoch's
loss lies inside the interval) it reads the clock alone.
A chunk of E epochs run as one dispatch (``with timer.chunk(E)``) is one
interval, kept in ``chunks``; each of its epochs gets the chunk's wall / E,
as the JAX package's chunked loops report them. ``with timer.capture()``
times a CUDA graph's capture, kept in ``captures``.
``trace(log_dir)`` records what runs inside it with ``torch.profiler`` and
writes a Chrome/Perfetto trace file into ``log_dir`` (the JAX package's
``trace``, which writes a TensorBoard profile).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional

import torch


class StepTimer:
    """Accumulates epoch wall-times and derived throughput."""

    def __init__(self, examples_per_epoch: int = 0, device=None, sync: bool = True):
        self.examples_per_epoch = examples_per_epoch
        self.device = torch.device(device) if device is not None else None
        self.sync = sync
        self.times: List[float] = []
        # (seconds, epochs) of every interval
        self.chunks: List[tuple] = []
        # seconds of every CUDA graph capture
        self.captures: List[float] = []
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
        """Time a CUDA graph's capture (its warm-up included) into
        ``captures``; a capture that fails is not recorded."""
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.captures.append(time.perf_counter() - t0)

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
