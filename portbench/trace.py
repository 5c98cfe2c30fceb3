"""The traced run's reading of ``torch.profiler``'s raw events.

:func:`device_ms_by_name` is a copy of ``chip_smoke.device_ms_by_name``
(``chip_smoke.py:3932-3945``): device time by kernel name, summed from the
profiler's raw kineto events, whose conversion to ``key_averages()`` took
tens of seconds on a chunk of CUDA graph replays. :func:`summarise`
extends it to what the benchmark reports: the *union* of the device's
busy intervals (a sum double-counts overlapping kernels), the longest idle
gaps with what the host was doing in each, and the top operations.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple, Tuple


def _events(prof, device: bool) -> list:
    """The device activities but user annotations (a range over kernels
    already counted), or the host's events."""
    from torch.autograd import DeviceType

    if device:
        return [e for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU]


def device_ms_by_name(prof, events=None) -> Dict[str, float]:
    """Device time by kernel name (ms), summed over the device activities
    but user annotations."""
    out: Dict[str, float] = {}
    for e in _events(prof, True) if events is None else events:
        out[e.name()] = out.get(e.name(), 0.0) + e.duration_ns() / 1e6
    return out


def busy_union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merged, sorted ``[start, end)`` intervals."""
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def gaps(merged: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The idle intervals between merged busy ones."""
    return [(a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]]


def _host_label(host: List[Tuple[int, int, str]], starts: List[int], t: int) -> str:
    """The innermost host operation running at ``t``: the latest-started
    of the host events (sorted by start) that covers it, looked for among
    the 5,000 that started last before it; else ``idle host``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 5000, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "idle host"


class Summary(NamedTuple):
    by_name_ms: Dict[str, float]
    busy_s: float
    device_ops: List[List]  # [name, seconds], most time first, at most 10
    idle_gaps: List[List]  # [host activity, seconds], summed by activity, at most 10


def summarise(prof) -> Summary:
    dev = _events(prof, True)
    by_name = device_ms_by_name(prof, dev)
    intervals = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in dev]
    merged = busy_union(intervals)
    busy_ns = sum(e - s for s, e in merged)
    host = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in _events(prof, False) if not e.name().startswith("ProfilerStep"))
    starts = [h[0] for h in host]
    by_host: Dict[str, float] = {}
    for s, e in gaps(merged):
        label = _host_label(host, starts, (s + e) // 2)
        by_host[label] = by_host.get(label, 0.0) + (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
    return Summary(by_name, busy_ns / 1e9, [[n, ms / 1e3] for n, ms in ops],
                   [[n, s] for n, s in idle])


def start():
    """``torch.profiler`` of the host and the device, started on an idle
    device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    return prof


def stop(prof) -> None:
    """Stop ``prof`` once the device has finished."""
    import torch

    torch.cuda.synchronize()
    prof.stop()
