"""Reduction of a ``torch.profiler`` window to the traced run's numbers:
the device's busy time (the union of its kernel, copy and set intervals),
each kernel's device time, the top device operations and the longest idle
gaps named by what the host was doing meanwhile."""
from __future__ import annotations

from collections import defaultdict

import numpy as np

WINDOW = "bench.window"


def short(name: str) -> str:
    """A kernel's name without its return type, template and parameters."""
    name = name[5:] if name.startswith("void ") else name
    for i, ch in enumerate(name):
        if ch in "<(":
            return name[:i] or name[:120]
    return name[:120]


def _is_device(e):
    return e.device_type.name == "CUDA"


def _is_work(e):
    """A kernel, copy or set on the card; not a span (``record_function``,
    torch's optimizer and collective annotations) mirrored on its timeline."""
    return _is_device(e) and not getattr(e, "is_user_annotation", False) and e.name != WINDOW


def reduce(prof) -> dict:
    """{"window_s", "busy_s", "kernels": {name: seconds}, "device_ops":
    [[name, s]] (10), "idle_gaps": [[host activity, s]] (10)} of the span
    ``WINDOW`` of a profile, or None without it or without device time."""
    events = list(prof.events())
    span = [e for e in events if e.name == WINDOW and not _is_device(e)]
    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                 if _is_work(e))
    if not span or not dev:
        return None
    w0, w1 = span[0].time_range.start, span[0].time_range.end
    kernels = defaultdict(float)
    merged = []
    for s, e, name in dev:
        kernels[name] += (e - s) / 1e6
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(max(0.0, min(e, w1) - max(s, w0)) for s, e in merged)
    gaps, prev = [], w0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    host = [e for e in events if not _is_device(e) and e.name != WINDOW]
    starts = np.array([e.time_range.start for e in host], np.float64)
    ends = np.array([e.time_range.end for e in host], np.float64)
    idle = defaultdict(float)
    for s, e in gaps:
        mid = (s + e) / 2
        inside = np.flatnonzero((starts <= mid) & (ends >= mid))
        name = "host outside any torch op (Python, NumPy)"
        if inside.size:
            name = host[int(inside[np.argmin(ends[inside] - starts[inside])])].name
        idle[name] += (e - s) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    top = [(short(n), s) for n, s in top]
    return dict(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6, kernels=dict(kernels),
                device_ops=[[n, s] for n, s in top],
                idle_gaps=[[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:10]])
