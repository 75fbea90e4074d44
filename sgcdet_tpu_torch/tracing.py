"""Spans and counters inside the program, on the profiler's clock.

    with tracing.span("sgc.step.forward"):
        ...
    tracing.count("lift.slots", n * budget)

Both are on exactly while a torch profiler records
(``torch.profiler.profile``, ``cli train --profile_steps``, the
benchmark's traced sub-window); there is no other switch.  Off, ``span``
returns one shared no-op context after a single flag check, and ``count``
returns after the same check.

On, a span enters ``torch.profiler.record_function(name)``, so it lies on
the profiler's own timeline beside the device's work, and records its host
``perf_counter_ns`` at entry and exit, a pair of CUDA events on the current
stream of the current device (where CUDA is initialized), its parent span
and the sequence number of its root span (the spans of one call of a root,
a scene or a step, share it).  A counter adds an int, or a device tensor
whose elements are summed in ``summary`` (never synchronized on the hot
path; the tensor must not be written after it is counted).

Records stay in memory until ``reset``.  ``summary`` (the caller has
synchronized the card) resolves them: for each span name its calls and its
host, self host (less its child spans) and device ms summed over the
calls, and each counter's total.

The names, the metric or use that reads each, are listed in PERF.md §3.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass

import torch
from torch.autograd import profiler as _autograd_profiler


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


@dataclass
class SpanRecord:
    name: str
    parent: str | None
    root: int  # sequence number of the root span, 1 for the first
    t0_ns: int
    t1_ns: int = 0
    child_ns: int = 0
    events: tuple | None = None  # (start, end) CUDA events


class Recorder:
    """The spans and counters of one process (``RECORDER``); each thread
    nests its spans on its own stack."""

    def __init__(self):
        self._local = threading.local()
        self.reset()

    def reset(self):
        self.spans: list[SpanRecord] = []
        self.counters: dict[str, list] = {}
        self._roots = itertools.count(1)

    def stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def add(self, name, value):
        self.counters.setdefault(name, []).append(
            value.detach() if torch.is_tensor(value) else int(value))

    def summary(self) -> dict:
        """{"spans": {name: {calls, host_ms, self_host_ms, device_ms}},
        "counters": {name: total}}; ``device_ms`` is None where a span
        recorded no CUDA events."""
        spans = {}
        for r in self.spans:
            s = spans.setdefault(r.name, dict(calls=0, host_ms=0.0, self_host_ms=0.0,
                                              device_ms=None))
            s["calls"] += 1
            s["host_ms"] += (r.t1_ns - r.t0_ns) / 1e6
            s["self_host_ms"] += (r.t1_ns - r.t0_ns - r.child_ns) / 1e6
            if r.events is not None:
                s["device_ms"] = (s["device_ms"] or 0.0) + r.events[0].elapsed_time(r.events[1])
        counters = {}
        for name, values in self.counters.items():
            total = sum(v for v in values if not torch.is_tensor(v))
            tensors = [v.sum() for v in values if torch.is_tensor(v)]
            if tensors:
                total += int(torch.stack([t.to(tensors[0].device) for t in tensors]).sum())
            counters[name] = total
        return dict(spans=spans, counters=counters)


RECORDER = Recorder()


class _Span:
    __slots__ = ("name", "rec", "ctx")

    def __init__(self, name, rec):
        self.name, self.rec, self.ctx = name, rec, None

    def __enter__(self):
        self.ctx = torch.profiler.record_function(self.name)
        self.ctx.__enter__()
        stack = self.rec.stack()
        parent = stack[-1] if stack else None
        events = None
        if torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        record = SpanRecord(self.name, parent and parent.name,
                            parent.root if parent else next(self.rec._roots),
                            time.perf_counter_ns(), events=events)
        stack.append(record)
        return None

    def __exit__(self, *exc):
        stack = self.rec.stack()
        record = stack.pop()
        record.t1_ns = time.perf_counter_ns()
        if record.events is not None:
            record.events[1].record()
        if stack:
            stack[-1].child_ns += record.t1_ns - record.t0_ns
        self.rec.spans.append(record)
        self.ctx.__exit__(*exc)
        return False


def span(name: str):
    """A context that records the span ``name`` while a profiler records,
    else the shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return NOOP
    return _Span(name, RECORDER)


def count(name: str, value) -> None:
    """Add ``value`` (an int, or a device tensor summed in ``summary``) to
    the counter ``name`` while a profiler records."""
    if _autograd_profiler._is_profiler_enabled:
        RECORDER.add(name, value)


def summary() -> dict:
    return RECORDER.summary()


def reset() -> None:
    RECORDER.reset()
