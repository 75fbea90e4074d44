"""What the readers of the program's own spans and counters share
(``sgcdet_tpu_torch/tracing.py``: ``span``, ``count``, ``summary``).

These readers read the program's recorder, not the ``trace`` dict, of
which they take only the profiled sub-window's call count.  The recorder
fills only while a torch profiler records, which in a benchmark process
is exactly the profiled sub-window (``harness.profiled``) that
``trace["profile"]`` describes; in a data-parallel run it is rank 0's,
this process's.  A reader's number is a sum over that sub-window divided
by the calls of the root span (``sgc.detect`` a scene, ``sgc.step`` a
step).  Each returns None where the program has no recorder (a checkout
from before it), where the run was not profiled, where the root span's
calls differ from the sub-window's, or where the span or counter is
missing."""
from __future__ import annotations


def program_summary():
    """The program's ``tracing.summary()``, or None without the module."""
    try:
        from sgcdet_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.summary()


def _calls(trace, summary, root):
    """The sub-window's calls where the program's root span counts as many."""
    prof = trace.get("profile")
    if not prof or summary is None:
        return None
    calls = summary["spans"].get(root, {}).get("calls")
    return calls if calls and calls == prof["calls"] else None


def span_ms(trace, root, name, clock):
    """Ms a call of the span ``name`` (``clock``: "device_ms" or "host_ms")."""
    summary = program_summary()
    calls = _calls(trace, summary, root)
    value = summary["spans"].get(name, {}).get(clock) if calls else None
    return None if value is None else value / calls


def counter(trace, root, name):
    """The counter ``name`` a call."""
    summary = program_summary()
    calls = _calls(trace, summary, root)
    value = summary["counters"].get(name) if calls else None
    return None if value is None else value / calls


def counter_share(trace, root, part, whole):
    """Percent that the counter ``part`` is of the counter ``whole``."""
    summary = program_summary()
    if not _calls(trace, summary, root):
        return None
    num, den = summary["counters"].get(part), summary["counters"].get(whole)
    return None if num is None or not den else 100.0 * num / den
