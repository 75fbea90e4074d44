"""What the per-layer metrics' readers (``metrics/<name>.py``) share: each
takes the traced run's ``trace`` dict and returns a number, or None where
the run gave it nothing to read.

``trace`` holds:
  window    {"calls": scenes or steps, "seconds": its length, "ranks"}
  stage_ms  {child of the program's model: [device ms of each call]}
            (CUDA events from forward hooks, for the readers' ``HOOKS``)
  host_ms   {"module:function": [host ms of each call]} (the readers'
            ``WRAPS``; the card is synchronized before each call)
  profile   {"calls", "window_s", "busy_s", "kernels": {name: seconds}}
            of the profiled sub-window, or None
  work      {"ms": {"dfa3d": ..., "sweep": ...}, "flops": ...}: the least
            time of the kernels' work and the model FLOPs of one call,
            counted on the reference (``work.py``), or None
"""
from __future__ import annotations

import re

from .work import BF16_FLOPS_PER_S

# the port's kernels by name: the DFA3D forward and backward (K2, K3, K5,
# K6 and its list passes, the windowed ones) and the sweep's (K1, K4)
KERNELS = {
    "dfa3d": re.compile(r"dfa3d|s1_lists_kernel|s1_long_kernel|s1_pixels_kernel"
                        r"|s1_sample_grads_kernel"),
    "sweep": re.compile(r"sweep_(fwd|bwd)_kernel"),
}


def stage_ms(trace, names):
    """Mean device ms a call of the model's children ``names`` together."""
    runs = [trace["stage_ms"].get(n) for n in names]
    if not all(runs):
        return None
    return sum(sum(r) / len(r) for r in runs)


def host_ms(trace, name):
    runs = trace["host_ms"].get(name)
    return sum(runs) / len(runs) if runs else None


def roofline(trace, kind):
    """Percent of its bound that the device time of ``kind``'s kernels
    reaches over the profiled calls: the bound of one call's work (counted
    on the reference) times the calls, over the kernels' summed time."""
    prof, work = trace.get("profile"), trace.get("work")
    if not prof or not work or not work["ms"].get(kind):
        return None
    secs = sum(s for name, s in prof["kernels"].items() if KERNELS[kind].search(name))
    if secs <= 0:
        return None
    return 100.0 * work["ms"][kind] / 1e3 * prof["calls"] / secs


def kernel_ms(trace, pattern):
    """Device ms a call (rank 0's) of the kernels whose names match."""
    prof = trace.get("profile")
    if not prof:
        return None
    secs = sum(s for name, s in prof["kernels"].items() if re.search(pattern, name))
    return 1e3 * secs / prof["calls"] if secs > 0 else None


def mfu(trace):
    """Percent of the card's dense bf16 peak that the model FLOPs of the
    window's calls reach over the window's time, each rank its own card."""
    work, win = trace.get("work"), trace["window"]
    if not work or not work.get("flops") or not win["calls"]:
        return None
    per_card = work["flops"] * win["calls"] / win["ranks"]
    return 100.0 * per_card / (win["seconds"] * BF16_FLOPS_PER_S)


def idle_share(trace):
    prof = trace.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
