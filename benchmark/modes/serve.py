"""The serving mode: one closed-loop client calls ``infer.detect`` on the
pool's scans in turn, each call handing up the scan's host arrays and
taking its detections back to the host, for the window's seconds and at
least once a scan.

Of each pool scan's requests in the window, one drawn from the seed is
kept (its head outputs and detections); once the window has closed and
the program is freed, ``judge`` holds them against the reference."""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchmark import check, harness


class Sampler:
    """Of each pool scan's requests, one drawn uniformly from the seed
    (reservoir sampling), whose outputs and detections the check reads."""

    def __init__(self, seed, n_pool):
        self.rng = np.random.RandomState((seed + 7) % 2 ** 32)
        self.seen = [0] * n_pool
        self.kept = {}

    def draw(self, j):
        self.seen[j] += 1
        return self.rng.randint(self.seen[j]) == 0

    def keep(self, j, out, dets):
        self.kept[j] = (j, out, dets)


def sample(j, out, dets):
    """A kept request as the check reads it: (pool index, the forward's
    head outputs, valid and occupancy scores on the host, detections)."""
    return (j, {"head_outs": [tuple(t.cpu() for t in sc) for sc in out["head_outs"]],
                "valid": out["valid"].cpu(), "occ_preds": out["occ_preds"].cpu()}, dets)


def judge(ref, cell, samples, scans, log=None):
    """The readings of ``samples`` (``sample``'s form) against ``ref``."""
    return check.serve_readings(ref, samples, scans, cell.config, log)


def run(cell, seed, seconds, trace_on, dev, t_start, rank_entry=None):
    from sgcdet_tpu_torch import infer
    from sgcdet_tpu_torch.models import SGCDet

    split = harness.Split(t_start)
    cfg, pcfg, scans, ref = harness.setup(cell, seed, dev)
    split("pool_budget_weights")
    model = SGCDet(pcfg.model, pcfg.data.img_shape, device=dev,
                   generator=torch.Generator().manual_seed(0))
    model.load_state_dict(ref.state_dict())
    del ref
    split("program_model")
    build_s = harness.load_library(dev)
    split("kernel_library")
    for scan in scans:  # every shape of the traffic, and the kernels' first launches
        infer.detect(model, scan)
    harness.sync(dev)
    split("warm_up")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    hooks, wraps = harness.wants(cell) if trace_on else ((), ())
    stages = harness.StageTimer(model, hooks) if hooks and dev.type == "cuda" else None
    host = {}
    capture, sampler = harness.Capture(model), Sampler(seed, len(scans))
    lat, failed, errors = [], 0, []
    with harness.host_timers(wraps, dev, host):
        t0 = time.perf_counter()
        i = 0
        while True:
            j = i % len(scans)
            keep = sampler.draw(j)
            capture.armed = keep
            t = time.perf_counter()
            try:
                dets = infer.detect(model, scans[j])
            except Exception as err:  # a request that fails is counted, not fatal
                failed, dets = failed + 1, None
                errors.append(repr(err))
            t1 = time.perf_counter()
            lat.append(t1 - t)
            if keep and dets is not None and capture.last is not None:
                sampler.keep(j, capture.last, dets)
            capture.armed, capture.last = False, None
            i += 1
            if t1 - t0 >= seconds and i >= len(scans):  # every scan served once
                break
        window_s = t1 - t0
    capture.close()
    peak = harness.peak(dev)
    trace = dict(window=dict(calls=i - failed, seconds=window_s, ranks=1),
                 stage_ms=stages.close() if stages else {}, host_ms=host, profile=None)
    if trace_on:
        trace["profile"] = harness.profiled(
            [lambda s=s: infer.detect(model, s) for s in scans][:cell.mix["profile"]], dev)
    samples = [sample(*kept) for kept in sampler.kept.values()]
    del model, capture
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = harness.reference_model(cell, seed, dev)
    log, counter = harness.counted(trace_on, harness.compute_dtype(cfg), backward=False)
    t_ref = time.perf_counter()
    with counter or contextlib.nullcontext():
        readings = judge(ref, cell, samples, scans, log)
    trace["work"] = harness.work(log, counter, len(samples))
    info = dict(scenes=i, views=cell.mix["views"], samples=len(samples), setup=split.parts,
                boxes=[len(d[0]) for _, _, d in samples],
                budget=pcfg.model.visibility_budget, build_s=build_s,
                reference_s=time.perf_counter() - t_ref, errors=errors[:3],
                slowest_s=sorted(lat)[-3:])
    n_ok = i - failed
    e2e = dict(serve_scenes_per_s=n_ok / window_s,
               serve_p95_s=float(np.percentile(lat, 95)) if lat else float("nan"),
               peak_mem_gib=peak / 2 ** 30, setup_s=setup_s)
    complete = len(samples) == len(scans)
    return dict(attempted=i, failed=failed, e2e=e2e, trace=trace, readings=readings,
                complete=complete, peak=peak, info=info)
