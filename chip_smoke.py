#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sgcdet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device   — refuse to run without a CUDA card; print nvidia-smi's name and
              power limit.
2. build    — compile the kernels of sgcdet_tpu_torch/csrc with nvcc
              (sm_90a) from this checkout, print the build seconds.
3. kernels  — every kernel against its plain PyTorch version on the card, at
              the shapes of the ScanNet 40-view eval path: bf16 value with
              f32 depth, and f32; out-of-image, behind-camera and NaN
              coordinates; a valid_counts case whose counted-out rows must be
              exactly zero.  Prints each max abs error with its worst ratio to
              the per-element tolerance, and the warm time of kernel and
              plain version.
3b. backward — every backward kernel against its plain version (the VJP of
              the plain forward) on the card, at the train path's shapes:
              bf16 and f32 value with f32 depth; out-of-image, behind-camera,
              NaN and image-edge coordinates; counted cases whose counted-out
              rows must get exactly zero location and attention gradients.
              Prints each gradient's max abs error, its worst ratio to the
              per-element tolerance, and the warm time of kernel and plain
              version.
4. slice    — the ScanNet forward at compute_dtype=float32 with TF32 off, on
              the indoor 40-view scene, once through the kernels and once
              through the plain versions: identical `valid`, matching
              depth distributions and head outputs.
5. serving  — the default bf16 ScanNet config with the exact auto visibility
              budget: infer.detect on 3 scenes (the first warms up); finite
              detections, seconds per scene, peak memory, and the launch
              counts of the run (2 sweep, 3 stage-1, 3 stage-2 per scene).
6. train f32 — one train step (train.make_train_step) at compute_dtype=
              float32, TF32 off, ffn_dropout 0, depth loss on, on the indoor
              40-view train scene, through the kernels and through the plain
              versions from the same seeded weights: matching loss terms and
              matching gradients of every parameter, each within 2e-3 of its
              scale plus 4x how far a 1e-7 nudge of the images moves it
              through the plain versions (a third step).
7. train    — the train setting of bench.py (default bf16 config, exact auto
              budget, depth loss on, dropout 0.1): 4 steps, the first a
              warm-up; finite losses and gradient norms, every trainable
              parameter moved and every frozen one did not, seconds per step,
              peak memory, and the launch counts of each step (sweep fwd/bwd
              2/2, stage-1 fwd/bwd 3/3, stage-2 fwd/bwd 3/3).

Each phase prints its seconds.  The last three lines are the kernel report
(one JSON object; ``launches`` are the train run's), the card's name and
power limit, and the device record (one JSON object).  The script imports
torch and sgcdet_tpu_torch only.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

N_VIEWS = 40
SERVE_SCENES = 3

# TPU kernel each Hopper kernel replaces, and its source in this repo
KERNEL_INFO = {
    "sweep_fwd": ("sgcdet_tpu_torch/csrc/sweep_fwd.cu",
                  "sgcdet_tpu/ops/sweep_pallas.py:233"),
    "dfa3d_fwd_s1": ("sgcdet_tpu_torch/csrc/dfa3d_fwd.cu",
                     "sgcdet_tpu/ops/dfa3d_pallas.py:303"),
    "dfa3d_fwd_mh": ("sgcdet_tpu_torch/csrc/dfa3d_fwd.cu",
                     "sgcdet_tpu/ops/dfa3d_pallas2.py:267"),
    "sweep_bwd": ("sgcdet_tpu_torch/csrc/sweep_bwd.cu",
                  "sgcdet_tpu/ops/sweep_pallas.py:243"),
    "dfa3d_bwd_s1": ("sgcdet_tpu_torch/csrc/dfa3d_bwd.cu",
                     "sgcdet_tpu/ops/dfa3d_pallas.py:439"),
    "dfa3d_bwd_mh": ("sgcdet_tpu_torch/csrc/dfa3d_bwd.cu",
                     "sgcdet_tpu/ops/dfa3d_pallas2.py:318"),
}
# launches of each kernel per scene on the serving path
LAUNCHES_PER_SCENE = {"sweep_fwd": 2, "dfa3d_fwd_s1": 3, "dfa3d_fwd_mh": 3}
# ... and per step on the train path
LAUNCHES_PER_STEP = {"sweep_fwd": 2, "sweep_bwd": 2, "dfa3d_fwd_s1": 3,
                     "dfa3d_bwd_s1": 3, "dfa3d_fwd_mh": 3, "dfa3d_bwd_mh": 3}
TRAIN_STEPS = 4


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, iters=10):
    """Warm mean milliseconds of fn() on the card (CUDA events).

    A spin kernel (about 50 ms) holds the stream while the host enqueues
    every launch, so the events time the device work and not the host's
    launch overhead, which exceeds a short kernel's own time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tolerance(torch, ref, f32_rel=1e-4):
    """Per-element limit of |kernel - plain| and its description.

    Kernel and plain version both sum in f32, in different orders (the
    backward kernels' atomics in an order that changes from run to run), and
    round once to the output type.  bf16: one bf16 ulp of the element (at
    most 2^-7 of it) plus f32 summation noise, 1e-5 of the largest
    magnitude; f32: ``f32_rel`` of the largest magnitude (1e-4 for the
    forward outputs, 1e-5 for the gradients)."""
    r = ref.float().abs()
    peak = float(r.max())
    if ref.dtype == torch.bfloat16:
        noise = 1e-5 * peak
        return 2.0 ** -7 * r + noise, f"2^-7 |ref| + {noise:.2e}"
    return torch.full_like(r, f32_rel * peak), f"{f32_rel * peak:.3e}"


def compare_tensors(torch, name, got, want, f32_rel=1e-4):
    """Check one kernel output against its plain version; returns the max
    abs error."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: kernel {tuple(got.shape)} {got.dtype} vs plain "
          f"{tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    diff = (got.float() - want.float()).abs()
    tol, tol_desc = tolerance(torch, want, f32_rel)
    err = float(diff.max())
    worst = float((diff / tol.clamp_min(1e-30)).max())
    ok = bool((diff <= tol).all())
    log(f"[kernels] {name}: max_abs_err {err:.3e}, worst err/tol {worst:.3f} "
        f"(tol {tol_desc}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: kernel disagrees with plain version")
    return err


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain at main-path shapes
# ---------------------------------------------------------------------------


def _scene_and_cfg():
    from sgcdet_tpu_torch.configs import scannet
    from sgcdet_tpu_torch.scene import example_scene

    cfg = scannet()
    scene = example_scene(cfg.data.img_shape, cfg.data.pad_size, N_VIEWS,
                          trajectory="indoor")
    return cfg, scene


def _auto_budget(cfg, scene):
    from sgcdet_tpu_torch.visibility import derive_visibility_budgets

    return derive_visibility_budgets([(scene["origin"], scene["proj_img"])],
                                     cfg.data.img_shape, cfg.model)


def _sweep_cases(torch, dev, cfg, scene, gen):
    """Sweep inputs at the depth net's shapes: (40, 60, 80, 128) features,
    12 planes, sample coordinates of the indoor rig's first neighbour (with
    behind-camera planes), plus injected NaN / inf / far-off coordinates and
    samples on the image's edge rows and columns."""
    import numpy as np

    from sgcdet_tpu_torch.models.depth_net import _warp_grid, get_closest_frame_ids

    h, w, c = cfg.data.pad_size[0] // 4, cfg.data.pad_size[1] // 4, 128
    d0, d1, step = cfg.model.dbound
    depth_values = torch.from_numpy(
        np.arange(d0, d1, step, dtype=np.float32) + step / 2).to(dev)
    proj4 = torch.from_numpy(scene["proj_feat4"]).to(dev)
    nei = torch.from_numpy(get_closest_frame_ids(N_VIEWS, 2)[:, 0]).to(dev)
    xe, ye = _warp_grid(proj4[nei], proj4, depth_values, h, w)
    flat_x, flat_y = xe.view(-1), ye.view(-1)
    idx = torch.randint(0, flat_x.numel(), (128,), device=dev, generator=gen)
    flat_x[idx[:16]] = float("nan")
    flat_y[idx[16:32]] = float("inf")
    flat_x[idx[32:48]] = -float("inf")
    flat_x[idx[48:64]] = 1e9
    flat_x[idx[64:80]] = float(w - 1)  # last column: the x1 corners fall off
    flat_y[idx[80:96]] = float(h - 1)
    flat_x[idx[96:112]] = -0.5  # half a pixel left of the first column
    flat_y[idx[112:]] = -0.5
    n_out = int(((xe < -1) | (xe > w) | (ye < -1) | (ye > h) | ~torch.isfinite(xe)
                 | ~torch.isfinite(ye)).sum())
    log(f"[kernels] sweep coords: {n_out} of {xe.numel()} samples off-image, "
        f"behind-camera or non-finite")
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        src = torch.randn((N_VIEWS, h, w, c), device=dev, generator=gen).to(dt)
        ref = torch.randn((N_VIEWS, h, w, c), device=dev, generator=gen).to(dt)
        name = f"sweep {str(dt)[6:]} ({N_VIEWS},{h},{w},{c}) D={xe.shape[1]}"
        cases.append((name, src, ref, xe, ye))
    return cases


def _lifting_inputs(torch, dev, cfg, scene, level, budget, gen):
    """Stage-1 and stage-2 inputs of one pyramid level, compacted by the
    main path's own rule (visible queries first, counts = visible per
    camera)."""
    from sgcdet_tpu_torch.models.view_transformer import compact_queries, point_sampling
    from sgcdet_tpu_torch.voxel_grid import voxel_centers_zero_origin

    m = cfg.model
    nvox = m.n_voxels_list[level]
    ref_all = torch.from_numpy(voxel_centers_zero_origin(nvox, m.voxel_size_list[level]))
    k = ref_all.shape[0] if level == 0 else m.topk_list[level - 1]
    keep = torch.sort(torch.randperm(ref_all.shape[0], generator=torch.Generator()
                                     .manual_seed(level))[:k])[0]
    ref_cam, mask = point_sampling(
        ref_all[keep].to(dev), torch.from_numpy(scene["origin"]).to(dev),
        torch.from_numpy(scene["proj_img"]).to(dev), cfg.data.img_shape, m.dbound)
    compact = compact_queries(mask, budget)
    check(compact is not None, f"level {level}: the budget keeps every query")
    sel, counts = compact
    kb = sel.shape[1]
    ref_s = torch.gather(ref_cam, 1, sel[..., None].expand(-1, -1, 3))
    ds = 2 ** (2 - level) * 4
    h, w = cfg.data.img_shape[0] // ds, cfg.data.img_shape[1] // ds
    heads, pts, dsize = m.num_heads, m.num_points, m.depth_channels
    locs2 = ref_s[:, :, None, None, :] + torch.randn(
        (N_VIEWS, kb, heads, pts, 3), device=dev, generator=gen) * torch.tensor(
        [2.0 / w, 2.0 / h, 1.0 / dsize], device=dev)
    attn2 = torch.softmax(torch.randn((N_VIEWS, kb, heads, pts), device=dev,
                                      generator=gen), -1)
    depth = torch.softmax(torch.randn((N_VIEWS, h, w, dsize), device=dev,
                                      generator=gen), -1)
    value = torch.randn((N_VIEWS, h, w, m.embed_dims), device=dev, generator=gen)
    return dict(h=h, w=w, kb=kb, counts=counts, value=value, depth=depth,
                locs1=ref_s[:, :, None, None, :].contiguous(),
                attn1=torch.ones((N_VIEWS, kb, 1, 1), device=dev),
                locs2=locs2, attn2=attn2, heads=heads)


def phase_kernels(torch, dev, report):
    from sgcdet_tpu_torch.ops.dfa3d import dfa3d_attention_plain, dfa3d_fwd_cuda
    from sgcdet_tpu_torch.ops.sweep import sweep_fwd_cuda, sweep_fwd_plain

    cfg, scene = _scene_and_cfg()
    budget = _auto_budget(cfg, scene)
    log(f"[kernels] auto visibility budget per level: {[round(b, 4) for b in budget]}")
    gen = torch.Generator(device=dev).manual_seed(0)

    def compare(name, kernel_name, run_kernel, run_plain, extra=None):
        out_k = run_kernel()
        out_p = run_plain()
        torch.cuda.synchronize()
        err = compare_tensors(torch, name, out_k, out_p)
        if extra is not None:
            extra(out_k)
        rec = report[kernel_name]
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)

    def timing(name, kernel_name, run_kernel, run_plain):
        """Warm times; the report keeps the first (main-path) case."""
        ms_k = cuda_ms(torch, run_kernel)
        ms_p = cuda_ms(torch, run_plain, iters=3)
        log(f"[kernels] {name}: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms")
        if "ms" not in report[kernel_name]:
            report[kernel_name].update(ms=ms_k, plain_ms=ms_p)

    for name, src, ref, xe, ye in _sweep_cases(torch, dev, cfg, scene, gen):
        args = (src, ref, xe, ye)
        compare(name, "sweep_fwd", lambda: sweep_fwd_cuda(*args),
                lambda: sweep_fwd_plain(*args))
        timing(name, "sweep_fwd", lambda: sweep_fwd_cuda(*args),
               lambda: sweep_fwd_plain(*args))

    for level in range(3):
        x = _lifting_inputs(torch, dev, cfg, scene, level, budget[level], gen)
        shape = f"({N_VIEWS},{x['h']},{x['w']}) K'={x['kb']}"
        for vdt in (torch.bfloat16, torch.float32):
            value = x["value"].to(vdt)
            tag = "bf16/f32" if vdt == torch.bfloat16 else "f32/f32"
            counts = x["counts"]

            def zeros_past_count(out, counts=counts):
                q = torch.arange(out.shape[1], device=dev)
                past = q[None, :] >= counts[:, None]
                check(bool((out[past] == 0).all()),
                      "rows past valid_counts are not exactly zero")
                log(f"[kernels]   {int(past.sum())} counted-out rows exactly zero")

            s1 = (value, x["depth"], x["locs1"], x["attn1"], 1, counts)
            compare(f"stage1 {tag} {shape} counted", "dfa3d_fwd_s1",
                    lambda: dfa3d_fwd_cuda(*s1), lambda: dfa3d_attention_plain(*s1),
                    zeros_past_count)
            vp = torch.randn((N_VIEWS, x["h"], x["w"], value.shape[-1]),
                             device=dev, generator=gen).to(vdt)
            s2 = (vp, x["depth"], x["locs2"], x["attn2"], x["heads"], counts)
            compare(f"stage2 {tag} {shape} counted", "dfa3d_fwd_mh",
                    lambda: dfa3d_fwd_cuda(*s2), lambda: dfa3d_attention_plain(*s2),
                    zeros_past_count)
            if level == 2 and vdt == torch.bfloat16:
                locs_nan = x["locs2"].clone()
                locs_nan.view(-1)[::997] = float("nan")
                s2n = (vp, x["depth"], locs_nan, x["attn2"], x["heads"], None)
                compare(f"stage2 {tag} {shape} uncounted, NaN locs", "dfa3d_fwd_mh",
                        lambda: dfa3d_fwd_cuda(*s2n),
                        lambda: dfa3d_attention_plain(*s2n))
            if level == 2:
                timing(f"stage1 {tag} {shape}", "dfa3d_fwd_s1",
                       lambda: dfa3d_fwd_cuda(*s1), lambda: dfa3d_attention_plain(*s1))
                timing(f"stage2 {tag} {shape}", "dfa3d_fwd_mh",
                       lambda: dfa3d_fwd_cuda(*s2), lambda: dfa3d_attention_plain(*s2))


# ---------------------------------------------------------------------------
# phases 4 and 5: the whole slice
# ---------------------------------------------------------------------------


def phase_slice_f32(torch, dev):
    from sgcdet_tpu_torch.infer import forward_scene
    from sgcdet_tpu_torch.models import SGCDet
    from sgcdet_tpu_torch.ops import plain_ops

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, scene = _scene_and_cfg()
    mcfg = dataclasses.replace(cfg.model, compute_dtype="float32",
                               visibility_budget=_auto_budget(cfg, scene))
    model = SGCDet(mcfg, cfg.data.img_shape, device=dev,
                   generator=torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    out_k = forward_scene(model, scene)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with plain_ops():
        out_p = forward_scene(model, scene)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"[slice f32] forward through kernels {t1 - t0:.3f} s (cold), "
        f"through plain versions {t2 - t1:.3f} s")
    check(torch.equal(out_k["valid"], out_p["valid"]), "valid differs")
    log(f"[slice f32] valid identical ({int(out_k['valid'].sum())} voxels selected)")
    err = float((out_k["dpt_dist"] - out_p["dpt_dist"]).abs().max())
    tol = 1e-4
    log(f"[slice f32] dpt_dist max_abs_err {err:.3e} (tol {tol:.0e})")
    check(err <= tol, "dpt_dist differs")
    for lvl, (a, b) in enumerate(zip(out_k["head_outs"], out_p["head_outs"])):
        for name, x, y in zip(("centerness", "bbox", "cls"), a, b):
            check(bool(torch.isfinite(x).all()), f"non-finite {name} level {lvl}")
            scale = max(1e-3, float(y.abs().max()))
            err = float((x - y).abs().max())
            tol = 1e-3 * scale
            log(f"[slice f32] {name} level {lvl}: max_abs_err {err:.3e} "
                f"(tol {tol:.3e})")
            check(err <= tol, f"{name} level {lvl} differs")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def phase_serving(torch, dev, kernels):
    import numpy as np

    from sgcdet_tpu_torch.infer import detect
    from sgcdet_tpu_torch.models import SGCDet
    from sgcdet_tpu_torch.scene import example_scene

    cfg, _ = _scene_and_cfg()
    scenes = [example_scene(cfg.data.img_shape, cfg.data.pad_size, N_VIEWS,
                            rng=np.random.RandomState(i), trajectory="indoor")
              for i in range(SERVE_SCENES)]
    mcfg = dataclasses.replace(cfg.model, visibility_budget=_auto_budget(cfg, scenes[0]))
    log(f"[serving] config scannet, compute {mcfg.compute_dtype}, budget "
        f"{[round(b, 4) for b in mcfg.visibility_budget]}, {N_VIEWS} views")
    model = SGCDet(mcfg, cfg.data.img_shape, device=dev,
                   generator=torch.Generator().manual_seed(0))
    log(f"[serving] parameters: {sum(p.numel() for p in model.parameters())}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels.values():
        k.launches = 0
    times = []
    for i, scene in enumerate(scenes):
        t0 = time.perf_counter()
        boxes, scores, labels = detect(model, scene)
        times.append(time.perf_counter() - t0)
        check(np.isfinite(boxes).all() and np.isfinite(scores).all(),
              f"scene {i}: non-finite detections")
        log(f"[serving] scene {i}{' (warm-up)' if i == 0 else ''}: "
            f"{len(boxes)} boxes, {times[-1]:.4f} s")
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[serving] warm seconds per scene: {sum(times[1:]) / len(times[1:]):.4f}")
    log(f"[serving] peak memory allocated: {peak / 2**30:.3f} GiB")
    log(f"[serving] kernel launches over {SERVE_SCENES} scenes: {launches}")
    for name, per_scene in LAUNCHES_PER_SCENE.items():
        check(launches[name] == per_scene * SERVE_SCENES,
              f"{name}: {launches[name]} launches, expected "
              f"{per_scene * SERVE_SCENES}")
    return launches


# ---------------------------------------------------------------------------
# phase 3b: backward kernels vs plain at train-path shapes
# ---------------------------------------------------------------------------


def _edge_locs(locs, w, h):
    """A copy of normalized locations with some samples moved onto the
    image's first/last columns and rows and the depth range's ends."""
    locs = locs.clone()
    locs[:, 0::7, ..., 0] = 0.5 / w  # pixel x = 0: only the x1 corners
    locs[:, 1::7, ..., 0] = (w - 0.5) / w  # pixel x = w - 1
    locs[:, 2::7, ..., 1] = 0.0  # pixel y = -0.5: half the corners fall off
    locs[:, 3::7, ..., 1] = 1.0  # pixel y = h - 0.5
    locs[:, 4::7, ..., 2] = 0.0  # depth bin -0.5: lerp against an invalid bin
    locs[:, 5::7, ..., 2] = 1.0
    return locs


def phase_backward(torch, dev, report):
    from sgcdet_tpu_torch.ops.dfa3d import dfa3d_bwd_cuda, dfa3d_bwd_plain
    from sgcdet_tpu_torch.ops.sweep import sweep_bwd_cuda, sweep_bwd_plain

    cfg, scene = _scene_and_cfg()
    budget = _auto_budget(cfg, scene)
    gen = torch.Generator(device=dev).manual_seed(1)
    names = ("d_value", "d_dpt", "d_locs", "d_attn")

    def compare(name, kernel_name, run_kernel, run_plain, labels, extra=None):
        outs_k = run_kernel()
        outs_p = run_plain()
        torch.cuda.synchronize()
        err = 0.0
        for label, got, want in zip(labels, outs_k, outs_p):
            if want is None:
                check(got is None, f"{name} {label}: kernel returned a gradient "
                                   "the plain version did not")
                continue
            err = max(err, compare_tensors(torch, f"{name} {label}", got, want,
                                           f32_rel=1e-5))
        if extra is not None:
            extra(outs_k)
        rec = report[kernel_name]
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)

    def timing(name, kernel_name, run_kernel, run_plain):
        ms_k = cuda_ms(torch, run_kernel)
        ms_p = cuda_ms(torch, run_plain, iters=3)
        log(f"[kernels] {name}: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms")
        if "ms" not in report[kernel_name]:
            report[kernel_name].update(ms=ms_k, plain_ms=ms_p)

    for name, src, ref, xe, ye in _sweep_cases(torch, dev, cfg, scene, gen):
        g = torch.randn(xe.shape, device=dev, generator=gen)
        args = (src, ref, xe, ye, g)
        name = name.replace("sweep", "sweep bwd")
        compare(name, "sweep_bwd", lambda: sweep_bwd_cuda(*args),
                lambda: sweep_bwd_plain(*args), ("d_src", "d_ref"))
        timing(name, "sweep_bwd", lambda: sweep_bwd_cuda(*args),
               lambda: sweep_bwd_plain(*args))

    for level in range(3):
        x = _lifting_inputs(torch, dev, cfg, scene, level, budget[level], gen)
        shape = f"({N_VIEWS},{x['h']},{x['w']}) K'={x['kb']}"
        counts = x["counts"]

        def zero_sample_grads_past_count(outs, counts=counts):
            q = torch.arange(outs[2].shape[1], device=dev)
            past = q[None, :] >= counts[:, None]
            check(bool((outs[2][past] == 0).all()) and bool((outs[3][past] == 0).all()),
                  "d_locs / d_attn of rows past valid_counts are not exactly zero")
            log(f"[kernels]   {int(past.sum())} counted-out rows: d_locs, d_attn exactly zero")

        for vdt in (torch.bfloat16, torch.float32):
            tag = "bf16/f32" if vdt == torch.bfloat16 else "f32/f32"
            value = x["value"].to(vdt)
            g1 = torch.randn((N_VIEWS, x["kb"], value.shape[-1]), device=dev,
                             generator=gen).to(vdt)
            locs1 = _edge_locs(x["locs1"], x["w"], x["h"])
            s1 = (value, x["depth"], locs1, x["attn1"], g1, 1, counts)
            for sg in (True, False):
                compare(f"stage1 bwd {tag} {shape} counted, sample grads {sg}",
                        "dfa3d_bwd_s1",
                        lambda sg=sg: dfa3d_bwd_cuda(*s1, sample_grads=sg),
                        lambda sg=sg: dfa3d_bwd_plain(*s1, sample_grads=sg), names,
                        zero_sample_grads_past_count if sg else None)
            vp = torch.randn((N_VIEWS, x["h"], x["w"], value.shape[-1]),
                             device=dev, generator=gen).to(vdt)
            locs2 = _edge_locs(x["locs2"], x["w"], x["h"])
            s2 = (vp, x["depth"], locs2, x["attn2"], g1, x["heads"], counts)
            compare(f"stage2 bwd {tag} {shape} counted", "dfa3d_bwd_mh",
                    lambda: dfa3d_bwd_cuda(*s2), lambda: dfa3d_bwd_plain(*s2),
                    names, zero_sample_grads_past_count)
            if level == 2 and vdt == torch.bfloat16:
                locs_nan = locs2.clone()
                locs_nan.view(-1)[::997] = float("nan")
                s2n = (vp, x["depth"], locs_nan, x["attn2"], g1, x["heads"], None)
                compare(f"stage2 bwd {tag} {shape} uncounted, NaN locs",
                        "dfa3d_bwd_mh", lambda: dfa3d_bwd_cuda(*s2n),
                        lambda: dfa3d_bwd_plain(*s2n), names)
            if level == 2:
                # stage 1 as the model runs it: no location/attention grads
                timing(f"stage1 bwd {tag} {shape}", "dfa3d_bwd_s1",
                       lambda: dfa3d_bwd_cuda(*s1, sample_grads=False),
                       lambda: dfa3d_bwd_plain(*s1, sample_grads=False))
                timing(f"stage2 bwd {tag} {shape}", "dfa3d_bwd_mh",
                       lambda: dfa3d_bwd_cuda(*s2), lambda: dfa3d_bwd_plain(*s2))


# ---------------------------------------------------------------------------
# phases 6 and 7: the train step
# ---------------------------------------------------------------------------


def _train_setup(torch, dev, **model_kw):
    """bench.py's train setting (exact auto budget, depth loss on) on the
    indoor 40-view train scene, with ``model_kw`` overrides; the model's
    weights come from a seeded init."""
    from sgcdet_tpu_torch.scene import example_train_scene
    from sgcdet_tpu_torch.train import init_train_state, make_train_step

    cfg, scene = _scene_and_cfg()
    mcfg = dataclasses.replace(cfg.model, visibility_budget=_auto_budget(cfg, scene),
                               depth_loss=True, **model_kw)
    cfg = dataclasses.replace(cfg, model=mcfg)
    scene = example_train_scene(cfg.data.img_shape, cfg.data.pad_size, N_VIEWS,
                                mcfg.n_classes, mcfg.downsample_factor)
    model, optimizer = init_train_state(cfg, torch.Generator().manual_seed(0), dev)
    return cfg, scene, model, make_train_step(model, cfg, optimizer)


def phase_train_f32(torch, dev):
    import numpy as np

    from sgcdet_tpu_torch.ops import plain_ops
    from sgcdet_tpu_torch.train import param_label

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN's own f32 backward sums in a varying order; pin it, so the steps
    # differ only where the kernels sum in another order than the plain
    # versions
    torch.backends.cudnn.deterministic = True
    kw = dict(compute_dtype="float32", ffn_dropout=0.0)
    cfg, scene, model_k, step_k = _train_setup(torch, dev, **kw)
    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.perf_counter()
    m_k = step_k(scene, gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    log(f"[train f32] step through kernels {t1 - t0:.3f} s (cold)")
    # the plain versions twice: on the scene, and on its images moved by
    # 1e-7 relative noise (the size of the kernels' own rounding
    # differences), which measures how far rounding alone moves each
    # gradient in this state
    rng = np.random.RandomState(2)
    imgs = scene["imgs"]
    nudged = dict(scene, imgs=(imgs * (1 + 1e-7 * rng.randn(*imgs.shape))).astype(imgs.dtype))
    runs = []
    for sc in (scene, nudged):
        _, _, model_p, step_p = _train_setup(torch, dev, **kw)
        t1 = time.perf_counter()
        with plain_ops():
            metrics = step_p(sc, gen)
        torch.cuda.synchronize()
        log(f"[train f32] step through plain versions {time.perf_counter() - t1:.3f} s")
        runs.append((metrics, {n: p.grad for n, p in model_p.named_parameters()}))
        del model_p, step_p
    (m_p, grads_p), (_, grads_q) = runs
    # loss terms: the kernels and the plain versions sum in other orders
    for name in m_p:
        a, b = float(m_k[name]), float(m_p[name])
        tol = 1e-4 * max(abs(b), 1e-3)
        log(f"[train f32] {name}: kernels {a:.6f}, plain {b:.6f} (tol {tol:.1e})")
        check(abs(a - b) <= tol, f"train f32: {name} differs")
    # every parameter's gradient (after the clip, which scales both alike).
    # Each tensor is held to 2e-3 of its largest plain gradient (floored at
    # 1e-5 of the largest anywhere in the model) plus 4x the move of its
    # plain gradient under the 1e-7 nudge.  The second term covers the
    # train-mode BatchNorm nets (depth U-Nets, 3D neck), whose gradients in
    # this state are determined by rounding to about 1e-2 only.
    floor = 1e-5 * max(float(g.abs().max()) for g in grads_p.values())
    rows = []
    for name, p in model_k.named_parameters():
        want = grads_p[name]
        check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
              f"train f32: gradient of {name} missing or non-finite")
        scale = max(float(want.abs().max()), floor)
        spread = float((grads_q[name] - want).abs().max())
        tol = 2e-3 * scale + 4 * spread
        err = float((p.grad - want).abs().max())
        rows.append((err / tol, name, err, scale, spread, param_label(name)))
    rows.sort(reverse=True)
    log(f"[train f32] gradient scale floor {floor:.3e}; worst err/tol: "
        + "; ".join(f"{n} ({lbl}) {r:.3f}: err {e:.2e}, scale {m:.2e}, nudge {s:.2e}"
                    for r, n, e, m, s, lbl in rows[:5]))
    by_nudge = sum(e > 2e-3 * m for _, _, e, m, _, _ in rows)
    log(f"[train f32] {by_nudge} of {len(rows)} tensors differ by more than 2e-3 of "
        f"their scale; the largest nudge move is "
        f"{max(s / m for _, _, _, m, s, _ in rows):.3e} of its tensor's scale")
    bad = [n for r, n, *_ in rows if r > 1.0]
    check(not bad, f"train f32: gradients differ: {bad}")
    log(f"[train f32] all {len(rows)} parameter gradients match")
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = flags


def phase_train(torch, dev, kernels):
    from sgcdet_tpu_torch.train import param_label

    cfg, scene, model, step = _train_setup(torch, dev)
    log(f"[train] config scannet, compute {cfg.model.compute_dtype}, ffn_dropout "
        f"{cfg.model.ffn_dropout}, depth loss on, budget "
        f"{[round(b, 4) for b in cfg.model.visibility_budget]}, {N_VIEWS} views")
    before = {n: t.detach().clone() for n, t in model.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels.values():
        k.launches = 0
    times = []
    has_grad = dict.fromkeys(before, False)
    for i in range(TRAIN_STEPS):
        counts0 = {name: k.launches for name, k in kernels.items()}
        t0 = time.perf_counter()
        metrics = step(scene, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        for n, p in model.named_parameters():
            has_grad[n] = has_grad[n] or bool(p.grad.any())
        per_step = {name: k.launches - counts0[name] for name, k in kernels.items()}
        vals = {k: float(v) for k, v in metrics.items()}
        check(all(map(math.isfinite, vals.values())), f"step {i}: non-finite {vals}")
        log(f"[train] step {i}{' (warm-up)' if i == 0 else ''}: {times[-1]:.4f} s, "
            + ", ".join(f"{k} {v:.5f}" for k, v in vals.items()))
        check(per_step == LAUNCHES_PER_STEP,
              f"step {i}: launches {per_step}, expected {LAUNCHES_PER_STEP}")
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    after = model.state_dict()
    moved = {n: not torch.equal(before[n], after[n]) for n, _ in model.named_parameters()}
    frozen = [n for n in moved if param_label(n) == "frozen"]
    trainable = [n for n in moved if param_label(n) != "frozen"]
    # a tensor whose gradient stayed zero (FPN level 3, which nothing reads)
    # does not move in the JAX package either: weight decay alone is below
    # f32 rounding at these learning rates
    stuck = [n for n in trainable if has_grad[n] and not moved[n]]
    check(not stuck, f"trainable parameters with gradients that did not move: {stuck[:5]}")
    check(not any(moved[n] for n in frozen), "a frozen parameter moved")
    backbone_stats = [n for n in after if n.startswith("backbone.")
                      and n.endswith(("running_mean", "running_var"))]
    check(all(torch.equal(before[n], after[n]) for n in backbone_stats),
          "a frozen backbone BN's running statistics moved")
    log(f"[train] {sum(moved[n] for n in trainable)} of {len(trainable)} trainable "
        f"parameter tensors moved (every one with a nonzero gradient; zero "
        f"gradient: {[n for n in trainable if not has_grad[n]]}); "
        f"{len(frozen)} frozen ones and {len(backbone_stats)} frozen BN "
        f"statistics did not")
    log(f"[train] warm seconds per step: {sum(times[1:]) / len(times[1:]):.4f}")
    log(f"[train] peak memory allocated: {peak / 2**30:.3f} GiB")
    log(f"[train] kernel launches over {TRAIN_STEPS} steps: {launches}")
    return launches


def main() -> int:
    repo = Path(__file__).resolve().parent
    if not (repo / "sgcdet_tpu_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(sgcdet_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke run needs the GPU and never falls back to "
              "the CPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    from sgcdet_tpu_torch.ops import KERNELS, LIBRARY

    t0 = time.perf_counter()
    LIBRARY.get()
    build_s = time.perf_counter() - t0
    log(f"[build] kernels ready in {build_s:.2f} s (nvcc "
        f"{'not run: reused ' if LIBRARY.build_seconds is None else ''}"
        f"{'' if LIBRARY.build_seconds is None else f'{LIBRARY.build_seconds:.2f} s'})")
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", LIBRARY.log)]
    spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", LIBRARY.log))
    if regs:
        log(f"[build] ptxas: {len(regs)} kernel instances, at most {max(regs)} "
            f"registers per thread, {spills} bytes of spills")

    report = {name: {} for name in KERNELS}
    serving = {}

    def run_serving():
        serving.update(phase_serving(torch, dev, KERNELS))

    train = {}
    for name, fn in (("kernels", lambda: phase_kernels(torch, dev, report)),
                     ("backward", lambda: phase_backward(torch, dev, report)),
                     ("slice f32", lambda: phase_slice_f32(torch, dev)),
                     ("serving", run_serving),
                     ("train f32", lambda: phase_train_f32(torch, dev)),
                     ("train", lambda: train.update(phase_train(torch, dev, KERNELS)))):
        t0 = time.perf_counter()
        fn()
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        rec = report[name]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=train[name],
                            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                            plain_ms=rec["plain_ms"],
                            serving_launches=serving.get(name, 0)))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
