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
4. slice    — the ScanNet forward at compute_dtype=float32 with TF32 off, on
              the indoor 40-view scene, once through the kernels and once
              through the plain versions: identical `valid`, matching
              depth distributions and head outputs.
5. serving  — the default bf16 ScanNet config with the exact auto visibility
              budget: infer.detect on 3 scenes (the first warms up); finite
              detections, seconds per scene, peak memory, and the launch
              counts of the run (2 sweep, 3 stage-1, 3 stage-2 per scene).

The last three lines are the kernel report (one JSON object), the card's
name and power limit, and the device record (one JSON object).  The script
imports torch and sgcdet_tpu_torch only.
"""
from __future__ import annotations

import dataclasses
import json
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
}
# launches of each kernel per scene on the serving path
LAUNCHES_PER_SCENE = {"sweep_fwd": 2, "dfa3d_fwd_s1": 3, "dfa3d_fwd_mh": 3}


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


def tolerance(torch, ref):
    """Per-element limit of |kernel - plain| and its description.

    Kernel and plain version both sum in f32, in different orders, and round
    once to the output type.  bf16: one bf16 ulp of the element (at most
    2^-7 of it) plus f32 summation noise, 1e-5 of the largest magnitude;
    f32: 1e-4 of the largest magnitude."""
    r = ref.float().abs()
    peak = float(r.max())
    if ref.dtype == torch.bfloat16:
        noise = 1e-5 * peak
        return 2.0 ** -7 * r + noise, f"2^-7 |ref| + {noise:.2e}"
    return torch.full_like(r, 1e-4 * peak), f"{1e-4 * peak:.3e}"


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
    behind-camera planes), plus injected NaN / inf / far-off coordinates."""
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
    idx = torch.randint(0, flat_x.numel(), (64,), device=dev, generator=gen)
    flat_x[idx[:16]] = float("nan")
    flat_y[idx[16:32]] = float("inf")
    flat_x[idx[32:48]] = -float("inf")
    flat_x[idx[48:]] = 1e9
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
        check(out_k.shape == out_p.shape and out_k.dtype == out_p.dtype,
              f"{name}: kernel {tuple(out_k.shape)} {out_k.dtype} vs plain "
              f"{tuple(out_p.shape)} {out_p.dtype}")
        check(bool(torch.isfinite(out_k).all()), f"{name}: non-finite kernel output")
        diff = (out_k.float() - out_p.float()).abs()
        tol, tol_desc = tolerance(torch, out_p)
        err = float(diff.max())
        worst = float((diff / tol.clamp_min(1e-30)).max())
        ok = bool((diff <= tol).all())
        log(f"[kernels] {name}: max_abs_err {err:.3e}, worst err/tol {worst:.3f} "
            f"(tol {tol_desc}) {'ok' if ok else 'FAIL'}")
        check(ok, f"{name}: kernel disagrees with plain version")
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
    phase_kernels(torch, dev, report)
    phase_slice_f32(torch, dev)
    launches = phase_serving(torch, dev, KERNELS)

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        rec = report[name]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launches[name],
                            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                            plain_ms=rec["plain_ms"]))
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
