"""Where the time of one serving forward, or of one train step, goes on a
CUDA card.

    python -m sgcdet_tpu_torch.profile_serving [--reps 3] [--sort-queries]
    python -m sgcdet_tpu_torch.profile_serving --train [--reps 3] [--sort-queries]

The serving configuration is chip_smoke.py's: ScanNet, bf16 compute, 40
views of the indoor scene, the exact auto visibility budget, random weights
from a seeded init.  Prints, after 3 warm-up forwards:

* seconds per scene of ``infer.detect`` and of the forward alone (host
  clock, mean of 10 calls, ``--reps`` times);
* device milliseconds of each top-level stage of ``SGCDet.forward`` (CUDA
  events recorded by forward hooks, mean of 4 forwards);
* torch.profiler's table of device time per op over 3 forwards, and the
  device's idle share over that window (union of the kernel intervals).

``--train`` takes chip_smoke.py's train setting instead (the same model and
scene with bench.py's synthetic ground truth, depth loss on, FFN dropout
0.1) and prints, after 2 warm-up steps:

* seconds per step of ``train.make_train_step`` (host clock, mean of 5
  steps, ``--reps`` times) and the peak memory allocated;
* the stream milliseconds of forward + losses, backward and optimizer
  (CUDA events between the three, mean of 4 steps; host gaps included);
* torch.profiler's table and idle share over 2 steps.

``--sort-queries`` runs either with ``ModelConfig.sort_queries`` (the
windowed DFA3D kernels).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .configs import scannet
from .infer import detect, forward_scene
from .models import SGCDet
from .scene import example_scene, example_train_scene
from .train import init_train_state, make_train_step
from .train.loop import scene_losses
from .visibility import derive_visibility_budgets

STAGES = ("backbone", "neck", "depth_head", "voxel_head", "neck_3d", "bbox_head")


def stage_ms(model, scene, iters=4):
    """Mean device ms of each top-level stage over ``iters`` forwards."""
    events, handles = {}, []
    for name in STAGES:
        mod = getattr(model, name)

        def pre(_m, _a, name=name):
            events.setdefault(name, []).append([torch.cuda.Event(enable_timing=True),
                                                torch.cuda.Event(enable_timing=True)])
            events[name][-1][0].record()

        def post(_m, _a, _o, name=name):
            events[name][-1][1].record()

        handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    try:
        for _ in range(iters):
            forward_scene(model, scene)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return {name: float(np.mean([a.elapsed_time(b) for a, b in events[name]]))
            for name in STAGES}


def idle_share(prof):
    """(span ms, busy ms, idle share) of the device over the profiled
    window, from the union of its kernel and copy intervals."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type.name == "CUDA")
    if not iv:
        return 0.0, 0.0, float("nan")
    busy, start, end = 0, iv[0][0], iv[0][1]
    for s, e in iv[1:]:
        if s > end:
            busy += end - start
            start, end = s, e
        else:
            end = max(end, e)
    busy += end - start
    span = max(e for _, e in iv) - iv[0][0]
    return span / 1e3, busy / 1e3, 1.0 - busy / span


def print_profile(prof, what):
    span, busy, idle = idle_share(prof)
    print(f"profiled window ({what}): span {span:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {idle:.4f}")
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=30,
                                    max_name_column_width=70))


def profile_train(dev, reps, sort_queries):
    from torch.profiler import ProfilerActivity, profile

    cfg = scannet()
    scene = example_train_scene(cfg.data.img_shape, cfg.data.pad_size, 40,
                                cfg.model.n_classes, cfg.model.downsample_factor)
    budget = derive_visibility_budgets([(scene["origin"], scene["proj_img"])],
                                       cfg.data.img_shape, cfg.model)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, visibility_budget=budget, depth_loss=True, sort_queries=sort_queries))
    model, optimizer = init_train_state(cfg, torch.Generator().manual_seed(0), dev)
    step = make_train_step(model, cfg, optimizer)
    gen = torch.Generator(device=dev).manual_seed(1)
    print(f"device: {torch.cuda.get_device_name(0)}; train; budget {budget}; "
          f"sort_queries {sort_queries}", flush=True)
    for _ in range(2):
        step(scene, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    for rep in range(reps):
        t = time.perf_counter()
        for _ in range(5):
            step(scene, gen)
        torch.cuda.synchronize()
        print(f"rep {rep}: train step {(time.perf_counter() - t) / 5:.5f} s/step",
              flush=True)
    print(f"peak memory allocated: {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")

    # the step's three parts, as make_train_step runs them
    phases = ("forward+losses", "backward", "optimizer")
    times = []
    for _ in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        losses, _ = scene_losses(model, cfg, scene, gen)
        total = sum(losses.values())
        ev[1].record()
        optimizer.zero_grad()
        total.backward()
        ev[2].record()
        optimizer.step()
        ev[3].record()
        times.append(ev)
    torch.cuda.synchronize()
    for i, name in enumerate(phases):
        ms = float(np.mean([ev[i].elapsed_time(ev[i + 1]) for ev in times]))
        print(f"phase {name}: {ms:.3f} ms")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step(scene, gen)
        torch.cuda.synchronize()
    print_profile(prof, "2 train steps")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--train", action="store_true",
                    help="profile the train step instead of the serving forward")
    ap.add_argument("--sort-queries", action="store_true",
                    help="with ModelConfig.sort_queries (the windowed DFA3D kernels)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: needs a CUDA device")
    dev = torch.device("cuda", 0)
    if args.train:
        profile_train(dev, args.reps, args.sort_queries)
        return
    cfg = scannet()
    scene = example_scene(cfg.data.img_shape, cfg.data.pad_size, 40, trajectory="indoor")
    budget = derive_visibility_budgets([(scene["origin"], scene["proj_img"])],
                                       cfg.data.img_shape, cfg.model)
    mcfg = dataclasses.replace(cfg.model, visibility_budget=budget,
                               sort_queries=args.sort_queries)
    model = SGCDet(mcfg, cfg.data.img_shape, device=dev,
                   generator=torch.Generator().manual_seed(0))
    print(f"device: {torch.cuda.get_device_name(0)}; budget {budget}; "
          f"sort_queries {args.sort_queries}", flush=True)
    for _ in range(3):
        forward_scene(model, scene)
    torch.cuda.synchronize()

    for rep in range(args.reps):
        t = time.perf_counter()
        for _ in range(10):
            detect(model, scene)
        t_detect = (time.perf_counter() - t) / 10
        t = time.perf_counter()
        for _ in range(10):
            forward_scene(model, scene)
        torch.cuda.synchronize()
        t_fwd = (time.perf_counter() - t) / 10
        print(f"rep {rep}: detect {t_detect:.5f} s/scene, forward {t_fwd:.5f} s/scene",
              flush=True)

    for name, ms in stage_ms(model, scene).items():
        print(f"stage {name}: {ms:.3f} ms")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            forward_scene(model, scene)
        torch.cuda.synchronize()
    print_profile(prof, "3 forwards")


if __name__ == "__main__":
    main()
