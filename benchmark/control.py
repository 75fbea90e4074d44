"""Readings of the program, of the control and of planted faults that set
each cell's limits (``limits/<cell>.json``), on the card.

    python3 -m benchmark.control --workload <cell> --program-seeds 1 2 ... \
        --control-seeds 7 8 9 --fault-seeds 4 5 6 [--window 2]

A program seed is one run of the cell as ``benchmark.run`` makes it
(``harness.run_cell``: set-up, a short window of ``--window`` seconds at
the cell's own load, the check), so the readings that set a limit come
from the path whose readings are held to it.  A fault seed is the same run
with a fault planted underneath the harness, in the program's entry points
(``planted``): half of each scan's views left out, so that the fusion
takes its mean over the rest; for serving also a detection altered where
it is produced; with several ranks also the gradient exchange left out.
The control is the reference in the program's place at the precision
below the configured one (bf16 -> float8 e4m3: the casting layers' inputs
and weights rounded through it), judged by the mode's own ``judge`` on the
float32 reference exactly as the program's outputs are.  Prints one JSON
line a seed and side."""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import sys
import time

import numpy as np
import torch

from . import check, harness
from .reference import model as refmodel
from .reference.decode import decode


def _quant(cfg):
    if cfg["model"]["compute_dtype"] != "bfloat16":
        raise ValueError("the control is defined for bf16 configurations")
    return refmodel.fp8_round


def half_views(scan):
    """The scan with the first half of its views (every view key halved)."""
    n = len(scan["imgs"]) // 2
    return dict(scan, **{k: scan[k][:n] for k in ("imgs", "proj_img", "proj_feat4")})


@contextlib.contextmanager
def planted(fault):
    """Within the block, the program's entry points carry ``fault``:
      half        ``infer.detect`` and the train step see half of each
                  scan's views
      altered     ``infer.detect`` moves its first box's x by 5 cm (or
                  answers a box where it found none)
      noexchange  the gradient all-reduce of ``parallel`` does nothing
                  (every other collective runs)
      unchanged   the train step returns the model's state as it found it
    None plants nothing."""
    from sgcdet_tpu_torch import infer, parallel, train

    saved = [(infer, "detect", infer.detect), (train, "make_train_step", train.make_train_step),
             (parallel, "all_reduce_sum_", parallel.all_reduce_sum_)]
    detect, make, reduce_ = (x[2] for x in saved)

    def detect_fault(model, scan):
        if fault == "half":
            return detect(model, half_views(scan))
        boxes, scores, labels = detect(model, scan)
        if not len(boxes):
            return np.ones((1, 6), np.float32), np.ones(1, np.float32), np.zeros(1, np.int64)
        boxes = np.array(boxes)
        boxes[0, 0] += 0.05
        return boxes, scores, labels

    def make_fault(model, config, optimizer, group=None):
        step = make(model, config, optimizer, group=group)

        def broken(scene, generator):
            if fault == "half":
                return step(half_views(scene), generator)
            saved_state = {k: v.clone() for k, v in model.state_dict().items()}
            out = step(scene, generator)
            model.load_state_dict(saved_state)
            return out
        return broken

    def reduce_fault(t, group, kind):
        return t if kind == "gradients" else reduce_(t, group, kind)

    if fault in ("half", "altered"):
        infer.detect = detect_fault
    if fault in ("half", "unchanged"):
        train.make_train_step = make_fault
    if fault == "noexchange":
        parallel.all_reduce_sum_ = reduce_fault
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def planted_rank(fault, *args):
    """A spawned rank of a data-parallel run with ``fault`` planted."""
    with planted(fault):
        harness.rank_entry(*args)


def program_run(cell, seed, dev, fault=None, seconds=2.0):
    """One run of the cell with ``fault`` planted (None: the program as it
    is): its result line and standard-error lines."""
    entry = functools.partial(planted_rank, fault) if fault else None
    with planted(fault):
        return harness.run_cell(cell, seed, seconds, False, dev, time.perf_counter(), entry)


def control_readings(cell, seed, dev, group=None):
    """The control's readings of one seed: the reference at the lower
    precision in the program's place, on the run's pool and weights (this
    rank's pool and the worst over the ranks with a ``group``)."""
    cfg = cell.config
    rank = 0 if group is None else torch.distributed.get_rank(group)
    scans = harness.pool_of(cell, seed, dev, rank)
    low = harness.reference_model(cell, seed, dev, quant=_quant(cfg))
    mode = cell.mode
    if cell.mix["mode"] == "serve":
        samples = []
        with torch.inference_mode():
            for j, scan in enumerate(scans):
                out = low(*check.scan_inputs(scan, dev), tuple(cfg["data"]["img_shape"]))
                head = [tuple(t.cpu() for t in s) for s in out["head_outs"]]
                dets = decode([tuple(t.numpy() for t in s) for s in head],
                              out["valid"].cpu().numpy(), scan["origin"],
                              cfg["model"]["voxel_size_list"][-1], cfg["model"]["test_cfg"])
                samples.append(mode.sample(j, out, dets))
        del low
        read = mode.judge(harness.reference_model(cell, seed, dev), cell, samples, scans)
        read["boxes"] = [len(d[0]) for _, _, d in samples]
        return read
    n = check.CHECK_STEPS
    start = {k: v.detach().cpu().clone() for k, v in low.state_dict().items()}
    drop = harness.seeds(seed)["dropout"]
    steps, first, after = check.train_reference(low, cfg, scans[:n], [None] * n, drop,
                                                group=group)
    record = dict(losses=steps, picks=[s["picks"] for s in steps], first_grads=first,
                  after=after)
    del low
    torch.cuda.empty_cache()
    read, _ = mode.judge(harness.reference_model(cell, seed, dev), cell, scans[:n], record,
                         start, drop, group)
    ranks = harness.gather(read, group)
    return {k: max(r[k] for r in ranks) for k in read}


def _control_seeds(cell, seeds, dev, group=None):
    rank = 0 if group is None else torch.distributed.get_rank(group)
    for seed in seeds:
        t = time.perf_counter()
        read = control_readings(cell, seed, dev, group)
        if rank == 0:
            _emit(cell, "control", seed, t, read)
        torch.cuda.empty_cache()


def _control_rank(cell, seeds, dev_type, rank, world, store):
    """A spawned rank of a data-parallel cell's control readings (``cell``
    as ``harness.lean`` hands it)."""
    dev = torch.device("cuda", rank) if dev_type == "cuda" else torch.device("cpu")
    harness.init_group(dev, rank, world, store)
    try:
        _control_seeds(harness.with_mode(cell), seeds, dev, torch.distributed.group.WORLD)
    finally:
        torch.distributed.destroy_process_group()


def _emit(cell, side, seed, t, read, **extra):
    print(json.dumps(dict(workload=cell.name, side=side, seed=seed,
                          seconds=round(time.perf_counter() - t, 2), **extra,
                          **{k: (float(v) if not isinstance(v, list) else v)
                             for k, v in read.items()})), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--window", type=float, default=2.0,
                    help="seconds of each program and fault run's window")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"control: needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    world = cell.mix.get("ranks", 1)
    faults = ["half"] + (["altered"] if cell.mix["mode"] == "serve" else []) + (
        ["noexchange"] if world > 1 else [])
    runs = [("program", None, s) for s in args.program_seeds]
    runs += [(f, f, s) for f in faults for s in args.fault_seeds]
    for side, fault, seed in runs:
        t = time.perf_counter()
        line, _ = program_run(cell, seed, dev, fault, args.window)
        _emit(cell, side, seed, t, {k: c["value"] for k, c in line["checks"].items()},
              correct=line["correct"], attempted=line["attempted"])
        torch.cuda.empty_cache()
    if args.control_seeds:
        if world == 1:
            _control_seeds(cell, args.control_seeds, dev)
        else:
            harness.over_ranks(world, dev, _control_rank,
                               (harness.lean(cell), args.control_seeds, "cuda"),
                               lambda group: _control_seeds(cell, args.control_seeds, dev,
                                                            group))
    return 0


if __name__ == "__main__":
    sys.exit(main())
