"""One run of one cell: what every mode of driving the program shares
(the cell's files, the seeded pool and weights, the spans and the traced
sub-window, the data-parallel launch) and the result line.

A cell (an entry of ``workloads`` in BENCHMARK.json) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<mix>.json``, read
by ``traffic.py``); the mix names the mode that drives the program
(``modes/<mode>.py``, whose ``run`` makes the run); the cell's limits are
``limits/<cell>.json`` and its per-layer metrics' readers
``metrics/<metric>.py``.  Nothing here names a cell or a mode.

The program is ``sgcdet_tpu_torch``: the modes build its model with its own
config and entry points (``models.SGCDet``, ``infer.detect``,
``train.init_train_state``, ``train.make_train_step``), load the seeded
weights into it, and read its spans from hooks on the model's children."""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from . import profiling, traffic
from .reference import model as refmodel
from .weights import fill
from .work import WorkLog

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    limits: dict
    end_to_end: list
    per_layer: list
    readers: dict
    mode: object  # the module modes/<mix's mode>.py


def _module(kind, name, root=ROOT):
    """The file ``<kind>/<name>.py`` under ``root`` as a module."""
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}",
                                                  Path(root) / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lean(cell: Cell) -> Cell:
    """The cell without its modules, as a spawned rank is handed it."""
    return dataclasses.replace(cell, readers={}, mode=None)


def with_mode(cell: Cell) -> Cell:
    """A ``lean`` cell with its mode again."""
    return dataclasses.replace(cell, mode=_module("modes", cell.mix["mode"]))


def load_cell(workload: str, root: Path = ROOT, bench_path: Path | None = None) -> Cell:
    """The cell ``workload`` of the benchmark file (``BENCHMARK.json`` beside
    ``root``), with its files under ``root``."""
    root = Path(root)
    bench = json.loads(Path(bench_path or root.parent / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the benchmark has {sorted(cells)}")
    w = cells[workload]
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    config = json.loads((root / "configs" / f"{w['config']}.json").read_text())
    limits = json.loads((root / "limits" / f"{workload}.json").read_text())
    mix = traffic.load(w["traffic"], root)
    return Cell(workload, config, mix, w["chips"], limits, e2e, layer,
                {m["name"]: _module("metrics", m["name"], root) for m in layer},
                _module("modes", mix["mode"], root))


def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


def program_config(cfg: dict):
    """The program's config of a configuration file: its ``program_config``
    entry of ``sgcdet_tpu_torch.configs`` with every field the file gives
    (a field the program does not have raises)."""
    from sgcdet_tpu_torch import configs

    def merge(dc, values, where):
        kw = {}
        for key, val in values.items():
            if not hasattr(dc, key):
                raise KeyError(f"the program's config has no field {where}{key}")
            cur = getattr(dc, key)
            kw[key] = (merge(cur, val, f"{where}{key}.") if dataclasses.is_dataclass(cur)
                       else _tuples(val))
        return dataclasses.replace(dc, **kw)

    base = configs.get_config(cfg["program_config"])
    return merge(base, {k: cfg[k] for k in ("model", "data", "train")}, "")


def seeds(seed: int) -> dict:
    """The run's seeds of each kind, from ``--seed``."""
    rng = np.random.RandomState(seed % 2 ** 32)
    top = int(seed) % 2 ** 62
    return dict(weights=top, images=top ^ 0x5DEECE66D, dropout=int(rng.randint(1, 2 ** 31)))


def reference_model(cell: Cell, seed: int, dev, quant=None):
    """The reference at float32 on ``dev`` with the run's weights (the
    classification bias at the mix's ``cls_prior``)."""
    with torch.device("meta"):
        ref = refmodel.SGCDet(cell.config["model"])
    ref = ref.to_empty(device=dev)
    prior, w = cell.mix["cls_prior"], cell.config["weights"]
    fill(ref, seeds(seed)["weights"], -math.log((1 - prior) / prior), w["seed"], w["jitter"])
    refmodel.set_quant(ref, quant)
    return ref


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak(dev):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


class Split:
    """Seconds of set-up's parts, from process start (``parts``)."""

    def __init__(self, t_start):
        self.last = t_start
        self.parts = {"start_imports": time.perf_counter() - t_start}
        self.last = time.perf_counter()

    def __call__(self, name):
        now = time.perf_counter()
        self.parts[name] = round(now - self.last, 3)
        self.last = now


class Capture:
    """Keeps the outputs of the program's model's forward while armed."""

    def __init__(self, model):
        self.armed, self.last = False, None
        self.handle = model.register_forward_hook(self._hook)

    def _hook(self, _module, _args, out):
        if self.armed:
            self.last = out

    def close(self):
        self.handle.remove()


class StageTimer:
    """CUDA events around the forwards of the model's children ``names``."""

    def __init__(self, model, names):
        self.events = {n: [] for n in names}
        self.handles = []
        for n in names:
            mod = getattr(model, n)
            self.handles.append(mod.register_forward_pre_hook(self._pre(n)))
            self.handles.append(mod.register_forward_hook(self._post(n)))

    def _pre(self, n):
        def hook(*_):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            self.events[n].append(ev)
        return hook

    def _post(self, n):
        def hook(*_):
            self.events[n][-1][1].record()
        return hook

    def close(self):
        for h in self.handles:
            h.remove()
        return {n: [a.elapsed_time(b) for a, b in ev] for n, ev in self.events.items()}


@contextlib.contextmanager
def host_timers(names, dev, into):
    """Replace each ``module:function`` by a wrapper that synchronizes the
    card and then times the call on the host clock (ms into ``into``)."""
    saved = []
    for full in names:
        mod_name, fn_name = full.split(":")
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, fn_name)
        times = into.setdefault(full, [])

        def timed(*a, _fn=fn, _times=times, **kw):
            sync(dev)
            t = time.perf_counter()
            out = _fn(*a, **kw)
            _times.append((time.perf_counter() - t) * 1e3)
            return out

        setattr(mod, fn_name, timed)
        saved.append((mod, fn_name, fn))
    try:
        yield
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


def profiled(calls, dev):
    """Run ``calls`` (functions) under torch.profiler; its reduction."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with record_function(profiling.WINDOW):
            for fn in calls:
                fn()
            sync(dev)
    red = profiling.reduce(prof)
    if red is not None:
        red["calls"] = len(calls)
    return red


def pool_of(cell, seed, dev, rank=0):
    """The run's pool of scans on rank ``rank`` (``traffic.pool``)."""
    cfg = cell.config
    return traffic.pool(cell.mix, seeds(seed)["images"] ^ (rank * 0x632BE5AB), cfg["data"],
                        cfg["model"]["n_classes"], dev)


def setup(cell, seed, dev, rank=0):
    """The pool (of this rank), the program's config with the pool's exact
    visibility budget, and the seeded reference whose weights both sides
    take."""
    from sgcdet_tpu_torch.visibility import derive_visibility_budgets

    cfg = cell.config
    scans = pool_of(cell, seed, dev, rank)
    pcfg = program_config(cfg)
    budget = derive_visibility_budgets([(s["origin"], s["proj_img"]) for s in scans],
                                       pcfg.data.img_shape, pcfg.model)
    budget = None if all(b >= 1.0 for b in budget) else budget
    pcfg = dataclasses.replace(pcfg, model=dataclasses.replace(pcfg.model,
                                                               visibility_budget=budget))
    return cfg, pcfg, scans, reference_model(cell, seed, dev)


def load_library(dev):
    if dev.type != "cuda":
        return None
    from sgcdet_tpu_torch.ops import LIBRARY

    LIBRARY.get()
    return LIBRARY.build_seconds


def wants(cell):
    hooks = sorted({h for r in cell.readers.values() for h in getattr(r, "HOOKS", ())})
    wraps = sorted({w for r in cell.readers.values() for w in getattr(r, "WRAPS", ())})
    return hooks, wraps


def counted(trace_on, compute, backward):
    """A work log and a FLOP counter for the reference when traced."""
    if not trace_on:
        return None, None
    from torch.utils.flop_counter import FlopCounterMode

    return WorkLog(compute, backward), FlopCounterMode(display=False)


def work(log, counter, calls):
    if log is None or not calls:
        return None
    flops = counter.get_total_flops() + sum(log.flops.values())
    return dict(ms={k: v / calls for k, v in log.ms.items()}, flops=flops / calls)


def compute_dtype(cfg):
    return torch.bfloat16 if cfg["model"]["compute_dtype"] == "bfloat16" else torch.float32


def gather(obj, group):
    """``obj`` of every rank of ``group`` (``[obj]`` without one)."""
    import torch.distributed as dist

    if group is None:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def init_group(dev, rank, world, store):
    """Join the run's process group: NCCL on the cards, gloo on the CPU, met
    through a file store."""
    import datetime

    import torch.distributed as dist

    kw = dict(store=dist.FileStore(store, world), rank=rank, world_size=world,
              timeout=datetime.timedelta(seconds=600))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev, **kw)
    else:
        dist.init_process_group("gloo", **kw)


def over_ranks(world, dev, entry, args, rank0):
    """Data parallel over ``world`` ranks, a card each: ranks 1.. spawned as
    ``entry(*args, rank, world, store)``, rank 0 this process, which runs
    ``rank0(group)`` and returns what it returns.  The ranks meet through a
    file store under TMPDIR; every spawned rank is waited for."""
    import multiprocessing
    import shutil
    import tempfile

    import torch.distributed as dist

    tmp = tempfile.mkdtemp(prefix="bench-dp-")
    store = str(Path(tmp) / "store")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=entry, args=(*args, r, world, store)) for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        init_group(dev, 0, world, store)
        try:
            return rank0(dist.group.WORLD)
        finally:
            dist.destroy_process_group()
    finally:
        for p in procs:
            p.join(timeout=600)
            if p.is_alive():
                p.terminate()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


def rank_entry(cell, seed, seconds, trace_on, dev_type, rank, world, store):
    """A spawned rank of a data-parallel run (card ``rank``): its mode's
    ``rank_run`` in the run's group."""
    import torch.distributed as dist

    dev = torch.device("cuda", rank) if dev_type == "cuda" else torch.device("cpu")
    init_group(dev, rank, world, store)
    try:
        with_mode(cell).mode.rank_run(cell, seed, seconds, trace_on, dev, time.perf_counter(),
                                      dist.group.WORLD)
    finally:
        dist.destroy_process_group()


def run_cell(cell: Cell, seed: int, seconds: float, trace_on: bool, dev, t_start: float,
             rank_entry=None):
    """One run; returns (result line dict, lines for standard error).
    ``rank_entry``: the entry of spawned ranks where the mode spawns any."""
    res = cell.mode.run(cell, seed, seconds, trace_on, dev, t_start, rank_entry)
    checks = {k: dict(value=float(res["readings"].get(k, float("inf"))), limit=float(v))
              for k, v in cell.limits.items()}
    correct = res["complete"] and all(c["value"] <= c["limit"] for c in checks.values())
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if trace_on:
        for name, reader in cell.readers.items():
            value = reader.read(res["trace"])
            if value is not None:
                metrics[name] = dict(value=float(value), unit=units[name])
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = dict(value=float(res["e2e"][m["name"]]), unit=m["unit"])
    device = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                  kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                  count=cell.chips, memory_peak_bytes=int(res["peak"]))
    line = dict(correct=bool(correct), attempted=int(res["attempted"]),
                failed=int(res["failed"]), metrics=metrics, device=device)
    prof = res["trace"].get("profile")
    if trace_on and prof:
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        line["breakdown"] = dict(device_ops=prof["device_ops"], idle_gaps=prof["idle_gaps"])
    line["checks"] = checks
    err = [f"info {json.dumps(res['info'], default=str)}",
           f"window: {res['trace']['window']}",
           f"readings (all): {json.dumps(res['readings'])}",
           f"outputs complete: {res['complete']}"]
    err += [f"check {k}: {c['value']:.6g} <= limit {c['limit']:.6g} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}" for k, c in checks.items()]
    return line, err
