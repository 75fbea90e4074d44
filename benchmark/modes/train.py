"""The training mode: ``make_train_step(model, config, optimizer)`` called
as ``step(scene, generator)`` back to back on the pool's scans; with
``ranks`` > 1 in the mix, data parallel over that many cards, one scene a
rank a step (this process rank 0, the others spawned).

Set-up builds the one step object that the window then drives, and runs
its first ``check.CHECK_STEPS`` steps (``check_steps``); once the window
has closed and the program is freed, ``judge`` has the reference follow
those steps from the same start.  The window's rate is
``train_scenes_per_s`` on one card and ``dp_train_scenes_per_s`` over
ranks."""
from __future__ import annotations

import contextlib
import time

import torch

from benchmark import check, harness


def inner_optimizer(optimizer):
    """The ``torch.optim.Optimizer`` that holds the program's AdamW state."""
    if isinstance(optimizer, torch.optim.Optimizer):
        return optimizer
    for v in vars(optimizer).values():
        if isinstance(v, torch.optim.Optimizer):
            return v
    raise TypeError("no torch optimizer inside the program's optimizer")


def first_grads(model, optimizer):
    """Each trained parameter's first clipped gradient, from AdamW's first
    moment after one step (exp_avg = (1 - beta1) g), on the host."""
    opt = inner_optimizer(optimizer)
    beta1 = opt.param_groups[0]["betas"][0]
    out = {}
    for name, p in model.named_parameters():
        st = opt.state.get(p)
        if st and "exp_avg" in st:
            out[name] = (st["exp_avg"].float() / (1 - beta1)).cpu()
    return out


def check_steps(model, optimizer, step, scans, gen, mcfg):
    """The set-up's first steps, through the window's own ``step``: what the
    check reads of them (each step's loss terms and occupancy picks, the
    first clipped gradients, the state after the steps)."""
    capture = harness.Capture(model)
    capture.armed = True
    record = dict(losses=[], picks=[])
    for s, scan in enumerate(scans):
        metrics = step(scan, gen)
        record["losses"].append({k: float(v) for k, v in metrics.items()
                                 if k.startswith("loss")})
        out = capture.last
        record["picks"].append(
            None if out is None else
            [p.cpu() for p in check.picks_of(out["occ_preds"].detach(),
                                             out["valid"].detach(), mcfg)])
        if s == 0:
            record["first_grads"] = first_grads(model, optimizer)
    record["after"] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    capture.close()
    return record


def complete(record):
    return all(p is not None for p in record["picks"]) and bool(record.get("first_grads"))


def judge(ref, cell, scans, record, start, drop_seed, group=None, log=None):
    """The readings of ``record`` (``check_steps``'s form) against ``ref``
    following the same steps from ``start`` with the record's picks, and
    the reference's own losses."""
    reference = check.train_reference(ref, cell.config, scans, record["picks"], drop_seed,
                                      log, group)
    return check.train_readings(record, reference, start), [s["loss"] for s in reference[0]]


def run(cell, seed, seconds, trace_on, dev, t_start, rank_entry=None):
    """The training window; data parallel when the mix has ``ranks`` > 1,
    its other ranks started as ``rank_entry`` (``harness.rank_entry`` when
    None)."""
    world = cell.mix.get("ranks", 1)
    if world == 1:
        return rank_run(cell, seed, seconds, trace_on, dev, t_start, None)
    lean = harness.lean(cell)
    return harness.over_ranks(
        world, dev, rank_entry or harness.rank_entry, (lean, seed, seconds, trace_on, dev.type),
        lambda group: rank_run(cell, seed, seconds, trace_on, dev, t_start, group))


def rank_run(cell, seed, seconds, trace_on, dev, t_start, group):
    """One rank's run (the only one where ``group`` is None); rank 0
    returns the run's result, the others None."""
    from sgcdet_tpu_torch.train import init_train_state, make_train_step

    import torch.distributed as dist

    rank = 0 if group is None else dist.get_rank(group)
    world = 1 if group is None else dist.get_world_size(group)
    split = harness.Split(t_start)
    cfg, pcfg, scans, ref = harness.setup(cell, seed, dev, rank)
    state = ref.state_dict()
    start = {k: v.detach().cpu().clone() for k, v in state.items()}
    split("pool_budget_weights")
    model, optimizer = init_train_state(pcfg, torch.Generator().manual_seed(0), dev)
    model.load_state_dict(state)
    del ref, state
    split("program_model")
    build_s = harness.load_library(dev)
    split("kernel_library")
    step = make_train_step(model, pcfg, optimizer, group=group)
    drop_seed = harness.seeds(seed)["dropout"]
    gen = torch.Generator(device=dev).manual_seed(drop_seed)
    n_check = check.CHECK_STEPS
    record = check_steps(model, optimizer, step, scans[:n_check], gen, cfg["model"])
    harness.sync(dev)
    split("check_steps")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    t0 = time.perf_counter()
    steps, prev = 0, None
    while True:
        step(scans[(n_check + steps) % len(scans)], gen)
        steps += 1
        if group is None:
            if time.perf_counter() - t0 >= seconds:
                break
            continue
        # the ranks stop at the same step: the latest flag that the card has
        # reduced (the one of the step before), so the host runs a step ahead
        flag = torch.tensor([float(time.perf_counter() - t0 >= seconds)], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        if prev is not None and prev.item() > 0:
            break
        prev = flag
    harness.sync(dev)
    window_s = time.perf_counter() - t0
    peak = harness.peak(dev)
    prof = None
    if trace_on:
        prof = harness.profiled([lambda s=s: step(s, gen) for s in scans][:cell.mix["profile"]],
                                dev)
    del model, optimizer, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    done = complete(record)
    readings, work, ref_s, ref_losses = {}, None, None, None
    if done:
        ref = harness.reference_model(cell, seed, dev)
        log, counter = harness.counted(trace_on, harness.compute_dtype(cfg), backward=True)
        t_ref = time.perf_counter()
        with counter or contextlib.nullcontext():
            readings, ref_losses = judge(ref, cell, scans[:n_check], record, start, drop_seed,
                                         group, log)
        work = harness.work(log, counter, n_check)
        ref_s = time.perf_counter() - t_ref
    ranks = harness.gather(dict(readings=readings, complete=done, peak=peak, prof=prof), group)
    if rank != 0:
        return None
    readings = {k: max(r["readings"].get(k, float("inf")) for r in ranks) for k in readings}
    done = all(r["complete"] for r in ranks)
    peak = max(r["peak"] for r in ranks)
    if prof is not None and all(r["prof"] for r in ranks):
        prof = dict(prof, busy_s=sum(r["prof"]["busy_s"] for r in ranks) / world,
                    window_s=sum(r["prof"]["window_s"] for r in ranks) / world)
    trace = dict(window=dict(calls=steps * world, seconds=window_s, ranks=world),
                 stage_ms={}, host_ms={}, profile=prof, work=work)
    info = dict(steps=steps, ranks=world, views=cell.mix["views"], setup=split.parts,
                budget=pcfg.model.visibility_budget, build_s=build_s,
                losses=[r.get("loss") for r in record["losses"]], reference_s=ref_s,
                reference_losses=ref_losses)
    rate = "train_scenes_per_s" if world == 1 else "dp_train_scenes_per_s"
    e2e = {rate: steps * world / window_s, "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    return dict(attempted=steps * world, failed=0, e2e=e2e, trace=trace, readings=readings,
                complete=done, peak=peak, info=info)
