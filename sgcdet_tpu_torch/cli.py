"""Command-line entry of the port: train / eval / show for the four released
configs (sgcdet_tpu/cli.py, the reference's main.py:16-97 with its
Lightning Trainer wiring).

    python -m sgcdet_tpu_torch.cli --config scannet --mode train
    torchrun --nproc_per_node G -m sgcdet_tpu_torch.cli --config scannet

A run writes ``logs/<log_folder>/``: ``config.json``, ``metrics.jsonl``
(and TensorBoard events when ``torch.utils.tensorboard`` imports), a
checkpoint per epoch under ``ckpt/`` with a ``last`` pointer, the
``torch.profiler`` trace of ``--profile_steps`` under ``profile/``, the
show mode's dumps under ``show/`` and the sharded eval's detections under
``eval_gather/step_<n>/``.  Under torchrun each process trains one scene a
step on ``cuda:LOCAL_RANK`` (``parallel.from_env``) and evaluates its
``rank::world`` slice of the val set; rank 0 logs, saves and computes the
mAP.  Entry points run on the card unless ``--device cpu`` is given.

``main(argv)`` parses the flags and calls ``run(args, train_ds, val_ds)``,
which reads the datasets from ``config.data`` unless it is given them (any
object with ``MultiViewDataset``'s ``__len__``, ``__getitem__``,
``gt_anno`` and ``scene_poses``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="sgcdet_tpu_torch")
    p.add_argument("--config", required=True,
                   help="scannet | arkit | scannet200_large | arkit_large")
    p.add_argument("--mode", default="train", choices=["train", "eval", "show"])
    p.add_argument("--data_root", default=None)
    p.add_argument("--log_folder", default="default")
    p.add_argument("--ckpt_path", default=None, help="checkpoint file to eval")
    p.add_argument("--load_from", default=None,
                   help="warm start: a checkpoint file of this package, or a "
                        "released torch .ckpt/.pth")
    p.add_argument("--resume", action="store_true",
                   help="resume model, optimizer and step from the newest "
                        "checkpoint in this run's log folder")
    p.add_argument("--pretrained_backbone", default=None,
                   help="torchvision resnet50 .pth for ImageNet backbone init "
                        "(configs/SGCDet_ScanNet.py:76)")
    p.add_argument("--pretrained_matching", default=None,
                   help="torchvision resnet18 .pth for the matching extractor "
                        "(extractor_matching.py:56-66)")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--eval_every_epochs", type=int, default=1)
    p.add_argument("--profile_steps", type=int, default=0,
                   help="capture a torch.profiler trace for N steps")
    p.add_argument("--query_chunk", type=int, default=100,
                   help="accepted so that the JAX package's command lines run; "
                        "no effect here (it sized the JAX package's XLA DFA3D "
                        "walk; the kernels take every query at once)")
    p.add_argument("--n_views_test", type=int, default=None,
                   help="override eval view count (memory/speed knob)")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--visibility_budget", default=None,
                   help="per-camera lifting compaction: a float fraction of "
                        "queries kept per camera, or 'auto' to derive a "
                        "provably-exact bound from the dataset's geometry "
                        "(see visibility.py)")
    p.add_argument("--visibility_scan_scenes", type=int, default=200,
                   help="scenes sampled for --visibility_budget auto")
    p.add_argument("--override", action="append", default=[],
                   help="config override 'section.key=value' (repeatable; "
                        "values parsed as Python literals) — the analog of "
                        "the reference CLI's config merge (main.py:28-30)")
    p.add_argument("--sweep_band", default=None,
                   help="the JAX package's banded plane sweep; not ported, any "
                        "value raises ValueError")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; cuda:LOCAL_RANK under torchrun) or cpu; "
                        "without a card the default raises")
    return p.parse_args(argv)


class MetricLogger:
    """JSONL always; TensorBoard when torch.utils.tensorboard is importable."""

    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.jsonl = open(self.log_dir / "metrics.jsonl", "a")
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(str(self.log_dir / "tensorboard"))
        except Exception:
            pass

    def log(self, step, scalars, prefix=""):
        rec = {"step": int(step), **{prefix + k: float(v) for k, v in scalars.items()}}
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(prefix + k, float(v), int(step))

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


def build_dataset_and_loader(config, train, batch_size, num_workers, seed,
                             host_id=0, num_hosts=1, dataset=None):
    """The dataset of ``config.data`` (or ``dataset``) and its loader; rank
    ``host_id`` of ``num_hosts`` reads its slice of each epoch."""
    from .data import MultiViewDataset, SceneLoader

    ds = dataset if dataset is not None else MultiViewDataset(
        config.data, train=train,
        load_depth=config.model.depth_loss or config.model.use_gt_dpt,
        seed=seed,
    )
    loader = SceneLoader(
        ds,
        batch_size=batch_size,
        shuffle=train,
        repeat_times=config.data.repeat_times if train else 1,
        num_workers=num_workers,
        max_boxes=config.data.max_boxes,
        host_id=host_id,
        num_hosts=num_hosts,
        seed=seed,
        drop_last=train,
    )
    return ds, loader


def run_eval(config, model, dataset, logger=None, step=0, show_dir=None,
             num_workers=4, host_id=0, num_hosts=1, gather_dir=None,
             gather_timeout=3600):
    """Full-dataset inference + indoor mAP (pl_model.py:76-90).

    Scenes are decoded in a thread pool ahead of the model, and the host
    half of scene p (copy of its head outputs, decode, NMS, show) runs
    while scene p+1's forward is queued on the card.  With ``num_hosts`` >
    1, rank ``host_id`` evaluates scenes ``host_id::num_hosts`` and writes
    its detections to ``gather_dir``; rank 0 merges every shard in scene
    order and computes the metric, the others return None."""
    import concurrent.futures as cf

    from .eval import indoor_eval
    from .eval.gather import gather_detections
    from .geometry import DepthBoxes3D
    from .infer import forward_scene
    from .models.det_head import decode_bboxes

    if num_hosts > 1 and gather_dir is None:
        raise ValueError("multi-host eval needs a shared gather_dir")
    indices = list(range(host_id, len(dataset), num_hosts))
    model.eval()
    dt_annos, gt_annos = [], []
    yawed = config.model.head_type == "sunrgbd"

    # num_workers <= 0 means no prefetch parallelism; one worker keeps the
    # pool valid
    pool = cf.ThreadPoolExecutor(max_workers=max(1, num_workers))
    window = max(1, 2 * num_workers)
    futures = {p: pool.submit(dataset.__getitem__, indices[p])
               for p in range(min(window, len(indices)))}

    def finish(p, scene, out):
        head_outs = [tuple(t.cpu().numpy() for t in scale) for scale in out["head_outs"]]
        valid = out["valid"].cpu().numpy()
        boxes, scores, labels = decode_bboxes(
            head_outs, valid, np.asarray(scene["origin"]), config.model.voxel_size,
            config.model)
        det = DepthBoxes3D(
            boxes, box_dim=boxes.shape[-1] if len(boxes) else (7 if yawed else 6),
            with_yaw=yawed, origin=(0.5, 0.5, 0.5),
        )
        dt_annos.append(dict(boxes_3d=det, scores_3d=scores, labels_3d=labels))
        gt = dataset.gt_anno(scene["index"])
        gt_annos.append(gt)
        if show_dir is not None:
            from .utils import denormalize_images, draw_scene_2d, dump_show_results

            gt_boxes = DepthBoxes3D(
                gt["gt_boxes_upright_depth"],
                box_dim=gt["gt_boxes_upright_depth"].shape[-1] if gt["gt_num"] else 7,
                with_yaw=gt["gt_boxes_upright_depth"].shape[-1] == 7,
                origin=(0.5, 0.5, 0.5),
            ) if gt["gt_num"] else None
            i = indices[p]
            dump_show_results(show_dir, f"{i:05d}", det, scores, labels, gt_boxes)
            # per-view wireframe renders (the reference's show_2d,
            # dataset_wrappers.py:144-167)
            imgs_u8 = denormalize_images(scene["imgs"], config.data.mean, config.data.std)
            draw_scene_2d(str(show_dir), f"{i:05d}", imgs_u8,
                          np.asarray(scene["proj_img"]), det, labels, gt_boxes)

    pending = None
    try:
        for p in range(len(indices)):
            scene = futures.pop(p).result()
            nxt = p + window
            if nxt < len(indices) and nxt not in futures:
                futures[nxt] = pool.submit(dataset.__getitem__, indices[nxt])
            out = forward_scene(model, scene)
            if pending is not None:
                finish(*pending)
            pending = (p, scene, out)
        if pending is not None:
            finish(*pending)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
    if num_hosts > 1:
        merged = gather_detections(gather_dir, host_id, num_hosts, indices, dt_annos,
                                   timeout=gather_timeout)
        if merged is None:  # rank != 0: detections shipped, metric on rank 0
            return None
        dt_annos = merged
        gt_annos = [dataset.gt_anno(i) for i in range(len(dataset))]
    label2cat = dict(enumerate(config.data.classes))
    ret = indoor_eval(gt_annos, dt_annos, [0.25, 0.5], label2cat)
    if logger is not None:
        logger.log(step, {k: v for k, v in ret.items() if k.startswith("mA")},
                   prefix="val/")
    return ret


def step_generator(seed, step, device):
    """The dropout generator of train step ``step``: a function of the seed
    and the step only, so a resumed run draws what the uninterrupted one
    drew."""
    state = np.random.SeedSequence([seed, step]).generate_state(2)
    return torch.Generator(device=device).manual_seed(
        (int(state[0]) << 31) ^ int(state[1]))


def _visibility_budget(arg, config, ds, n_scan_max):
    if arg == "auto":
        from .visibility import derive_visibility_budgets

        n_scan = min(len(ds), n_scan_max)
        scan_ids = np.linspace(0, len(ds) - 1, n_scan).astype(int)
        budget = derive_visibility_budgets(
            (ds.scene_poses(int(i)) for i in scan_ids),
            config.data.img_shape, config.model,
        )
        print(f"auto per-level visibility budgets (exact bound over {n_scan} "
              f"scenes): {[round(b, 3) for b in budget]}", flush=True)
        return None if all(b >= 1.0 for b in budget) else budget
    budget = float(arg)
    return None if budget >= 1.0 else budget


def main(argv=None):
    return run(parse_args(argv))


def run(args, train_ds=None, val_ds=None):
    """The CLI's work for parsed ``args``; ``train_ds`` / ``val_ds`` replace
    the datasets of ``config.data``.  Eval and show return the mAP dict (None
    on ranks other than 0); train returns None."""
    from . import parallel

    if args.sweep_band is not None:
        raise ValueError("--sweep_band: the port has no banded plane sweep (the "
                         "JAX package's is XLA only); the sweep kernels are exact "
                         "for every geometry")
    ctx = parallel.from_env(args.device)
    try:
        return _run(args, ctx, train_ds, val_ds)
    finally:
        parallel.shutdown(ctx)


def _run(args, ctx, train_ds, val_ds):
    from .configs import apply_overrides, config_json, get_config
    from .train import init_train_state
    from .train.checkpoint import (
        latest_checkpoint,
        load_torch_checkpoint,
        load_torchvision_pretrained,
        restore_checkpoint,
    )

    lead = ctx.rank == 0
    config = apply_overrides(get_config(args.config), args.override)
    if args.data_root:
        config = dataclasses.replace(
            config, data=dataclasses.replace(config.data, data_root=args.data_root))
    if args.n_views_test:
        config = dataclasses.replace(
            config, data=dataclasses.replace(config.data, n_images_test=args.n_views_test))
    log_dir = Path("logs") / args.log_folder
    log_dir.mkdir(parents=True, exist_ok=True)
    logger = None
    if lead:
        (log_dir / "config.json").write_text(config_json(config))
        logger = MetricLogger(log_dir)

    train_loader = None
    if args.mode == "train":
        train_ds, train_loader = build_dataset_and_loader(
            config, True, 1, args.num_workers, args.seed, ctx.rank, ctx.world,
            dataset=train_ds)
    else:
        val_ds, _ = build_dataset_and_loader(config, False, 1, 0, args.seed,
                                             dataset=val_ds)

    if args.visibility_budget is not None:
        ds = train_ds if args.mode == "train" else val_ds
        budget = _visibility_budget(args.visibility_budget, config, ds,
                                    args.visibility_scan_scenes)
        config = dataclasses.replace(
            config, model=dataclasses.replace(config.model, visibility_budget=budget))

    model, optimizer = init_train_state(
        config, torch.Generator().manual_seed(args.seed), ctx.device)
    step = 0

    if args.pretrained_backbone or args.pretrained_matching:
        load_torchvision_pretrained(model, backbone_path=args.pretrained_backbone,
                                    matching_path=args.pretrained_matching)

    if args.load_from:
        if args.load_from.endswith((".ckpt", ".pth")):
            load_torch_checkpoint(args.load_from, model)
        else:
            step = restore_checkpoint(args.load_from, model, optimizer)

    if args.resume:
        last = latest_checkpoint(str(log_dir / "ckpt"))
        if last is not None:
            step = restore_checkpoint(last, model, optimizer)
            if lead:
                print(f"resumed from {last} (step {step})", flush=True)

    try:
        if args.mode in ("eval", "show"):
            if args.ckpt_path:
                # the reference's eval restore (trainer.test(ckpt_path=...),
                # main.py:97)
                restore_checkpoint(args.ckpt_path, model, optimizer)
            show_dir = None
            if args.mode == "show":
                show_dir = log_dir / "show"
                show_dir.mkdir(exist_ok=True)
            ret = run_eval(config, model, val_ds, logger, 0, show_dir,
                           num_workers=args.num_workers, host_id=ctx.rank,
                           num_hosts=ctx.world,
                           gather_dir=str(log_dir / "eval_gather" / "step_0"))
            if ret is not None:  # ranks != 0 ship detections and return None
                print(json.dumps({k: v for k, v in ret.items() if k.startswith("mA")}))
            return ret
        _train(args, ctx, config, model, optimizer, step, train_ds, train_loader,
               val_ds, log_dir, logger)
        return None
    finally:
        if train_loader is not None:
            train_loader.close()
        if logger is not None:
            logger.close()


def _train(args, ctx, config, model, optimizer, step, train_ds, train_loader,
           val_ds, log_dir, logger):
    from . import parallel
    from .train import make_train_step
    from .train.checkpoint import save_checkpoint

    lead = ctx.rank == 0
    step_fn = make_train_step(model, config, optimizer, group=ctx.group)
    total_steps = args.max_steps or config.train.training_steps
    steps_per_epoch = max(1, len(train_loader))
    epoch = step // steps_per_epoch
    train_loader.epoch = epoch  # keep the shuffle order on the resumed epoch
    t_last, logged = time.time(), step
    profiler = None
    val_ds_cache = val_ds

    def log_train(metrics):
        # every 10 steps, as the JAX package, and at each epoch's end, so
        # that a short run logs too
        nonlocal t_last, logged
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.time() - t_last
        metrics["steps_per_sec"] = (step - logged) / dt
        t_last, logged = time.time(), step
        if lead:
            logger.log(step, metrics, prefix="train/")
            print(f"step {step}: loss={metrics['loss']:.4f} "
                  f"({metrics['steps_per_sec']:.2f} it/s)", flush=True)

    def save():
        if lead:
            save_checkpoint(str(log_dir / "ckpt"), model, optimizer, step)
        parallel.barrier(ctx)  # every rank sees the file before it goes on

    while step < total_steps:
        if hasattr(train_ds, "set_epoch"):
            train_ds.set_epoch(train_loader.epoch)
        for batch in train_loader:
            if step >= total_steps:
                break
            scene = {k: v[0] for k, v in batch.items() if k != "index"}
            if args.profile_steps and profiler is None and step == 5:
                profiler = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    *([torch.profiler.ProfilerActivity.CUDA]
                      if ctx.device.type == "cuda" else [])])
                profiler.start()
            metrics = step_fn(scene, step_generator(args.seed, step, ctx.device))
            if profiler is not None and step == 5 + args.profile_steps:
                if ctx.device.type == "cuda":
                    torch.cuda.synchronize(ctx.device)
                profiler.stop()
                trace_dir = log_dir / "profile"
                trace_dir.mkdir(exist_ok=True)
                profiler.export_chrome_trace(str(trace_dir / f"trace_rank{ctx.rank}.json"))
                profiler = False
            step += 1
            if step % 10 == 0:
                log_train(metrics)
        if step > logged:
            log_train(metrics)
        epoch += 1
        save()
        if args.eval_every_epochs and epoch % args.eval_every_epochs == 0:
            if val_ds_cache is None:
                val_ds_cache, _ = build_dataset_and_loader(config, False, 1, 0, args.seed)
            run_eval(config, model, val_ds_cache, logger, step,
                     num_workers=args.num_workers, host_id=ctx.rank, num_hosts=ctx.world,
                     gather_dir=str(log_dir / "eval_gather" / f"step_{step}"))
    save()


if __name__ == "__main__":
    main()
