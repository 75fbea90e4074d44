"""The train step (sgcdet_tpu/train/loop.py:31-157): one scene per step,
forward in train mode, the loss dict, backward through the kernels'
backward passes, clip and AdamW.

    model, optimizer = init_train_state(config, generator, device)
    step = make_train_step(model, config, optimizer)
    metrics = step(scene, dropout_generator)

With a process group (``make_train_step(..., group=ctx.group)``, one scene
per rank) the step is the JAX package's mesh step (loop.py:96-115): the
train-mode BNs sync their batch statistics, the head's average factor is
the ranks' mean positive count, the gradients are averaged over the ranks
before the clip, and the loss terms, the total, n_pos and the BN running
statistics are averaged.  Each rank draws its dropout masks from a
generator of its own (``parallel.rank_generator``).

``make_view_sharded_train_step`` and ``make_view_sharded_eval_step`` (the
JAX package's loop.py:160-258) split one scene's views over the ranks of a
group instead (see their docstrings and ``parallel.py``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import tracing
from ..models import SGCDet
from ..models.detector import compute_losses
from ..models.layers import sync_batchnorm
from ..infer import scene_inputs
from ..parallel import (all_reduce_mean_, all_reduce_sum_, gather_views, rank_generator,
                        view_slice)
from .optim import make_optimizer

_INPUTS = ("imgs", "proj_img", "proj_feat4", "origin")
_TARGETS = ("gt_boxes", "gt_labels", "gt_mask", "gt_depth")


def init_train_state(config, generator: torch.Generator, device="cuda"):
    """The model of ``config`` with weights from ``generator`` (a CPU
    generator: the seeded init), on ``device`` (the card unless the caller
    passes ``device="cpu"``; without a card the default raises), and its
    optimizer."""
    model = SGCDet(config.model, config.data.img_shape, device=device,
                   generator=generator)
    return model, make_optimizer(model, config.train)


def _to_device(x, dev):
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.asarray(x))
    return x.to(dev)


def scene_losses(model, config, scene, generator, group=None, view_group=None):
    """The train-mode forward of one scene and its loss dict: returns
    (losses, n_pos).  ``scene`` and ``generator`` as for the step; with a
    process ``group`` the BNs sync and the losses take the ranks' mean
    positive count; with a ``view_group`` the scene is this rank's slice of
    the scene's views (``parallel.view_slice``)."""
    dev = next(model.parameters()).device
    model.train()
    x = {k: _to_device(scene[k], dev) for k in _INPUTS + _TARGETS if k in scene}
    with sync_batchnorm(group):
        # gt_depth goes to the model too, which reads it where use_gt_dpt
        # (loop.py:67)
        outputs = model(*(x[k] for k in _INPUTS), generator=generator,
                        gt_depth=x.get("gt_depth"), view_group=view_group)
        return compute_losses(config.model, outputs, x["origin"], x["gt_boxes"],
                              x["gt_labels"], x["gt_mask"].bool(),
                              gt_depth=x.get("gt_depth"), group=group,
                              view_group=view_group)


def _over_ranks_(tensors, group, kind, reduce_=all_reduce_mean_):
    """Replace each tensor (one dtype) by its mean (or, with
    ``all_reduce_sum_``, sum) over the ranks, through one all-reduce of a
    flat buffer."""
    flat = reduce_(torch.cat([t.reshape(-1) for t in tensors]), group, kind)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def _grads(params):
    """Every parameter's gradient, zeros where it has none, so that every
    rank reduces the same list."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return [p.grad for p in params]


def make_train_step(model, config, optimizer, group=None):
    """Returns ``step(scene, generator) -> metrics``.

    scene: dict of arrays or tensors with imgs, proj_img, proj_feat4,
    origin, gt_boxes (B, 7), gt_labels (B,), gt_mask (B,) and, for the
    depth loss, gt_depth (N, H, W): this rank's scene.  generator: a
    ``torch.Generator`` on the model's device, the source of the dropout
    masks (with a group, alike on every rank: each rank folds its rank in).
    metrics: 0-d tensors on the device — ``loss``, each loss term, ``n_pos``
    (with a group, the ranks' means) and ``grad_norm`` (the global norm
    before clipping, of the averaged gradients)."""
    if group is None:
        def step(scene, generator):
            with tracing.span("sgc.step"):
                with tracing.span("sgc.step.forward"):
                    losses, n_pos = scene_losses(model, config, scene, generator)
                    total = sum(losses.values())
                with tracing.span("sgc.step.backward"):
                    optimizer.zero_grad()
                    total.backward()
                with tracing.span("sgc.step.optimizer"):
                    grad_norm = optimizer.step()
            metrics = {k: v.detach() for k, v in losses.items()}
            metrics.update(loss=total.detach(), n_pos=n_pos, grad_norm=grad_norm)
            return metrics

        return step

    rank = torch.distributed.get_rank(group)
    params = [p for _, p in optimizer.named]
    stats = [b for name, b in model.named_buffers()
             if name.endswith(("running_mean", "running_var"))]

    def dp_step(scene, generator):
        with tracing.span("sgc.step"):
            with tracing.span("sgc.step.rank_seed"):
                rank_gen = rank_generator(generator, rank)
            with tracing.span("sgc.step.forward"):
                losses, n_pos = scene_losses(model, config, scene, rank_gen, group)
                total = sum(losses.values())
            with tracing.span("sgc.step.backward"):
                optimizer.zero_grad()
                total.backward()
            with tracing.span("sgc.step.exchange"), torch.no_grad():
                _over_ranks_(_grads(params), group, "gradients")
                names = list(losses)
                scalars = torch.stack([losses[k].detach().float() for k in names]
                                      + [total.detach().float(), n_pos.float()])
                all_reduce_mean_(scalars, group, "metrics")
                _over_ranks_(stats, group, "bn_stats")
            with tracing.span("sgc.step.optimizer"):
                grad_norm = optimizer.step()
        metrics = dict(zip(names, scalars[:len(names)]))
        metrics.update(loss=scalars[-2], n_pos=scalars[-1], grad_norm=grad_norm)
        return metrics

    return dp_step


def make_view_sharded_train_step(model, config, optimizer, group):
    """Returns ``step(scene, generator) -> metrics``: one scene's train step
    with its views split over the G ranks of ``group`` (the JAX package's
    loop.py:160-225, whose collectives GSPMD places; here they are placed
    by hand, ``parallel.py``).

    scene: the whole scene, as for ``make_train_step`` (every rank passes
    the same); each rank runs the per-view trunk (backbone, FPN, depth net,
    the lifting's sampling) on its N / G views (``parallel.view_slice``,
    which refuses a view count G does not divide), and from the fusion over
    views on the volume, neck, head and losses are replicated.  generator:
    alike on every rank (the same device and seed): the FFN dropout acts on
    the replicated queries, so every rank draws the same masks from it.

    The gradient convention: each rank backpropagates the total loss / G
    through collectives that take their true transposes (an all-gather's
    is a reduce-scatter sum, an all-reduce sum's an all-reduce sum, a BN
    statistic's mean a mean), so a replicated parameter gets 1 / G of its
    gradient on each rank and a per-view one its views' share; one flat
    all-reduce sum of every gradient then gives each rank the scene's whole
    gradient before the clip.  metrics: the unscaled replicated loss terms,
    ``loss``, ``n_pos`` and ``grad_norm``, alike on every rank, as are the
    parameters and BN running statistics after the step."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    params = [p for _, p in optimizer.named]

    def step(scene, generator):
        with tracing.span("sgc.step"):
            with tracing.span("sgc.step.forward"):
                losses, n_pos = scene_losses(model, config, view_slice(scene, rank, world),
                                             generator, view_group=group)
                total = sum(losses.values())
            with tracing.span("sgc.step.backward"):
                optimizer.zero_grad()
                (total / world).backward()
            with tracing.span("sgc.step.exchange"), torch.no_grad():
                _over_ranks_(_grads(params), group, "view_gradients", all_reduce_sum_)
            with tracing.span("sgc.step.optimizer"):
                grad_norm = optimizer.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics.update(loss=total.detach(), n_pos=n_pos, grad_norm=grad_norm)
        return metrics

    return step


def make_view_sharded_eval_step(model, config, group):
    """Returns ``eval_fn(scene) -> outputs``: the eval forward of one scene
    (as ``infer.forward_scene``) with its views split over the ranks of
    ``group`` (the JAX package's loop.py:228-258).  Every rank passes the
    whole scene and gets the whole outputs: head_outs, valid and occ_preds
    replicated, dpt_dist gathered from every rank's views."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)

    @torch.inference_mode()
    def eval_fn(scene):
        model.eval()
        out = model(*scene_inputs(view_slice(scene, rank, world),
                                  next(model.parameters()).device), view_group=group)
        out["dpt_dist"] = gather_views(out["dpt_dist"], group)
        return out

    return eval_fn
