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
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import SGCDet
from ..models.detector import compute_losses
from ..models.layers import sync_batchnorm
from ..parallel import all_reduce_mean_, rank_generator
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


def scene_losses(model, config, scene, generator, group=None):
    """The train-mode forward of one scene and its loss dict: returns
    (losses, n_pos).  ``scene`` and ``generator`` as for the step; with a
    process ``group`` the BNs sync and the losses take the ranks' mean
    positive count."""
    dev = next(model.parameters()).device
    model.train()
    x = {k: _to_device(scene[k], dev) for k in _INPUTS + _TARGETS if k in scene}
    with sync_batchnorm(group):
        outputs = model(*(x[k] for k in _INPUTS), generator=generator)
        return compute_losses(config.model, outputs, x["origin"], x["gt_boxes"],
                              x["gt_labels"], x["gt_mask"].bool(),
                              gt_depth=x.get("gt_depth"), group=group)


def _mean_over_ranks_(tensors, group, kind):
    """Replace each tensor (one dtype) by its mean over the ranks, through
    one all-reduce of a flat buffer."""
    flat = all_reduce_mean_(torch.cat([t.reshape(-1) for t in tensors]), group, kind)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


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
            losses, n_pos = scene_losses(model, config, scene, generator)
            total = sum(losses.values())
            optimizer.zero_grad()
            total.backward()
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
        losses, n_pos = scene_losses(model, config, scene,
                                     rank_generator(generator, rank), group)
        total = sum(losses.values())
        optimizer.zero_grad()
        total.backward()
        with torch.no_grad():
            # every rank reduces the same list: absent gradients are zeros
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            _mean_over_ranks_([p.grad for p in params], group, "gradients")
            names = list(losses)
            scalars = torch.stack([losses[k].detach().float() for k in names]
                                  + [total.detach().float(), n_pos.float()])
            all_reduce_mean_(scalars, group, "metrics")
            _mean_over_ranks_(stats, group, "bn_stats")
        grad_norm = optimizer.step()
        metrics = dict(zip(names, scalars[:len(names)]))
        metrics.update(loss=scalars[-2], n_pos=scalars[-1], grad_norm=grad_norm)
        return metrics

    return dp_step
