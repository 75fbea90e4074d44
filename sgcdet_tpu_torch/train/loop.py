"""The single-device train step (sgcdet_tpu/train/loop.py:31-157, the branch
without a mesh): one scene per step, forward in train mode, the loss dict,
backward through the kernels' backward passes, clip and AdamW.

    model, optimizer = init_train_state(config, generator, device)
    step = make_train_step(model, config, optimizer)
    metrics = step(scene, dropout_generator)

Data parallelism, synced BatchNorm, checkpoints and the CLI are not ported
yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import SGCDet
from ..models.detector import compute_losses
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


def scene_losses(model, config, scene, generator):
    """The train-mode forward of one scene and its loss dict: returns
    (losses, n_pos).  ``scene`` and ``generator`` as for the step."""
    dev = next(model.parameters()).device
    model.train()
    x = {k: _to_device(scene[k], dev) for k in _INPUTS + _TARGETS if k in scene}
    outputs = model(*(x[k] for k in _INPUTS), generator=generator)
    return compute_losses(config.model, outputs, x["origin"], x["gt_boxes"],
                          x["gt_labels"], x["gt_mask"].bool(),
                          gt_depth=x.get("gt_depth"))


def make_train_step(model, config, optimizer):
    """Returns ``step(scene, generator) -> metrics``.

    scene: dict of arrays or tensors with imgs, proj_img, proj_feat4,
    origin, gt_boxes (B, 7), gt_labels (B,), gt_mask (B,) and, for the
    depth loss, gt_depth (N, H, W).  generator: a ``torch.Generator`` on the
    model's device, the source of the dropout masks.  metrics: 0-d tensors
    on the device — ``loss``, each loss term, ``n_pos`` and ``grad_norm``
    (the global norm before clipping)."""

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
