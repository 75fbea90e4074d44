"""Optimizer of the train step (sgcdet_tpu/train/optim.py): global-norm clip
35 over every gradient, then no update for the frozen parameters, AdamW at
0.1 x lr for the rest of the backbone and AdamW for everything else, each
on the OneCycle cosine schedule.

Three places where the obvious torch calls differ from the optax chain,
and what this module does instead:

* ``optax.clip_by_global_norm`` counts the frozen parameters' gradients in
  the norm and scales by ``max_norm / norm`` only when ``norm >= max_norm``;
  ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm, and frozen
  parameters left at ``requires_grad=False`` would drop out of it.  The
  frozen parameters here keep ``requires_grad`` and their gradients enter
  the norm; they are never updated.
* ``onecycle_schedule`` is the JAX package's formula, evaluated at each
  group's update count from 0 (step 0 runs at max_lr / 25);
  ``torch.optim.lr_scheduler.OneCycleLR`` agrees only to about 2e-2 and by
  default also cycles Adam's beta1.
* optax's AdamW updates a parameter whose gradient is zero (weight decay
  still moves it); torch's skips parameters without a ``.grad``, so a
  missing gradient is given as zeros.
"""
from __future__ import annotations

import math

import torch


def onecycle_schedule(max_lr, total_steps, pct_start=0.05, div_factor=25.0,
                      final_div_factor=1e4):
    """torch OneCycleLR(anneal_strategy='cos', cycle_momentum=False) values
    as the JAX package computes them (optim.py:15-38): a cosine ramp from
    max_lr / div_factor up to max_lr over pct_start of the steps, then a
    cosine anneal down to initial_lr / final_div_factor."""
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    up_end = float(pct_start * total_steps) - 1.0
    down_end = float(total_steps) - 1.0

    def schedule(step):
        step = float(step)
        if step <= up_end:
            pct = min(max(step / max(up_end, 1.0), 0.0), 1.0)
            return max_lr + (initial_lr - max_lr) / 2.0 * (1 + math.cos(math.pi * pct))
        pct = min(max((step - up_end) / max(down_end - up_end, 1.0), 0.0), 1.0)
        return min_lr + (max_lr - min_lr) / 2.0 * (1 + math.cos(math.pi * pct))

    return schedule


def param_label(name: str) -> str:
    """'frozen' | 'backbone' | 'other' for a parameter name of ``SGCDet``.

    frozen = the backbone stem, stage 1 and every backbone BN affine
    (frozen_stages=1, norm_eval, requires_grad=False in
    configs/SGCDet_ScanNet.py:80-82), the same set as the JAX package's
    ``param_label`` on its flax paths."""
    parts = name.split(".")
    if parts[0] != "backbone":
        return "other"
    module = parts[1:-1]
    if parts[1] in ("conv1", "bn1", "layer1"):
        return "frozen"
    # BNs: bn1..bn3 of a bottleneck and the downsample's BN (downsample.1)
    if module[-1].startswith("bn") or module[-2:] == ["downsample", "1"]:
        return "frozen"
    return "backbone"


class Optimizer:
    """clip -> {frozen: no update, backbone: AdamW(0.1 lr), other: AdamW}.

    ``step()`` reads the ``.grad`` of every parameter of the model, clips
    them together, and updates the non-frozen ones; it returns the global
    gradient norm before clipping (a 0-d tensor on the model's device)."""

    def __init__(self, model: torch.nn.Module, train_cfg):
        self.train_cfg = train_cfg
        self.named = list(model.named_parameters())
        self.labels = {name: param_label(name) for name, _ in self.named}
        groups = []
        for label, mult in (("backbone", train_cfg.backbone_lr_mult), ("other", 1.0)):
            params = [p for n, p in self.named if self.labels[n] == label]
            groups.append(dict(params=params, label=label, schedule=onecycle_schedule(
                train_cfg.lr * mult, train_cfg.training_steps, train_cfg.pct_start,
                train_cfg.div_factor, train_cfg.final_div_factor)))
        self.adamw = torch.optim.AdamW(groups, lr=train_cfg.lr, betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=train_cfg.weight_decay)
        self.count = 0  # updates so far: the schedules' step

    def zero_grad(self):
        for _, p in self.named:
            p.grad = None

    @torch.no_grad()
    def step(self):
        for _, p in self.named:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for _, p in self.named]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        max_norm = self.train_cfg.grad_clip
        scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
        for group in self.adamw.param_groups:
            for p in group["params"]:
                p.grad.mul_(scale)
            group["lr"] = group["schedule"](self.count)
        self.adamw.step()
        self.count += 1
        return norm


def make_optimizer(model, train_cfg) -> Optimizer:
    """The train step's optimizer over every parameter of ``model``."""
    return Optimizer(model, train_cfg)
