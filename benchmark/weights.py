"""Seeded weights, made on the card in a few draws and handed alike to the
program and to the reference: the configuration's draw (``weights.seed``
of its file), each element jittered by the run's seed (``fill``).

Each tensor takes the published initializer's distribution: uniform
+-1/sqrt(fan_in) for convolutions, linear layers and their biases (the
attention's input projection +-1/sqrt(E), its bias zero), Xavier-uniform
where the published model uses it (FPN convolutions, the DFA3D value
projection and the fusion's output projection, whose biases start at
zero), the directional grid for the sampling offsets' biases, normal(0,
0.01) for the head convolutions, ones and zeros for the norms.  Two
departures, both stated in each configuration file's ``assumed``: the
DFA3D sampling-offset and attention-weight projections draw their weights
like any linear layer instead of starting at zero (a trained model's
offsets vary from query to query, which sets the kernels' reads), and the
classification bias is the traffic's prior (``cls_prior`` of the mix file:
the published 0.01 for training; 0.12 for serving, so that the host
decode keeps candidates above its score threshold and the NMS works as it
does on a trained model's output)."""
from __future__ import annotations

import math

import torch
from torch import nn

from .reference import model as ref


def _fans(shape):
    rf = math.prod(shape[2:]) if len(shape) > 2 else 1
    return shape[1] * rf, shape[0] * rf


def _rules(model, cls_bias):
    """[(parameter, rule)]: ('u', bound) uniform, ('n', std) normal, ('c',
    value) constant or ('t', tensor) fixed."""
    fixed = {}
    for mname, m in model.named_modules():
        if isinstance(m, ref.MSDeformableAttention3D):
            grid, dgrid = ref._offset_biases(m.num_heads, m.num_points)
            fixed[f"{mname}.sampling_offsets.bias"] = torch.from_numpy(grid)
            fixed[f"{mname}.sampling_offsets_depth.bias"] = torch.from_numpy(dgrid)
    plan = []
    for mname, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            full = f"{mname}.{pname}"
            if full in fixed:
                rule = ("t", fixed[full])
            elif isinstance(m, ref.ImVoxelHead):
                rule = ("n", 0.01) if pname == "weight" else ("c", cls_bias)
            elif isinstance(m, ref.Scale):
                rule = ("c", 1.0)
            elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d, ref.LayerNorm)):
                rule = ("c", 1.0 if pname == "weight" else 0.0)
            elif isinstance(m, ref.MultiheadAttention):
                rule = (("u", 1.0 / math.sqrt(m.embed_dims)) if pname == "in_proj_weight"
                        else ("c", 0.0))
            elif mname.startswith("neck.") or mname.endswith(("value_proj", "output_proj")):
                if pname == "weight":
                    fin, fout = _fans(tuple(p.shape))
                    rule = ("u", math.sqrt(6.0 / (fin + fout)))
                else:
                    rule = (("c", 0.0) if not mname.startswith("neck.")
                            else ("u", 1.0 / math.sqrt(_fans(tuple(m.weight.shape))[0])))
            else:
                rule = ("u", 1.0 / math.sqrt(_fans(tuple(m.weight.shape))[0]))
            plan.append((full, p, rule))
    return plan


def _draw(plan, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    uni = torch.rand(sum(p.numel() for _, p, r in plan if r[0] == "u"), generator=gen,
                     device=dev).mul_(2).sub_(1)
    nor = torch.randn(sum(p.numel() for _, p, r in plan if r[0] == "n"), generator=gen,
                      device=dev)
    at = {"u": 0, "n": 0}
    for _, p, (kind, val) in plan:
        if kind in at:
            src = uni if kind == "u" else nor
            p.copy_(src[at[kind]:at[kind] + p.numel()].view_as(p) * val)
            at[kind] += p.numel()
        elif kind == "t":
            p.copy_(val)
        else:
            p.fill_(val)


@torch.no_grad()
def fill(model: nn.Module, seed: int, cls_bias: float, base_seed: int, jitter: float) -> None:
    """Fill every parameter and BN statistic of the reference ``model`` (on
    its device): one draw from ``base_seed`` (the configuration's), every
    drawn element then scaled by (1 + ``jitter`` u), u uniform in [-1, 1]
    from ``seed`` (the run's).  Each seed's weights differ, while the work
    that they set (the boxes that the NMS keeps, where DFA3D samples) stays
    that of the one draw."""
    dev = next(model.parameters()).device
    plan = _rules(model, cls_bias)
    _draw(plan, base_seed, dev)
    drawn = [p for _, p, (kind, _) in plan if kind in ("u", "n")]
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand(sum(p.numel() for p in drawn), generator=gen, device=dev)
    at = 0
    for p in drawn:
        p.mul_(u[at:at + p.numel()].view_as(p).mul(2 * jitter).add(1 - jitter))
        at += p.numel()
    for m in model.modules():
        if isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
