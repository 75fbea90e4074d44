"""The reference's train step at float32: FCOS3D targets over the padded GT
boxes, the focal, centerness and axis-aligned IoU losses, the occupancy
BCE, and clip-by-global-norm 35 followed by AdamW (frozen backbone stem,
stage 1 and backbone BN affines not updated, the rest of the backbone at
0.1 x lr) on the OneCycle cosine schedule."""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from .model import interpolate_linear
from .voxel import voxel_centers_zero_origin


def head_points(featmap_sizes, voxel_size, origin):
    pts, scales, sizes = [], [], []
    for i, fs in enumerate(featmap_sizes):
        vs = tuple(v * 2 ** i for v in voxel_size)
        base = torch.from_numpy(voxel_centers_zero_origin(tuple(fs), vs)).to(origin.device)
        pts.append(base + origin[None])
        scales.append(torch.full((base.shape[0],), i, dtype=torch.int64, device=origin.device))
        sizes.append(base.shape[0])
    return torch.cat(pts), torch.cat(scales), sizes


def centerness(t):
    r = 1.0
    for a in range(3):
        pair = t[..., 2 * a:2 * a + 2]
        r = r * (pair.amin(-1) / pair.amax(-1).clamp(min=1e-12))
    return torch.sqrt(torch.as_tensor(r).clamp(min=0.0))


def fcos_targets(points, scales, sizes, gt_boxes, gt_labels, gt_mask, n_scales, limit,
                 centerness_topk):
    """(centerness targets (P,), target corner boxes (P, 6), labels (P,) with
    -1 for background, geometric occupancy (P,))."""
    vol = (gt_boxes[:, 3] * gt_boxes[:, 4] * gt_boxes[:, 5])[None]
    centers, half = gt_boxes[None, :, :3], gt_boxes[None, :, 3:6] / 2
    d_min = points[:, None, :] - (centers - half)
    d_max = (centers + half) - points[:, None, :]
    t6 = torch.stack([d_min[..., 0], d_max[..., 0], d_min[..., 1], d_max[..., 1],
                      d_min[..., 2], d_max[..., 2]], -1)
    inside = (t6.amin(-1) > 0) & gt_mask[None, :]
    counts = torch.stack([m.sum(0) for m in torch.split(inside, sizes)])
    lower = counts < limit
    extra = torch.arange(n_scales, 0, -1, device=points.device)[:, None]
    lower_index = (torch.argmax(lower.long() * extra, dim=0) - 1).clamp(min=0)
    best = torch.where((~lower).all(0), n_scales - 1, lower_index)
    inside_best = best[None, :] == scales[:, None]
    ctr = torch.where(inside & inside_best, centerness(t6), -1.0)
    top_c = torch.topk(ctr.T, centerness_topk + 1, dim=1).values[:, -1]
    vol = torch.where(inside & inside_best & (ctr > top_c[None, :]), vol, 1e8)
    min_area, min_inds = vol.min(1).values, vol.argmin(1)
    labels = torch.where(min_area == 1e8, -1, gt_labels[min_inds])
    tgt = t6[torch.arange(points.shape[0], device=points.device), min_inds]
    p = points
    corner = torch.stack([p[:, 0] - tgt[:, 0], p[:, 1] - tgt[:, 2], p[:, 2] - tgt[:, 4],
                          p[:, 0] + tgt[:, 1], p[:, 1] + tgt[:, 3], p[:, 2] + tgt[:, 5]], -1)
    return centerness(tgt), corner, labels, inside.any(1)


def _bce(logits, targets):
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _iou(a, b, eps=1e-6):
    area1 = (a[:, 3:] - a[:, :3]).prod(-1)
    area2 = (b[:, 3:] - b[:, :3]).prod(-1)
    overlap = (torch.minimum(a[:, 3:], b[:, 3:]) - torch.maximum(a[:, :3], b[:, :3])
               ).clamp(min=0).prod(-1)
    return overlap / torch.clamp(area1 + area2 - overlap, min=eps)


def losses(cfg, out, origin, gt_boxes, gt_labels, gt_mask, group=None):
    """The loss dict of one scene: loss_centerness, loss_bbox, loss_cls and
    loss_occ.  With a process ``group`` the losses' average factor is the
    ranks' mean positive count."""
    head = out["head_outs"]
    sizes3 = [h[0].shape[-3:] for h in head]
    points, scales, sizes = head_points(sizes3, cfg["voxel_size_list"][-1], origin)
    valid = torch.cat([torch.round(interpolate_linear(out["valid"][None, None].float(),
                                                      tuple(fs))[0, 0]).bool().reshape(-1)
                       for fs in sizes3])

    def flat(i, width):
        return torch.cat([h[i].permute(1, 2, 3, 0).reshape(-1, width) for h in head])

    ctr_pred, bbox_pred, cls_pred = flat(0, 1)[:, 0], flat(1, 6), flat(2, cfg["n_classes"])
    ctr_t, box_t, labels, geo_occ = fcos_targets(points, scales, sizes, gt_boxes, gt_labels,
                                                 gt_mask, cfg["n_scales"], cfg["limit"],
                                                 cfg["centerness_topk"])
    pos = (labels >= 0) & valid
    avg = pos.sum().float()
    if group is not None:
        dist.all_reduce(avg, group=group)
        avg = avg / dist.get_world_size(group)
    avg = avg.clamp(min=1.0)
    target = (labels[:, None] == torch.arange(cfg["n_classes"], device=labels.device)).float()
    p = torch.sigmoid(cls_pred)
    pt = (1 - p) * target + p * (1 - target)
    focal = _bce(cls_pred, target) * (0.25 * target + 0.75 * (1 - target)) * pt ** 2
    loss_cls = torch.where(valid[:, None], focal, 0.0).sum() / avg
    loss_ctr = torch.where(pos, _bce(ctr_pred, ctr_t), 0.0).sum() / avg
    weight = ctr_t * pos.float()
    pred_corner = torch.stack([points[:, 0] - bbox_pred[:, 0], points[:, 1] - bbox_pred[:, 2],
                               points[:, 2] - bbox_pred[:, 4], points[:, 0] + bbox_pred[:, 1],
                               points[:, 1] + bbox_pred[:, 3], points[:, 2] + bbox_pred[:, 5]], -1)
    loss_bbox = (((1.0 - _iou(pred_corner, box_t)) * weight).sum()
                 / torch.clamp(weight.sum(), min=1e-6))
    occ = out["occ_preds"]
    tgt = geo_occ[:occ.shape[0]].float()
    po = occ.clamp(1e-7, 1 - 1e-7)
    loss_occ = -(tgt * torch.log(po) + (1 - tgt) * torch.log(1 - po)).mean() * 0.5
    return dict(loss_centerness=loss_ctr, loss_bbox=loss_bbox, loss_cls=loss_cls,
                loss_occ=loss_occ)


def frozen(name):
    """The parameters that the published recipe never updates: the
    backbone's stem, stage 1 and every backbone BatchNorm affine."""
    parts = name.split(".")
    if parts[0] != "backbone":
        return False
    return (parts[1] in ("conv1", "bn1", "layer1") or parts[-2].startswith("bn")
            or parts[-3:-1] == ["downsample", "1"])


def onecycle(max_lr, total, pct_start, div_factor, final_div_factor, step):
    initial = max_lr / div_factor
    low = initial / final_div_factor
    up_end, down_end = float(pct_start * total) - 1.0, float(total) - 1.0
    if step <= up_end:
        pct = min(max(step / max(up_end, 1.0), 0.0), 1.0)
        return max_lr + (initial - max_lr) / 2.0 * (1 + math.cos(math.pi * pct))
    pct = min(max((step - up_end) / max(down_end - up_end, 1.0), 0.0), 1.0)
    return low + (max_lr - low) / 2.0 * (1 + math.cos(math.pi * pct))


class AdamW:
    """Clip by the global norm of every gradient, then AdamW (betas 0.9,
    0.999, eps 1e-8, decoupled decay) on the parameters that train."""

    def __init__(self, model, tcfg):
        self.tcfg = tcfg
        self.named = list(model.named_parameters())
        self.m = {n: torch.zeros_like(p) for n, p in self.named if not frozen(n)}
        self.v = {n: torch.zeros_like(p) for n, p in self.m.items()}
        self.count = 0
        self.first_grads = None

    @torch.no_grad()
    def step(self):
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in self.named}
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads.values()]))
        scale = 1.0 if float(norm) < self.tcfg["grad_clip"] else self.tcfg["grad_clip"] / norm
        if self.count == 0:
            self.first_grads = {n: grads[n] * scale for n in self.m}
        t = self.count + 1
        for n, p in self.named:
            if n not in self.m:
                continue
            mult = self.tcfg["backbone_lr_mult"] if n.startswith("backbone.") else 1.0
            lr = onecycle(self.tcfg["lr"] * mult, self.tcfg["training_steps"],
                          self.tcfg["pct_start"], self.tcfg["div_factor"],
                          self.tcfg["final_div_factor"], self.count)
            g = grads[n] * scale
            self.m[n].mul_(0.9).add_(g, alpha=0.1)
            self.v[n].mul_(0.999).addcmul_(g, g, value=0.001)
            p.mul_(1 - lr * self.tcfg["weight_decay"])
            denom = (self.v[n] / (1 - 0.999 ** t)).sqrt() + 1e-8
            p.addcdiv_(self.m[n] / (1 - 0.9 ** t), denom, value=-lr)
        self.count += 1
        return norm


def rank_generator(generator, rank):
    """The generator of one rank's dropout masks in a data-parallel step: one
    draw of the shared generator folded with the rank (the program's
    documented fold-in, ``jax.random.fold_in`` in the published code)."""
    draw = torch.randint(0, 2 ** 62, (1,), generator=generator, device=generator.device)
    seed = int(draw.item()) ^ ((rank * 0x9E3779B97F4A7C15) & (2 ** 63 - 1))
    return torch.Generator(device=generator.device).manual_seed(seed)


def mean_over_ranks_(tensors, group):
    """Replace each tensor by its mean over the ranks (one flat all-reduce)."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))
