"""Anchor-free FCOS-style 3D detection head (sgcdet_tpu/models/det_head.py;
reference ScanNetImVoxelHeadV2 and SunRgbdImVoxelHeadV2): shared 3x3x3 conv
heads over the scales with a learned exp scale per scale; the FCOS target
assignment over a padded GT set and the head's three losses
(``head_loss_single``); and the host-side (NumPy) decode.  The ScanNet head
(``head_type="scannet"``) predicts axis-aligned boxes, decoded through the
aligned 3D NMS; the ARKit head (``"sunrgbd"``) adds a yaw, trains on the
rotated 3D IoU and decodes through the per-class rotated BEV NMS."""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .. import tracing
from ..geometry.boxes import rotation_3d_in_axis
from ..ops.nms import aligned_3d_nms, box3d_multiclass_nms
from ..parallel import all_reduce_mean_
from ..voxel_grid import voxel_centers_zero_origin
from .layers import Conv3d
from .losses import (
    axis_aligned_iou_loss,
    bce_with_logits,
    rotated_iou_loss,
    sigmoid_focal_loss,
)


class Scale(nn.Module):
    def __init__(self, value=1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(value))


class ImVoxelHead(nn.Module):
    def __init__(self, n_channels, n_classes=18, n_reg_outs=6, n_scales=3,
                 head_type="scannet"):
        super().__init__()
        self.yawed = head_type == "sunrgbd"
        self.centerness_conv = Conv3d(n_channels, 1, 3, padding=1, bias=False)
        self.reg_conv = Conv3d(n_channels, n_reg_outs, 3, padding=1, bias=False)
        self.cls_conv = Conv3d(n_channels, n_classes, 3, padding=1)
        self.scales = nn.ModuleList([Scale(1.0) for _ in range(n_scales)])

    def reset_special_parameters(self, generator):
        for conv in (self.centerness_conv, self.reg_conv, self.cls_conv):
            nn.init.normal_(conv.weight, 0.0, 0.01, generator=generator)
        # bias_init_with_prob(0.01)
        self.cls_conv.bias.fill_(-math.log((1 - 0.01) / 0.01))
        for s in self.scales:
            s.scale.fill_(1.0)

    def forward(self, xs):
        """xs: list of (B, C, X, Y, Z) finest first.  Returns per scale
        (centerness (B,1,...), bbox_pred (B,R,...), cls_score (B,nc,...))."""
        outs = []
        for x, s in zip(xs, self.scales):
            reg = self.reg_conv(x)
            if self.yawed:  # six distances, then the yaw as it comes
                bbox = torch.cat([torch.exp(s.scale * reg[:, :6]), reg[:, 6:]], 1)
            else:
                bbox = torch.exp(s.scale * reg)
            outs.append((self.centerness_conv(x), bbox, self.cls_conv(x)))
        return outs


def _trilinear_resize_np(x, size):
    """torch F.interpolate trilinear align_corners=False on (C, X, Y, Z)."""
    out = x
    for axis, new_s in enumerate(size):
        s = out.shape[axis + 1]
        if new_s == s:
            continue
        src = np.clip((np.arange(new_s) + 0.5) * (s / new_s) - 0.5, 0.0, None)
        lo = np.clip(np.floor(src).astype(np.int64), 0, s - 1)
        hi = np.clip(lo + 1, 0, s - 1)
        w = (src - lo).astype(np.float32)
        a = np.take(out, lo, axis=axis + 1)
        b = np.take(out, hi, axis=axis + 1)
        shape = [1] * out.ndim
        shape[axis + 1] = new_s
        out = a * (1 - w.reshape(shape)) + b * w.reshape(shape)
    return out


def bbox_pred_to_corner(points, pred):
    """Distances -> corner boxes (x1, y1, z1, x2, y2, z2); NumPy arrays or
    torch tensors."""
    stack = torch.stack if torch.is_tensor(points) else np.stack
    return stack([
        points[:, 0] - pred[:, 0], points[:, 1] - pred[:, 2],
        points[:, 2] - pred[:, 4], points[:, 0] + pred[:, 1],
        points[:, 1] + pred[:, 3], points[:, 2] + pred[:, 5],
    ], -1)


def bbox_pred_to_yawed(points, pred):
    """Rotated distances and yaw -> (center, size, yaw) boxes (P, 7); NumPy
    arrays or torch tensors."""
    xp = torch if torch.is_tensor(points) else np
    shift = xp.stack([(pred[:, 1] - pred[:, 0]) / 2, (pred[:, 3] - pred[:, 2]) / 2,
                      (pred[:, 5] - pred[:, 4]) / 2], -1)[:, None, :]
    shift = rotation_3d_in_axis(shift, pred[:, 6], axis=2)[:, 0, :]
    size = xp.stack([pred[:, 0] + pred[:, 1], pred[:, 2] + pred[:, 3],
                     pred[:, 4] + pred[:, 5]], -1)
    return xp.concatenate([points + shift, size, pred[:, 6:7]], -1)


# ---------------------------------------------------------------------------
# target assignment and losses (det_head.py:80-286)
# ---------------------------------------------------------------------------


def head_points(featmap_sizes, voxel_size, origin):
    """Multi-scale voxel-centre points (concatenated), per-point scale ids
    and per-level point counts.  origin: (3,) tensor."""
    pts, scales, level_sizes = [], [], []
    for i, fs in enumerate(featmap_sizes):
        vs = tuple(v * (2 ** i) for v in voxel_size)
        base = torch.from_numpy(voxel_centers_zero_origin(tuple(fs), vs)).to(origin.device)
        pts.append(base + origin[None])
        scales.append(torch.full((base.shape[0],), i, dtype=torch.int64,
                                 device=origin.device))
        level_sizes.append(base.shape[0])
    return torch.cat(pts, 0), torch.cat(scales, 0), level_sizes


def compute_centerness(bbox_targets):
    """sqrt of the product of per-axis min/max distance ratios; the clip
    keeps outside points at 0 instead of NaN."""
    r = None
    for a in range(3):
        pair = bbox_targets[..., 2 * a:2 * a + 2]
        ratio = pair.amin(-1) / pair.amax(-1).clamp(min=1e-12)
        r = ratio if r is None else r * ratio
    return torch.sqrt(r.clamp(min=0.0))


def _best_scale(inside_mask, level_sizes, n_scales, limit):
    """Per-box best scale: the smallest scale with >= limit inside points,
    else the coarsest.  ``torch.argmax`` takes the first maximum, as
    ``jnp.argmax`` does."""
    counts = torch.stack([m.sum(0) for m in torch.split(inside_mask, level_sizes)])
    lower = counts < limit  # (S, B)
    extra = torch.arange(n_scales, 0, -1, device=inside_mask.device)[:, None]
    lower_index = (torch.argmax(lower.long() * extra, dim=0) - 1).clamp(min=0)
    all_upper = (~lower).all(0)
    return torch.where(all_upper, n_scales - 1, lower_index)


def fcos_targets(points, scales, level_sizes, gt_boxes, gt_labels, gt_mask,
                 n_scales, limit, centerness_topk, yawed=False):
    """FCOS target assignment over padded GT.

    points: (P, 3); gt_boxes: (B, 7) gravity-centre (x, y, z, dx, dy, dz,
    yaw); gt_labels: (B,) int; gt_mask: (B,) bool (False = padding).
    ``yawed`` measures each point in each box's own frame (the ARKit head).
    Returns (centerness_targets (P,), target boxes: the corner boxes (P, 6)
    of the ScanNet head or the selected GT boxes (P, 7) of the yawed one,
    labels (P,) with -1 for background, geo_occ (P,))."""
    float_max = 1e8
    volumes = (gt_boxes[:, 3] * gt_boxes[:, 4] * gt_boxes[:, 5])[None]  # (1, B)
    centers = gt_boxes[None, :, :3]
    if yawed:
        shift = points[None, :, :] - gt_boxes[:, None, :3]  # (B, P, 3)
        shift = rotation_3d_in_axis(shift, -gt_boxes[:, 6], axis=2).transpose(0, 1)
        local = centers + shift
    else:
        local = points[:, None, :]
    half = gt_boxes[None, :, 3:6] / 2
    d_min = local - (centers - half)  # (P, B, 3)
    d_max = (centers + half) - local
    bbox_targets6 = torch.stack(
        [d_min[..., 0], d_max[..., 0], d_min[..., 1], d_max[..., 1],
         d_min[..., 2], d_max[..., 2]], -1)  # (P, B, 6)
    inside = (bbox_targets6.amin(-1) > 0) & gt_mask[None, :]
    best_scale = _best_scale(inside, level_sizes, n_scales, limit)
    inside_best = best_scale[None, :] == scales[:, None]

    centerness = compute_centerness(bbox_targets6)
    centerness = torch.where(inside & inside_best, centerness, -1.0)
    top_c = torch.topk(centerness.T, centerness_topk + 1, dim=1).values[:, -1]
    inside_top = centerness > top_c[None, :]

    vol = torch.where(inside & inside_best & inside_top, volumes, float_max)
    # first minimum among ties, as jnp.argmin
    min_area, min_inds = vol.min(1).values, vol.argmin(1)
    labels = torch.where(min_area == float_max, -1, gt_labels[min_inds])
    tgt6 = bbox_targets6[torch.arange(points.shape[0], device=points.device), min_inds]
    centerness_targets = compute_centerness(tgt6)
    geo_occ = inside.any(1)
    if yawed:
        return centerness_targets, gt_boxes[min_inds], labels, geo_occ
    return centerness_targets, bbox_pred_to_corner(points, tgt6), labels, geo_occ


def head_loss_single(head_outs, valids_flat, points, scales, level_sizes,
                     gt_boxes, gt_labels, gt_mask, cfg, group=None):
    """Losses of one scene.  head_outs: per scale (centerness (1, ...),
    bbox_pred (6 or 7, ...), cls_score (nc, ...)) without the batch dim;
    valids_flat: (P,) bool.  With a process ``group`` the losses' average
    factor is the positive count averaged over the ranks (the reference's
    reduce_mean, imvoxel_head_v2.py:207).  Returns (loss_centerness,
    loss_bbox, loss_cls, labels, geo_occ, n_pos), n_pos this rank's."""
    yawed = cfg.head_type == "sunrgbd"

    def flat(i, width):
        return torch.cat([h[i].permute(1, 2, 3, 0).reshape(-1, width)
                          for h in head_outs])

    flat_centerness = flat(0, 1)[:, 0]
    flat_bbox = flat(1, head_outs[0][1].shape[0])
    flat_cls = flat(2, cfg.n_classes)
    centerness_t, bbox_t, labels, geo_occ = fcos_targets(
        points, scales, level_sizes, gt_boxes, gt_labels, gt_mask,
        cfg.n_scales, cfg.limit, cfg.centerness_topk, yawed)

    pos = (labels >= 0) & valids_flat
    n_pos = pos.sum().float()
    n_pos_avg = n_pos
    if group is not None:
        n_pos_avg = all_reduce_mean_(n_pos.clone(), group, "n_pos")
    avg = n_pos_avg.clamp(min=1.0)
    loss_cls = sigmoid_focal_loss(flat_cls, labels, cfg.n_classes, valids_flat, avg)
    loss_centerness = bce_with_logits(flat_centerness, centerness_t, pos, avg)
    weight = centerness_t * pos.float()
    if yawed:
        loss_bbox = rotated_iou_loss(bbox_pred_to_yawed(points, flat_bbox), bbox_t,
                                     weight, weight.sum())
    else:
        loss_bbox = axis_aligned_iou_loss(bbox_pred_to_corner(points, flat_bbox),
                                          bbox_t, weight, weight.sum())
    return loss_centerness, loss_bbox, loss_cls, labels, geo_occ, n_pos


def decode_bboxes(head_outs, valid, origin, voxel_size, cfg):
    """Decode one scene's detections on the host.

    head_outs: per scale (centerness (1,...), bbox_pred (6 or 7,...),
    cls (nc,...)) NumPy arrays; valid: (X, Y, Z) float; origin: (3,).
    Returns (boxes, scores (M,), labels (M,)): the ScanNet head's boxes (M,
    6) in center form (cx, cy, cz, dx, dy, dz) after the aligned 3D NMS,
    the ARKit head's (M, 7) (cx, cy, cz, dx, dy, dz, yaw) after the
    per-class BEV NMS (rotated with ``test_cfg.use_rotate_nms``), at most
    ``nms_pre`` of them; z at the geometric center.
    """
    yawed = cfg.head_type == "sunrgbd"
    t = cfg.test_cfg
    mlvl_bboxes, mlvl_scores = [], []
    for i, (centerness, bbox_pred, cls_score) in enumerate(head_outs):
        fs = centerness.shape[-3:]
        vs = tuple(v * (2 ** i) for v in voxel_size)
        points = voxel_centers_zero_origin(fs, vs) + np.asarray(origin)[None]
        v = _trilinear_resize_np(valid[None].astype(np.float32), fs)[0]
        v = np.round(v).astype(bool).reshape(-1)
        c = 1 / (1 + np.exp(-centerness.transpose(1, 2, 3, 0).reshape(-1)))
        b = bbox_pred.transpose(1, 2, 3, 0).reshape(-1, bbox_pred.shape[0])
        s = 1 / (1 + np.exp(-cls_score.transpose(1, 2, 3, 0)
                            .reshape(-1, cls_score.shape[0])))
        s = s * c[:, None] * v[:, None]
        max_scores = s.max(axis=1)
        if len(s) > t.nms_pre > 0:
            ids = np.argpartition(-max_scores, t.nms_pre - 1)[:t.nms_pre]
            b, s, points = b[ids], s[ids], points[ids]
        to_boxes = bbox_pred_to_yawed if yawed else bbox_pred_to_corner
        mlvl_bboxes.append(to_boxes(points.astype(np.float32), b))
        mlvl_scores.append(s)

    bboxes = np.concatenate(mlvl_bboxes)
    scores = np.concatenate(mlvl_scores)
    if yawed:
        scores_bg = np.concatenate([scores, np.zeros((len(scores), 1), scores.dtype)], 1)
        bev = np.stack([bboxes[:, 0] - bboxes[:, 3] / 2, bboxes[:, 1] - bboxes[:, 4] / 2,
                        bboxes[:, 0] + bboxes[:, 3] / 2, bboxes[:, 1] + bboxes[:, 4] / 2,
                        bboxes[:, 6]], axis=1)
        tracing.count("decode.nms_in", len(bboxes))
        with tracing.span("sgc.decode.nms"):
            return box3d_multiclass_nms(bboxes, bev, scores_bg, t.score_thr, t.nms_pre,
                                        t.nms_thr, use_rotate_nms=t.use_rotate_nms)
    labels = scores.argmax(axis=1)
    max_scores = scores.max(axis=1)
    ids = max_scores > t.score_thr
    bboxes, max_scores, labels = bboxes[ids], max_scores[ids], labels[ids]
    tracing.count("decode.nms_in", len(bboxes))
    with tracing.span("sgc.decode.nms"):
        keep = aligned_3d_nms(bboxes, max_scores, labels, t.iou_thr)
    bboxes = bboxes[keep]
    center_form = np.stack([
        (bboxes[:, 0] + bboxes[:, 3]) / 2, (bboxes[:, 1] + bboxes[:, 4]) / 2,
        (bboxes[:, 2] + bboxes[:, 5]) / 2, bboxes[:, 3] - bboxes[:, 0],
        bboxes[:, 4] - bboxes[:, 1], bboxes[:, 5] - bboxes[:, 2],
    ], axis=1)
    return center_form, max_scores[keep], labels[keep]
