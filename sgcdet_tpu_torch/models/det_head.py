"""Anchor-free FCOS-style 3D detection head, ScanNet variant
(sgcdet_tpu/models/det_head.py; reference ScanNetImVoxelHeadV2): shared
3x3x3 conv heads over the scales with a learned exp scale per scale, and
the host-side (NumPy) decode + aligned NMS."""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.nms import aligned_3d_nms
from ..voxel_grid import voxel_centers_zero_origin
from .layers import Conv3d


class Scale(nn.Module):
    def __init__(self, value=1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(value))


class ImVoxelHead(nn.Module):
    def __init__(self, n_channels, n_classes=18, n_reg_outs=6, n_scales=3):
        super().__init__()
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
            outs.append((self.centerness_conv(x),
                         torch.exp(s.scale * self.reg_conv(x)),
                         self.cls_conv(x)))
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
    """Distances -> corner boxes (x1, y1, z1, x2, y2, z2)."""
    return np.stack([
        points[:, 0] - pred[:, 0], points[:, 1] - pred[:, 2],
        points[:, 2] - pred[:, 4], points[:, 0] + pred[:, 1],
        points[:, 1] + pred[:, 3], points[:, 2] + pred[:, 5],
    ], axis=-1)


def decode_bboxes(head_outs, valid, origin, voxel_size, cfg):
    """Decode one scene's detections on the host (ScanNet head).

    head_outs: per scale (centerness (1,...), bbox_pred (6,...),
    cls (nc,...)) NumPy arrays; valid: (X, Y, Z) float; origin: (3,).
    Returns (boxes (M, 6) center form (cx, cy, cz, dx, dy, dz) with z at the
    geometric center, scores (M,), labels (M,)).
    """
    if cfg.head_type != "scannet":
        raise NotImplementedError("the port decodes the ScanNet head only")
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
        mlvl_bboxes.append(bbox_pred_to_corner(points, b))
        mlvl_scores.append(s)

    bboxes = np.concatenate(mlvl_bboxes)
    scores = np.concatenate(mlvl_scores)
    labels = scores.argmax(axis=1)
    max_scores = scores.max(axis=1)
    ids = max_scores > t.score_thr
    bboxes, max_scores, labels = bboxes[ids], max_scores[ids], labels[ids]
    keep = aligned_3d_nms(bboxes, max_scores, labels, t.iou_thr)
    bboxes = bboxes[keep]
    center_form = np.stack([
        (bboxes[:, 0] + bboxes[:, 3]) / 2, (bboxes[:, 1] + bboxes[:, 4]) / 2,
        (bboxes[:, 2] + bboxes[:, 5]) / 2, bboxes[:, 3] - bboxes[:, 0],
        bboxes[:, 4] - bboxes[:, 1], bboxes[:, 5] - bboxes[:, 2],
    ], axis=1)
    return center_form, max_scores[keep], labels[keep]
