"""Training losses of the detection heads (sgcdet_tpu/models/losses.py):
masked, static-shape versions of mmdet's FocalLoss,
CrossEntropyLoss(use_sigmoid), AxisAlignedIoULoss (the ScanNet head, on the
aligned IoU of sgcdet_tpu/geometry/boxes.py::axis_aligned_overlaps_3d) and
RotatedIoU3DLoss (the ARKit head, on ``geometry.rotated_iou_3d_torch``)."""
from __future__ import annotations

import torch

from ..geometry.rotated_iou import rotated_iou_3d_torch


def axis_aligned_overlaps_3d(boxes1, boxes2, eps=1e-6):
    """IoU of paired axis-aligned boxes in (x1, y1, z1, x2, y2, z2) corner
    form (``is_aligned=True`` of boxes.py:196-226)."""
    area1 = (boxes1[..., 3:] - boxes1[..., :3]).prod(-1)
    area2 = (boxes2[..., 3:] - boxes2[..., :3]).prod(-1)
    lt = torch.maximum(boxes1[..., :3], boxes2[..., :3])
    rb = torch.minimum(boxes1[..., 3:], boxes2[..., 3:])
    overlap = (rb - lt).clamp(min=0).prod(-1)
    union = torch.clamp(area1 + area2 - overlap, min=eps)
    return overlap / union


def _bce_terms(logits, targets):
    """Per-element BCE with logits, in the numerically stable form."""
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss(logits, labels, n_classes, mask, avg_factor,
                       gamma=2.0, alpha=0.25):
    """mmdet sigmoid focal loss.  logits: (P, C); labels: (P,) in [0, C) or
    -1 for background; mask: (P,) bool points to include.  Label -1 gets an
    all-zero target, as ``jax.nn.one_hot(-1)`` gives (``F.one_hot`` would
    raise)."""
    classes = torch.arange(n_classes, device=labels.device)
    target = (labels[:, None] == classes).to(logits.dtype)
    p = torch.sigmoid(logits)
    pt = (1 - p) * target + p * (1 - target)
    focal_weight = (alpha * target + (1 - alpha) * (1 - target)) * pt ** gamma
    loss = _bce_terms(logits, target) * focal_weight
    loss = torch.where(mask[:, None], loss, 0.0).sum()
    return loss / torch.clamp(avg_factor, min=1e-6)


def bce_with_logits(logits, targets, mask, avg_factor):
    """mmdet CrossEntropyLoss(use_sigmoid=True): per-element BCE summed over
    the masked entries, divided by avg_factor."""
    ce = torch.where(mask, _bce_terms(logits, targets), 0.0).sum()
    return ce / torch.clamp(avg_factor, min=1e-6)


def axis_aligned_iou_loss(pred, target, weight, avg_factor):
    """1 - axis-aligned 3D IoU on corner boxes, weighted."""
    loss = (1.0 - axis_aligned_overlaps_3d(pred, target)) * weight
    return loss.sum() / torch.clamp(avg_factor, min=1e-6)


def rotated_iou_loss(pred, target, weight, avg_factor):
    """1 - rotated 3D IoU on (x, y, z_center, dx, dy, dz, yaw) boxes,
    weighted."""
    loss = (1.0 - rotated_iou_3d_torch(pred, target)) * weight
    return loss.sum() / torch.clamp(avg_factor, min=1e-6)
