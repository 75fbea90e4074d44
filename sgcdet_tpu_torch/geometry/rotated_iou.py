"""Rotated-box IoU by convex polygon intersection (sgcdet_tpu/geometry/
rotated_iou.py): candidate intersection vertices (16 edge-edge + 8
corner-inside) are masked, sorted by angle around their centroid and reduced
with a masked shoelace, with no data-dependent shape.

Two copies of one formula:

* NumPy on the host (``rotated_rect_iou``, ``box_iou_rotated``,
  ``rotated_iou_3d``): the eval's yawed overlaps and the rotated BEV NMS,
  equal to the JAX package's NumPy path;
* torch (``rotated_iou_3d_torch``) for the ARKit head's rotated IoU loss,
  whose autograd gradient is the one ``jax.grad`` gives the JAX package's
  formula: the vertex order comes from a stable argsort of the angles (as
  ``jnp.argsort``) and no gradient flows through the angle; ``maximum`` /
  ``minimum`` split the gradient at exact ties as jax's do, so the height
  overlap's ``clip(top - bot, 0)`` is ``maximum(top - bot, 0)`` here
  (``clamp`` would pass all of it at a tie), and the shoelace's ``abs``
  passes +1 at 0 as jax's does (``torch.abs`` passes 0).
"""
from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-8


# ---------------------------------------------------------------------------
# NumPy (host)
# ---------------------------------------------------------------------------


def _rect_corners(boxes):
    """Corners of BEV rects (..., 5) = (cx, cy, w, h, angle) -> (..., 4, 2),
    counter-clockwise."""
    cx, cy, w, h, a = (boxes[..., i] for i in range(5))
    c, s = np.cos(a), np.sin(a)
    dx = np.stack([-w, w, w, -w], axis=-1) * 0.5
    dy = np.stack([-h, -h, h, h], axis=-1) * 0.5
    x = cx[..., None] + dx * c[..., None] - dy * s[..., None]
    y = cy[..., None] + dx * s[..., None] + dy * c[..., None]
    return np.stack([x, y], axis=-1)


def _edge_intersections(c1, c2):
    """The 16 segment-segment intersection candidates of two quads (..., 4,
    2): points (..., 16, 2) and their validity (..., 16)."""
    p1 = c1[..., :, None, :]
    p2 = np.roll(c1, -1, axis=-2)[..., :, None, :]
    q1 = c2[..., None, :, :]
    q2 = np.roll(c2, -1, axis=-2)[..., None, :, :]
    d1 = p2 - p1
    d2 = q2 - q1
    denom = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    denom_safe = np.where(np.abs(denom) < _EPS, np.ones_like(denom), denom)
    dq = q1 - p1
    t = (dq[..., 0] * d2[..., 1] - dq[..., 1] * d2[..., 0]) / denom_safe
    u = (dq[..., 0] * d1[..., 1] - dq[..., 1] * d1[..., 0]) / denom_safe
    valid = ((np.abs(denom) >= _EPS) & (t >= 0.0) & (t <= 1.0)
             & (u >= 0.0) & (u <= 1.0))
    pts = p1 + t[..., None] * d1
    return (pts.reshape(pts.shape[:-3] + (16, 2)),
            valid.reshape(valid.shape[:-2] + (16,)))


def _points_in_quad(pts, quad):
    """pts (..., 4, 2) inside the convex CCW quad (..., 4, 2) -> (..., 4)."""
    a = quad[..., None, :, :]
    b = np.roll(quad, -1, axis=-2)[..., None, :, :]
    p = pts[..., :, None, :]
    cross = ((b[..., 0] - a[..., 0]) * (p[..., 1] - a[..., 1])
             - (b[..., 1] - a[..., 1]) * (p[..., 0] - a[..., 0]))
    return np.all(cross > -1e-6, axis=-1)


def _polygon_area_masked(pts, valid):
    """Shoelace area of the masked candidate vertices (..., K, 2), sorted by
    angle around their centroid; invalid slots sort last and add nothing."""
    k = pts.shape[-2]
    nvalid = valid.sum(axis=-1)
    vf = valid.astype(pts.dtype)[..., None]
    center = (pts * vf).sum(axis=-2) / np.maximum(nvalid.astype(pts.dtype), 1.0)[..., None]
    rel = pts - center[..., None, :]
    ang = np.where(valid, np.arctan2(rel[..., 1], rel[..., 0]), 1e9)
    order = np.argsort(ang, axis=-1)
    sorted_pts = np.take_along_axis(rel, order[..., None], axis=-2)
    idx = np.arange(k).reshape((1,) * (pts.ndim - 2) + (k,))
    nvalid_b = nvalid[..., None]
    nxt = np.where(idx + 1 < nvalid_b, idx + 1, 0)
    nxt = np.broadcast_to(nxt, sorted_pts.shape[:-1])
    nxt_pts = np.take_along_axis(sorted_pts, nxt[..., None], axis=-2)
    cross = sorted_pts[..., 0] * nxt_pts[..., 1] - sorted_pts[..., 1] * nxt_pts[..., 0]
    area = 0.5 * np.abs(np.where(idx < nvalid_b, cross, 0.0).sum(axis=-1))
    return np.where(nvalid >= 3, area, 0.0).astype(pts.dtype)


def rotated_rect_intersection_area(boxes1, boxes2):
    """Intersection area of paired BEV rects (..., 5)."""
    c1, c2 = _rect_corners(boxes1), _rect_corners(boxes2)
    inter_pts, inter_valid = _edge_intersections(c1, c2)
    pts = np.concatenate([inter_pts, c1, c2], axis=-2)  # (..., 24, 2)
    valid = np.concatenate([inter_valid, _points_in_quad(c1, c2),
                            _points_in_quad(c2, c1)], axis=-1)
    return _polygon_area_masked(pts, valid)


def rotated_rect_iou(boxes1, boxes2):
    """IoU of paired BEV rects (..., 5) = (cx, cy, w, h, angle)."""
    inter = rotated_rect_intersection_area(boxes1, boxes2)
    a1 = boxes1[..., 2] * boxes1[..., 3]
    a2 = boxes2[..., 2] * boxes2[..., 3]
    return inter / np.maximum(a1 + a2 - inter, _EPS)


def box_iou_rotated(boxes1, boxes2):
    """Pairwise (N, M) rotated IoU of BEV rects (N, 5) and (M, 5), computed
    in f64 and returned as f32 (mmcv's ``box_iou_rotated``)."""
    boxes1 = np.asarray(boxes1, np.float64)
    boxes2 = np.asarray(boxes2, np.float64)
    n, m = len(boxes1), len(boxes2)
    if n * m == 0:
        return np.zeros((n, m), np.float32)
    b1 = np.broadcast_to(boxes1[:, None, :], (n, m, 5))
    b2 = np.broadcast_to(boxes2[None, :, :], (n, m, 5))
    return rotated_rect_iou(b1, b2).astype(np.float32)


def _bev(boxes, cat):
    """(x, y, dx, dy, yaw) of boxes (..., 7)."""
    return cat([boxes[..., 0:2], boxes[..., 3:5], boxes[..., 6:7]], -1)


def _height_overlap_volumes(boxes1, boxes2, maximum, minimum):
    top = minimum(boxes1[..., 2] + boxes1[..., 5] * 0.5, boxes2[..., 2] + boxes2[..., 5] * 0.5)
    bot = maximum(boxes1[..., 2] - boxes1[..., 5] * 0.5, boxes2[..., 2] - boxes2[..., 5] * 0.5)
    v1 = boxes1[..., 3] * boxes1[..., 4] * boxes1[..., 5]
    v2 = boxes2[..., 3] * boxes2[..., 4] * boxes2[..., 5]
    return top - bot, v1, v2


def rotated_iou_3d(boxes1, boxes2):
    """Paired 3D IoU of yawed boxes (..., 7) = (x, y, z_center, dx, dy, dz,
    yaw), NumPy: BEV rotated intersection x vertical overlap / union (mmcv's
    ``diff_iou_rotated_3d``, z at the gravity centre)."""
    inter_bev = rotated_rect_intersection_area(_bev(boxes1, np.concatenate),
                                               _bev(boxes2, np.concatenate))
    dh, v1, v2 = _height_overlap_volumes(boxes1, boxes2, np.maximum, np.minimum)
    inter = inter_bev * np.clip(dh, 0.0, None)
    return inter / np.maximum(v1 + v2 - inter, _EPS)


# ---------------------------------------------------------------------------
# torch (the loss; differentiable)
# ---------------------------------------------------------------------------


def _rect_corners_t(boxes):
    cx, cy, w, h, a = boxes.unbind(-1)
    c, s = torch.cos(a), torch.sin(a)
    dx = torch.stack([-w, w, w, -w], -1) * 0.5
    dy = torch.stack([-h, -h, h, h], -1) * 0.5
    x = cx[..., None] + dx * c[..., None] - dy * s[..., None]
    y = cy[..., None] + dx * s[..., None] + dy * c[..., None]
    return torch.stack([x, y], -1)


def _edge_intersections_t(c1, c2):
    p1 = c1[..., :, None, :]
    p2 = torch.roll(c1, -1, dims=-2)[..., :, None, :]
    q1 = c2[..., None, :, :]
    q2 = torch.roll(c2, -1, dims=-2)[..., None, :, :]
    d1 = p2 - p1
    d2 = q2 - q1
    denom = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    small = denom.abs() < _EPS
    denom_safe = torch.where(small, torch.ones_like(denom), denom)
    dq = q1 - p1
    t = (dq[..., 0] * d2[..., 1] - dq[..., 1] * d2[..., 0]) / denom_safe
    u = (dq[..., 0] * d1[..., 1] - dq[..., 1] * d1[..., 0]) / denom_safe
    valid = ~small & (t >= 0.0) & (t <= 1.0) & (u >= 0.0) & (u <= 1.0)
    pts = p1 + t[..., None] * d1
    return (pts.reshape(pts.shape[:-3] + (16, 2)),
            valid.reshape(valid.shape[:-2] + (16,)))


def _points_in_quad_t(pts, quad):
    a = quad[..., None, :, :]
    b = torch.roll(quad, -1, dims=-2)[..., None, :, :]
    p = pts[..., :, None, :]
    cross = ((b[..., 0] - a[..., 0]) * (p[..., 1] - a[..., 1])
             - (b[..., 1] - a[..., 1]) * (p[..., 0] - a[..., 0]))
    return (cross > -1e-6).all(-1)


def _polygon_area_masked_t(pts, valid):
    k = pts.shape[-2]
    nvalid = valid.sum(-1)
    vf = valid.to(pts.dtype)[..., None]
    center = (pts * vf).sum(-2) / nvalid.to(pts.dtype).clamp(min=1.0)[..., None]
    rel = pts - center[..., None, :]
    # the angle only orders the vertices: no gradient flows through it
    rel_d = rel.detach()
    ang = torch.where(valid, torch.atan2(rel_d[..., 1], rel_d[..., 0]), 1e9)
    order = torch.argsort(ang, dim=-1, stable=True)
    sorted_pts = torch.take_along_dim(rel, order[..., None], dim=-2)
    idx = torch.arange(k, device=pts.device)
    nvalid_b = nvalid[..., None]
    nxt = torch.where(idx + 1 < nvalid_b, idx + 1, 0)
    nxt_pts = torch.take_along_dim(sorted_pts, nxt[..., None], dim=-2)
    cross = sorted_pts[..., 0] * nxt_pts[..., 1] - sorted_pts[..., 1] * nxt_pts[..., 0]
    total = torch.where(idx < nvalid_b, cross, 0.0).sum(-1)
    # |total| with jax's gradient: +1 at exactly 0, where torch.abs gives 0
    # (a degenerate polygon of touching boxes)
    area = 0.5 * torch.where(total >= 0, total, -total)
    return torch.where(nvalid >= 3, area, 0.0)


def rotated_iou_3d_torch(boxes1, boxes2):
    """``rotated_iou_3d`` on torch tensors (..., 7), differentiable in both
    boxes: the rotated IoU loss of the ARKit head."""
    c1 = _rect_corners_t(_bev(boxes1, torch.cat))
    c2 = _rect_corners_t(_bev(boxes2, torch.cat))
    inter_pts, inter_valid = _edge_intersections_t(c1, c2)
    pts = torch.cat([inter_pts, c1, c2], -2)
    valid = torch.cat([inter_valid, _points_in_quad_t(c1, c2), _points_in_quad_t(c2, c1)], -1)
    inter_bev = _polygon_area_masked_t(pts, valid)
    dh, v1, v2 = _height_overlap_volumes(boxes1, boxes2, torch.maximum, torch.minimum)
    inter = inter_bev * torch.maximum(dh, torch.zeros_like(dh))
    union = v1 + v2 - inter
    return inter / torch.maximum(union, torch.full_like(union, _EPS))
