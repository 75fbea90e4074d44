"""The reference's host decode of one scene's head outputs, NumPy: sigmoid
scores times centerness times the upsampled valid mask, the top
``nms_pre`` candidates of each scale, the score threshold, and the
class-wise greedy aligned 3D NMS; boxes in centre form."""
from __future__ import annotations

import numpy as np

from .voxel import voxel_centers_zero_origin


def _trilinear_resize(x, size):
    """(C, X, Y, Z) resized as F.interpolate(trilinear, align_corners=False)."""
    out = x
    for axis, new_s in enumerate(size):
        s = out.shape[axis + 1]
        if new_s == s:
            continue
        src = np.clip((np.arange(new_s) + 0.5) * (s / new_s) - 0.5, 0.0, None)
        lo = np.clip(np.floor(src).astype(np.int64), 0, s - 1)
        hi = np.clip(lo + 1, 0, s - 1)
        shape = [1] * out.ndim
        shape[axis + 1] = new_s
        w = (src - lo).astype(np.float32).reshape(shape)
        out = np.take(out, lo, axis=axis + 1) * (1 - w) + np.take(out, hi, axis=axis + 1) * w
    return out


def corner_boxes(points, pred):
    """Distances (x-, x+, y-, y+, z-, z+) from points -> (x1, y1, z1, x2,
    y2, z2)."""
    return np.stack([points[:, 0] - pred[:, 0], points[:, 1] - pred[:, 2],
                     points[:, 2] - pred[:, 4], points[:, 0] + pred[:, 1],
                     points[:, 1] + pred[:, 3], points[:, 2] + pred[:, 5]], -1)


def aligned_nms(boxes, scores, classes, thresh):
    """Greedy NMS of corner boxes, IoU counted within a class only; the kept
    indices, highest score first."""
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    x1, y1, z1, x2, y2, z2 = (boxes[:, i] for i in range(6))
    area = (x2 - x1) * (y2 - y1) * (z2 - z1)
    order = np.argsort(scores)
    keep = []
    while order.size > 0:
        i = order[-1]
        keep.append(int(i))
        rest = order[:-1]
        inter = (np.maximum(0, np.minimum(x2[i], x2[rest]) - np.maximum(x1[i], x1[rest]))
                 * np.maximum(0, np.minimum(y2[i], y2[rest]) - np.maximum(y1[i], y1[rest]))
                 * np.maximum(0, np.minimum(z2[i], z2[rest]) - np.maximum(z1[i], z1[rest])))
        iou = inter / (area[i] + area[rest] - inter)
        iou = iou * (classes[rest] == classes[i]).astype(np.float32)
        order = rest[iou <= thresh]
    return np.asarray(keep, np.int64)


def decode(head_outs, valid, origin, voxel_size, test_cfg):
    """head_outs: per scale (centerness (1, X, Y, Z), bbox (6, ...), cls
    (nc, ...)) NumPy; valid (X, Y, Z); origin (3,).  Returns (boxes (M, 6)
    centre form, scores (M,), labels (M,))."""
    boxes_l, scores_l = [], []
    for i, (ctr, bbox, cls) in enumerate(head_outs):
        fs = ctr.shape[-3:]
        vs = tuple(v * 2 ** i for v in voxel_size)
        points = voxel_centers_zero_origin(fs, vs) + np.asarray(origin)[None]
        v = np.round(_trilinear_resize(valid[None].astype(np.float32), fs)[0])
        v = v.astype(bool).reshape(-1)
        c = 1 / (1 + np.exp(-ctr.transpose(1, 2, 3, 0).reshape(-1)))
        b = bbox.transpose(1, 2, 3, 0).reshape(-1, bbox.shape[0])
        s = 1 / (1 + np.exp(-cls.transpose(1, 2, 3, 0).reshape(-1, cls.shape[0])))
        s = s * c[:, None] * v[:, None]
        top = s.max(axis=1)
        n_pre = test_cfg["nms_pre"]
        if len(s) > n_pre > 0:
            ids = np.argpartition(-top, n_pre - 1)[:n_pre]
            b, s, points = b[ids], s[ids], points[ids]
        boxes_l.append(corner_boxes(points.astype(np.float32), b))
        scores_l.append(s)
    boxes, scores = np.concatenate(boxes_l), np.concatenate(scores_l)
    labels, top = scores.argmax(axis=1), scores.max(axis=1)
    ids = top > test_cfg["score_thr"]
    boxes, top, labels = boxes[ids], top[ids], labels[ids]
    keep = aligned_nms(boxes, top, labels, test_cfg["iou_thr"])
    b = boxes[keep]
    centre = np.stack([(b[:, 0] + b[:, 3]) / 2, (b[:, 1] + b[:, 4]) / 2,
                       (b[:, 2] + b[:, 5]) / 2, b[:, 3] - b[:, 0], b[:, 4] - b[:, 1],
                       b[:, 5] - b[:, 2]], axis=1)
    return centre, top[keep], labels[keep]
