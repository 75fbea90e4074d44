"""Host-side (NumPy) 3D NMS for box decoding, the port's copy of
sgcdet_tpu/ops/nms.py (whose package imports JAX): the aligned 3D NMS of the
ScanNet head and the per-class BEV NMS (rotated or not) of the ARKit head,
in the reference's selection order."""
from __future__ import annotations

import numpy as np

from ..geometry.rotated_iou import rotated_rect_iou


def aligned_3d_nms(boxes, scores, classes, thresh):
    """Greedy NMS over axis-aligned corner boxes (n, 6)=(x1,y1,z1,x2,y2,z2).

    IoU is only counted between boxes of the same class. Returns indices of
    kept boxes, highest score first (the selection order of the reference's
    box3d_nms.aligned_3d_nms).
    """
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    classes = np.asarray(classes)
    x1, y1, z1, x2, y2, z2 = (boxes[:, i] for i in range(6))
    area = (x2 - x1) * (y2 - y1) * (z2 - z1)

    order = np.argsort(scores)  # ascending; pick from the back
    pick = []
    while order.size > 0:
        i = order[-1]
        pick.append(int(i))
        rest = order[:-1]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        zz1 = np.maximum(z1[i], z1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        zz2 = np.minimum(z2[i], z2[rest])
        inter = (
            np.maximum(0, xx2 - xx1)
            * np.maximum(0, yy2 - yy1)
            * np.maximum(0, zz2 - zz1)
        )
        iou = inter / (area[i] + area[rest] - inter)
        iou = iou * (classes[rest] == classes[i]).astype(np.float32)
        order = rest[iou <= thresh]
    return np.asarray(pick, np.int64)


def nms_bev(boxes, scores, thresh):
    """Greedy rotated-BEV NMS over boxes (n, 5) = (x1, y1, x2, y2, yaw)
    (mmdet3d's ``nms_bev``: the corner form goes to centre form for the
    rotated-rect IoU).  Returns the kept indices, highest score first;
    equal scores keep their input order."""
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    centered = np.stack([
        (boxes[:, 0] + boxes[:, 2]) / 2, (boxes[:, 1] + boxes[:, 3]) / 2,
        boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1], boxes[:, 4],
    ], axis=-1)
    order = np.argsort(-scores, kind="stable")
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        rest = order[1:]
        if rest.size == 0:
            break
        ious = rotated_rect_iou(np.broadcast_to(centered[i], (rest.size, 5)), centered[rest])
        order = rest[ious <= thresh]
    return np.asarray(keep, np.int64)


def nms_normal_bev(boxes, scores, thresh):
    """Axis-aligned BEV NMS that ignores the yaw (mmdet3d's
    ``nms_normal_bev``)."""
    boxes = np.asarray(boxes, np.float32)[:, :4]
    scores = np.asarray(scores, np.float32)
    order = np.argsort(-scores, kind="stable")
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = (x2 - x1) * (y2 - y1)
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        rest = order[1:]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
        iou = inter / np.maximum(area[i] + area[rest] - inter, 1e-8)
        order = rest[iou <= thresh]
    return np.asarray(keep, np.int64)


def box3d_multiclass_nms(mlvl_bboxes, mlvl_bboxes_for_nms, mlvl_scores, score_thr,
                         max_num, nms_thr, use_rotate_nms=True):
    """Per-class BEV NMS over (N, box_dim) boxes with (N, C + 1) scores, the
    last column the dummy background class (mmdet3d's
    ``box3d_multiclass_nms``).  Returns (bboxes, scores, labels), at most
    ``max_num`` of them by score."""
    mlvl_bboxes = np.asarray(mlvl_bboxes, np.float32)
    mlvl_scores = np.asarray(mlvl_scores, np.float32)
    nms_func = nms_bev if use_rotate_nms else nms_normal_bev
    bboxes, scores, labels = [], [], []
    for i in range(mlvl_scores.shape[1] - 1):
        cls_inds = mlvl_scores[:, i] > score_thr
        if not cls_inds.any():
            continue
        _scores = mlvl_scores[cls_inds, i]
        sel = nms_func(mlvl_bboxes_for_nms[cls_inds], _scores, nms_thr)
        bboxes.append(mlvl_bboxes[cls_inds][sel])
        scores.append(_scores[sel])
        labels.append(np.full(len(sel), i, np.int64))
    if not bboxes:
        return (np.zeros((0, mlvl_bboxes.shape[-1]), np.float32),
                np.zeros((0,), np.float32), np.zeros((0,), np.int64))
    bboxes, scores, labels = (np.concatenate(x, 0) for x in (bboxes, scores, labels))
    if len(bboxes) > max_num:
        inds = np.argsort(-scores, kind="stable")[:max_num]
        bboxes, scores, labels = bboxes[inds], scores[inds], labels[inds]
    return bboxes, scores, labels
