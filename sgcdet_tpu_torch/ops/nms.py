"""Host-side (NumPy) 3D NMS for box decoding — counterpart of
sgcdet_tpu/ops/nms.py::aligned_3d_nms (that module's package imports JAX,
so the port keeps its own copy of the host function)."""
from __future__ import annotations

import numpy as np


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
