"""3D boxes in the Depth frame (x right, y front, z up), the port's copy of
sgcdet_tpu/geometry/boxes.py: mmdet3d's ``DepthInstance3DBoxes`` semantics
(storage ``(x, y, z_bottom, dx, dy, dz[, yaw])``, origin at the bottom
centre; boxes made with ``origin=(0.5, 0.5, 0.5)`` are shifted down by half
their height) in NumPy for the eval and the datasets, and
``rotation_3d_in_axis`` for NumPy arrays and torch tensors (the yawed FCOS
targets and decode)."""
from __future__ import annotations

import numpy as np
import torch

from .rotated_iou import box_iou_rotated


def rotation_3d_in_axis(points, angles, axis=2):
    """Rotate batches of points (N, M, 3) (or (M, 3)) by angles (N,) around
    one axis, NumPy arrays or torch tensors: ``points @ rot_mat_T`` with, for
    axis 2, ``rot_mat_T = [[cos, sin, 0], [-sin, cos, 0], [0, 0, 1]]``
    (mmdet3d's structures/utils.py)."""
    xp = torch if torch.is_tensor(points) else np
    if xp is np:
        points, angles = np.asarray(points), np.asarray(angles)
    batch_free = points.ndim == 2
    if batch_free:
        points = points[None]
    if angles.ndim == 0:
        angles = xp.broadcast_to(angles, points.shape[:1])
    s, c = xp.sin(angles), xp.cos(angles)
    ones, zeros = xp.ones_like(c), xp.zeros_like(c)
    if axis in (2, -1):
        rows = ([c, s, zeros], [-s, c, zeros], [zeros, zeros, ones])
    elif axis in (1, -2):
        rows = ([c, zeros, -s], [zeros, ones, zeros], [s, zeros, c])
    elif axis in (0, -3):
        rows = ([ones, zeros, zeros], [zeros, c, s], [zeros, -s, c])
    else:
        raise ValueError(f"axis should be in [0,1,2], got {axis}")
    rot = xp.stack([xp.stack(r, axis=-1) for r in rows], axis=-2)
    out = xp.einsum("nmk,nkj->nmj", points, rot)
    return out[0] if batch_free else out


# corner template: unravel_index order with mmdet3d's swap, so the corners
# come out clockwise per face
_CORNERS_NORM = (
    np.stack(np.unravel_index(np.arange(8), [2] * 3), axis=1)[[0, 1, 3, 2, 4, 5, 7, 6]]
    .astype(np.float32)
) - np.array([0.5, 0.5, 0.0], np.float32)


class DepthBoxes3D:
    """Gravity-aligned 3D boxes with an optional yaw, Depth coordinates."""

    def __init__(self, tensor, box_dim=7, with_yaw=True, origin=(0.5, 0.5, 0)):
        tensor = np.asarray(tensor, dtype=np.float32).reshape(-1, box_dim)
        if tensor.shape[-1] == 6 or not with_yaw:
            with_yaw = False
            if tensor.shape[-1] == 6:
                tensor = np.concatenate([tensor, np.zeros((len(tensor), 1), np.float32)], 1)
        self.with_yaw = with_yaw
        self.box_dim = tensor.shape[-1]
        tensor = tensor.copy()
        src = np.asarray(origin, np.float32)
        dst = np.array([0.5, 0.5, 0.0], np.float32)
        if not np.allclose(src, dst):
            tensor[:, :3] += tensor[:, 3:6] * (dst - src)
        self.tensor = tensor

    def __len__(self):
        return len(self.tensor)

    def new_box(self, data):
        b = DepthBoxes3D.__new__(DepthBoxes3D)
        b.tensor = np.asarray(data, np.float32).reshape(-1, self.tensor.shape[-1]).copy()
        b.with_yaw = self.with_yaw
        b.box_dim = self.box_dim
        return b

    def __getitem__(self, item):
        t = self.tensor[item]
        return self.new_box(t[None] if t.ndim == 1 else t)

    @property
    def dims(self):
        return self.tensor[:, 3:6]

    @property
    def yaw(self):
        return self.tensor[:, 6]

    @property
    def volume(self):
        return self.tensor[:, 3] * self.tensor[:, 4] * self.tensor[:, 5]

    @property
    def bottom_center(self):
        return self.tensor[:, :3]

    @property
    def bottom_height(self):
        return self.tensor[:, 2]

    @property
    def top_height(self):
        return self.tensor[:, 2] + self.tensor[:, 5]

    @property
    def gravity_center(self):
        g = self.tensor[:, :3].copy()
        g[:, 2] += self.tensor[:, 5] * 0.5
        return g

    @property
    def bev(self):
        """(N, 5) BEV boxes (x, y, dx, dy, yaw)."""
        return self.tensor[:, [0, 1, 3, 4, 6]]

    @property
    def corners(self):
        """(N, 8, 3) corners in mmdet3d's order."""
        if len(self.tensor) == 0:
            return np.zeros((0, 8, 3), np.float32)
        corners = self.dims[:, None, :] * _CORNERS_NORM[None]
        corners = rotation_3d_in_axis(corners, self.tensor[:, 6], axis=2)
        return corners + self.tensor[:, None, :3]

    @classmethod
    def height_overlaps(cls, boxes1, boxes2):
        hb = np.maximum(boxes1.bottom_height[:, None], boxes2.bottom_height[None])
        lt = np.minimum(boxes1.top_height[:, None], boxes2.top_height[None])
        return np.clip(lt - hb, 0, None)

    @classmethod
    def overlaps(cls, boxes1, boxes2, mode="iou"):
        """3D IoU (``mode="iou"``) or intersection over boxes1's volume
        (N, M) of yawed boxes (mmdet3d's ``BaseInstance3DBoxes.overlaps``)."""
        rows, cols = len(boxes1), len(boxes2)
        if rows * cols == 0:
            return np.zeros((rows, cols), np.float32)
        overlaps_h = cls.height_overlaps(boxes1, boxes2)
        iou2d = box_iou_rotated(boxes1.bev, boxes2.bev)
        areas1 = (boxes1.bev[:, 2] * boxes1.bev[:, 3])[:, None]
        areas2 = (boxes2.bev[:, 2] * boxes2.bev[:, 3])[None]
        overlaps_3d = iou2d * (areas1 + areas2) / (1 + iou2d) * overlaps_h
        v1 = boxes1.volume[:, None]
        v2 = boxes2.volume[None]
        if mode == "iou":
            return overlaps_3d / np.clip(v1 + v2 - overlaps_3d, 1e-8, None)
        return overlaps_3d / np.clip(v1, 1e-8, None)


def axis_aligned_overlaps_3d(boxes1, boxes2, is_aligned=False, eps=1e-6):
    """IoU of axis-aligned 3D boxes in (x1, y1, z1, x2, y2, z2) corner form,
    NumPy: paired (``is_aligned``) or (..., N, M) (mmdet3d's
    ``AxisAlignedBboxOverlaps3D``).  The loss's torch twin is
    ``models/losses.py::axis_aligned_overlaps_3d``."""
    def volume(b):
        return (b[..., 3] - b[..., 0]) * (b[..., 4] - b[..., 1]) * (b[..., 5] - b[..., 2])

    area1, area2 = volume(boxes1), volume(boxes2)
    if not is_aligned:
        boxes1, boxes2 = boxes1[..., :, None, :], boxes2[..., None, :, :]
        area1, area2 = area1[..., :, None], area2[..., None, :]
    lt = np.maximum(boxes1[..., :3], boxes2[..., :3])
    rb = np.minimum(boxes1[..., 3:], boxes2[..., 3:])
    wh = np.clip(rb - lt, 0, None)
    overlap = wh[..., 0] * wh[..., 1] * wh[..., 2]
    return overlap / np.maximum(area1 + area2 - overlap, eps)
