"""Result visualization, the port's copy of sgcdet_tpu/utils/visualize.py
(the reference's MultiViewMixin.show / show_2d,
datasets/dataset_wrappers.py:83-167): dump predicted/GT box corners as .npy
per scene and draw projected 3D box wireframes onto images.  Without cv2
(the card's host has none) a render is saved as ``<name>.png.npy`` and the
wireframes are their endpoints, as in the JAX package."""
from __future__ import annotations

import os
import os.path as osp

import numpy as np

from ..geometry.boxes import DepthBoxes3D

_EDGES = (
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
)


def dump_show_results(out_dir, scene_id, det_boxes: DepthBoxes3D, scores, labels,
                      gt_boxes: DepthBoxes3D | None = None):
    """Save pred (and GT) corner arrays + scores/labels (.npy per scene)."""
    os.makedirs(out_dir, exist_ok=True)
    np.save(osp.join(out_dir, f"{scene_id}_pred_corners.npy"), det_boxes.corners)
    np.save(osp.join(out_dir, f"{scene_id}_scores.npy"), np.asarray(scores))
    np.save(osp.join(out_dir, f"{scene_id}_labels.npy"), np.asarray(labels))
    if gt_boxes is not None:
        np.save(osp.join(out_dir, f"{scene_id}_gt_corners.npy"), gt_boxes.corners)


def _label_color(label):
    """Deterministic per-class color (the reference indexes a fixed colormap,
    dataset_wrappers.py:84-86; exact hues are cosmetic)."""
    rng = np.random.RandomState(int(label) * 7 + 5)
    return tuple(int(c) for c in rng.randint(64, 256, size=3))


def denormalize_images(imgs, mean, std):
    """(N, 3, H, W) normalized floats -> (N, H, W, 3) uint8."""
    x = np.asarray(imgs, np.float32).transpose(0, 2, 3, 1)
    x = x * np.asarray(std, np.float32) + np.asarray(mean, np.float32)
    return np.clip(x, 0, 255).astype(np.uint8)


def draw_scene_2d(out_dir, scene_id, imgs_u8, projections, det_boxes, labels,
                  gt_boxes=None):
    """Per-view wireframe renders of predicted (label-colored) and GT (white)
    boxes (the reference's MultiViewMixin.show_2d, dataset_wrappers.py:144-167).

    imgs_u8: (N, H, W, 3) uint8; projections: (N, 3, 4) world->pixel.
    """
    scene_dir = osp.join(out_dir, scene_id)
    os.makedirs(scene_dir, exist_ok=True)
    for v in range(len(imgs_u8)):
        img = imgs_u8[v]
        if det_boxes is not None and len(det_boxes):
            for b in range(len(det_boxes)):
                img = draw_boxes_2d(
                    img, det_boxes[slice(b, b + 1)], projections[v],
                    color=_label_color(labels[b]), thickness=2,
                )
        if gt_boxes is not None and len(gt_boxes):
            img = draw_boxes_2d(img, gt_boxes, projections[v],
                                color=(255, 255, 255), thickness=1)
        _imwrite(osp.join(scene_dir, f"view_{v:03d}.png"), img)


def _imwrite(path, img):
    try:
        import cv2

        cv2.imwrite(path, img[..., ::-1])  # RGB -> BGR
    except Exception:
        np.save(path + ".npy", img)


def draw_boxes_2d(img, boxes: DepthBoxes3D, projection, color=(0, 255, 0), thickness=1):
    """Draw projected 3D box wireframes on an image.

    img: (H, W, 3) uint8 (modified copy returned); projection: (3, 4)
    world->pixel at the image resolution.
    """
    try:
        import cv2
    except Exception:  # pragma: no cover
        cv2 = None
    out = img.copy()
    corners = boxes.corners  # (N, 8, 3)
    for box in corners:
        hom = np.concatenate([box, np.ones((8, 1), np.float32)], axis=1)
        cam = hom @ np.asarray(projection, np.float32).T  # (8, 3)
        z = cam[:, 2]
        if np.any(z <= 0.05):
            continue
        uv = (cam[:, :2] / z[:, None]).astype(np.int32)
        for a, b in _EDGES:
            if cv2 is not None:
                cv2.line(out, tuple(uv[a]), tuple(uv[b]), color, thickness)
            else:  # crude numpy fallback: plot endpoints
                for p in (uv[a], uv[b]):
                    x, y = int(p[0]), int(p[1])
                    if 0 <= y < out.shape[0] and 0 <= x < out.shape[1]:
                        out[y, x] = color
    return out
