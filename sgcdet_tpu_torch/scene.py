"""Synthetic posed-view scenes, NumPy only: ``example_scene`` is the scene of
``__graft_entry__._example_scene`` (which builds it with jax.numpy), and
``example_train_scene`` adds the synthetic ground truth of
``bench.py::train_step_time``."""
from __future__ import annotations

import numpy as np

from .voxel_grid import compute_projection


def example_scene(img_shape, pad, n_views, rng=None, trajectory="ring"):
    """Synthetic scene: random normalized images and camera poses.

    trajectory="ring": inward-looking orbit at radius 3 — every camera sees
    essentially the whole volume.  trajectory="indoor": a walkthrough inside
    the volume looking outward, like a real ScanNet capture — each camera
    sees only part of the grid, so visibility-budget compaction has a
    realistic (exact) bound to exploit.

    Returns dict of float32 arrays: imgs (N, 3, *pad), proj_img (N, 3, 4),
    proj_feat4 (N, 4, 4), origin (3,).
    """
    rng = rng or np.random.RandomState(0)
    imgs = rng.randn(n_views, 3, *pad).astype(np.float32)
    intr = np.eye(4, dtype=np.float32)
    intr[0, 0] = intr[1, 1] = 1000.0
    intr[0, 2], intr[1, 2] = 648.0, 484.0
    exts = []
    for i in range(n_views):
        if trajectory == "indoor":
            # camera walks a small interior loop, panning a full turn
            ang = 2 * np.pi * (2 * i) / max(n_views, 1)
            px = 0.8 * np.cos(2 * np.pi * i / max(n_views, 1))
            py = 0.8 * np.sin(2 * np.pi * i / max(n_views, 1))
            pos = [px, py, 1.4]
        else:
            ang = 2 * np.pi * i / max(n_views, 1)
            pos = [0, 1.0, 3.0]
        e = np.eye(4, dtype=np.float32)
        c, s = np.cos(ang), np.sin(ang)
        # world->camera: x_cam = R (x - C); rows = camera axes in world
        e[:3, :3] = np.array([[c, -s, 0], [0, 0, -1], [s, c, 0]], np.float32)
        if trajectory == "indoor":
            e[:3, 3] = -e[:3, :3] @ np.asarray(pos, np.float32)
        else:
            e[:3, 3] = pos
        exts.append(e)
    exts = np.stack(exts)
    ori_h = 968
    proj_img = compute_projection(intr, exts, ori_h, img_shape[0], 1)
    ratio4 = ori_h / (img_shape[0] / 4)
    intr4 = intr.copy()
    intr4[:2] /= ratio4
    proj4 = np.einsum("ij,njk->nik", intr4, exts)
    origin = np.array([0.0, 0.0, 0.5], np.float32)
    return dict(imgs=imgs, proj_img=proj_img, proj_feat4=proj4, origin=origin)


def example_train_scene(img_shape, pad, n_views, n_classes, downsample_factor,
                        trajectory="indoor", yawed=False):
    """``example_scene`` plus the train step's synthetic ground truth, as
    ``bench.py::train_step_time`` builds it (bench.py:299-316): 16 padded
    gravity-centre boxes of which the first 8 are real, random labels, and
    metric depth maps at ``downsample_factor`` x the stride-4 grid, all from
    ``RandomState(3)``.

    ``yawed`` (the ARKit head's ground truth) replaces the boxes with 12
    real ones of 16 from ``RandomState(4)``, each with a yaw, standing where
    the indoor walkthrough's cameras look: centres 1.2-2.4 m from the
    loop's axis at any bearing, 0.2-1.2 m high, 0.5-1.4 m a side (the
    labels and depth maps stay the draws of ``RandomState(3)``).

    Adds gt_boxes (16, 7) f32, gt_labels (16,) int32, gt_mask (16,) bool and
    gt_depth (N, pad_h / 4 * ds, pad_w / 4 * ds) f32."""
    scene = example_scene(img_shape, pad, n_views, trajectory=trajectory)
    rng = np.random.RandomState(3)
    max_boxes, n_real = 16, 8
    boxes = np.zeros((max_boxes, 7), np.float32)
    boxes[:, :3] = rng.uniform(-2, 2, (max_boxes, 3))
    boxes[:, 3:6] = rng.uniform(0.3, 1.5, (max_boxes, 3))
    if yawed:
        boxes, n_real = _yawed_boxes(max_boxes), 12
    dh = pad[0] // 4 * downsample_factor
    dw = pad[1] // 4 * downsample_factor
    return dict(
        scene,
        gt_boxes=boxes,
        gt_labels=rng.randint(0, n_classes, max_boxes).astype(np.int32),
        gt_mask=np.arange(max_boxes) < n_real,
        gt_depth=rng.uniform(0.5, 4.5, (n_views, dh, dw)).astype(np.float32),
    )


def _yawed_boxes(n):
    """(n, 7) yawed gravity-centre boxes around the indoor loop (see
    ``example_train_scene``)."""
    rng = np.random.RandomState(4)
    radius = rng.uniform(1.2, 2.4, n)
    bearing = rng.uniform(-np.pi, np.pi, n)
    boxes = np.stack([radius * np.cos(bearing), radius * np.sin(bearing),
                      rng.uniform(0.2, 1.2, n)], 1)
    sizes = rng.uniform(0.5, 1.4, (n, 3))
    yaw = rng.uniform(-np.pi, np.pi, (n, 1))
    return np.concatenate([boxes, sizes, yaw], 1).astype(np.float32)
