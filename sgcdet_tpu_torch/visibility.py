"""Exact per-level visibility budgets (counterpart of
sgcdet_tpu/utils/visibility.py::derive_visibility_budgets).

The budget compaction in ``DeformCrossAttention`` is exact whenever the
per-camera kept-query count is at least the number of visible queries in
every camera.  The selected top-k sets of the finer levels are subsets of
the full voxel grid, so the per-camera visible count over all voxels of a
level bounds that of any selection, and a budget derived from it is exact
for every selection.
"""
from __future__ import annotations

import numpy as np

from .voxel_grid import voxel_centers_zero_origin


def _visible_counts(ref_points, origin, projection, img_shape):
    """NumPy mirror of view_transformer.point_sampling's mask: (N,) visible
    counts of ref_points (K, 3) under projection (N, 3, 4)."""
    eps = 1e-5
    ogf_h, ogf_w = img_shape
    pts = ref_points + np.asarray(origin, np.float32)[None, :]
    hom = np.concatenate([pts, np.ones_like(pts[:, :1])], axis=-1)
    cam = np.einsum("nij,kj->nki", np.asarray(projection, np.float32), hom)
    d = cam[..., 2]
    uv = cam[..., :2] / np.maximum(d, eps)[..., None]
    u = uv[..., 0] / ogf_w
    v = uv[..., 1] / ogf_h
    mask = (d > eps) & (u > eps) & (u < 1.0 - eps) & (v > eps) & (v < 1.0 - eps)
    return mask.sum(axis=1)


def derive_visibility_budgets(scenes, img_shape, model_cfg, margin=1.05):
    """Per-level budget fractions, exact for every scene of ``scenes``
    (iterable of (origin (3,), projection (N, 3, 4)) pairs): the worst
    per-camera visible fraction of each level's query count, times
    ``margin``, clipped to 1.0.  Pass it as ``model.visibility_budget``."""
    worst = [0.0] * len(model_cfg.n_voxels_list)
    for origin, projection, *_ in scenes:
        for i, nvox in enumerate(model_cfg.n_voxels_list):
            ref_all = voxel_centers_zero_origin(nvox, model_cfg.voxel_size_list[i])
            counts = _visible_counts(ref_all, origin, projection, img_shape)
            k = int(np.prod(nvox)) if i == 0 else int(model_cfg.topk_list[i - 1])
            bound = min(k, int(counts.max())) if counts.size else 0
            worst[i] = max(worst[i], bound / max(k, 1))
    return tuple(float(min(1.0, w * margin)) for w in worst)
