"""Exact per-level visibility budgets (counterpart of
sgcdet_tpu/utils/visibility.py::derive_visibility_budgets), and the exact
band of the banded-Gram plane sweep on a rig (``required_sweep_band``).

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


def required_sweep_band(proj_feat, n_views, model_cfg, feat_shape):
    """The smallest exact source-row band of the banded-Gram plane sweep
    (``ops/sweep_band.py``) on a rig (sgcdet_tpu/utils/visibility.py::
    required_sweep_band): for every (neighbour pair, output row) every
    in-image source row of nonzero bilinear weight fits the band.  Rigs
    whose neighbours rotate strongly, or whose planes cross a camera plane,
    can need the whole image height.

    proj_feat: (N, 4, 4) K[R|t] at feature resolution (the sweep's
    projections); n_views: N; model_cfg: dbound, neighbor_img_num;
    feat_shape: (h, w) of the matching features.  Returns an int <= h."""
    import torch

    from .models.depth_net import _warp_grid, get_closest_frame_ids
    from .ops.sweep_band import _corner_weights

    h, w = feat_shape
    db = model_cfg.dbound
    dv = torch.from_numpy(np.arange(db[0], db[1], db[2], dtype=np.float32) + db[2] / 2)
    proj = torch.from_numpy(np.asarray(proj_feat, np.float32))
    k = min(model_cfg.neighbor_img_num, n_views - 1)
    nei = torch.from_numpy(get_closest_frame_ids(n_views, k))
    need = 1
    for j in range(k):
        xe, ye = _warp_grid(proj[nei[:, j]], proj, dv, h, w)
        _, y0, _, _, wv0, wv1 = _corner_weights(
            xe.reshape(-1, len(dv), h, w), ye.reshape(-1, len(dv), h, w), h, w)
        y0, wv0, wv1 = (t.numpy() for t in (y0, wv0, wv1))
        big = 10 * h
        lo = np.minimum(np.where(wv0 > 0, y0, big),
                        np.where(wv1 > 0, y0 + 1, big)).min(axis=(1, 3))
        hi = np.maximum(np.where(wv0 > 0, y0, -1),
                        np.where(wv1 > 0, y0 + 1, -1)).max(axis=(1, 3))
        span = np.where(hi >= 0, hi - np.minimum(lo, hi) + 1, 1)
        need = max(need, int(span.max()))
    return min(need, h)
