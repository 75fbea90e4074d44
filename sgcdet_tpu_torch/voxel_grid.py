"""Voxel grids and camera projection, NumPy (counterpart of
sgcdet_tpu/geometry/voxel_grid.py): a regular grid of voxel centres laid out
so the scene origin sits at the grid centre, and the pinhole projection
``K[:3, :3] @ E[:3, :4]`` with intrinsics rescaled from the original image
resolution to the network's input resolution."""
from __future__ import annotations

import numpy as np


def voxel_centers_zero_origin(n_voxels, voxel_size):
    """Flattened voxel centres relative to a zero origin: (nx*ny*nz, 3)
    float32, C order over (x, y, z), so flat index ix*ny*nz + iy*nz + iz."""
    n_voxels = np.asarray(n_voxels)
    voxel_size = np.asarray(voxel_size, dtype=np.float32)
    idx = np.stack(np.meshgrid(*(np.arange(n) for n in n_voxels),
                               indexing="ij")).astype(np.float32)
    new_origin = -n_voxels / 2.0 * voxel_size
    pts = idx * voxel_size.reshape(3, 1, 1, 1) + new_origin.reshape(3, 1, 1, 1)
    return pts.reshape(3, -1).T.astype(np.float32)


def compute_projection(intrinsic, extrinsics, ori_h, img_h, stride=1):
    """(N, 3, 4) float32 world->pixel projections ``K_scaled @ E[:3]`` at
    resolution img_h / stride, from a (3, 3) or (4, 4) intrinsic at the
    original height ``ori_h`` and (N, 4, 4) world->camera extrinsics."""
    extrinsics = np.asarray(extrinsics, dtype=np.float32)
    k = np.array(intrinsic, dtype=np.float32)[:3, :3].copy()
    k[:2] /= ori_h / (img_h / stride)
    return np.einsum("ij,njk->nik", k, extrinsics[:, :3, :]).astype(np.float32)
