"""Voxel centres of a regular grid whose centre is the scene origin."""
from __future__ import annotations

import numpy as np


def voxel_centers_zero_origin(n_voxels, voxel_size):
    """(nx*ny*nz, 3) float32 centres relative to the grid centre, C order
    over (x, y, z)."""
    n = np.asarray(n_voxels)
    size = np.asarray(voxel_size, dtype=np.float32)
    idx = np.stack(np.meshgrid(*(np.arange(k) for k in n), indexing="ij")).astype(np.float32)
    pts = idx * size.reshape(3, 1, 1, 1) + (-n / 2.0 * size).reshape(3, 1, 1, 1)
    return pts.reshape(3, -1).T.astype(np.float32)
