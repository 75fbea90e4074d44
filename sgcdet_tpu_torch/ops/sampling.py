"""Bilinear corner arithmetic shared by the plain versions of the kernels.

Follows the TPU kernels' convention (sgcdet_tpu/ops/dfa3d_pallas.py
``_sample_quantities``, sweep_pallas.py ``_sweep_rows_weights``): pixel
coordinates are clipped to ``[-4, size + 4]`` before ``floor`` so the integer
conversion is always defined; a NaN coordinate is sent to ``-4``, outside
the image, exactly as the CUDA kernels' ``fmaxf`` does.  Corners outside the
image get weight zero.
"""
from __future__ import annotations

import torch


def clip_coord(x: torch.Tensor, size: int) -> torch.Tensor:
    lo = -4.0
    return torch.where(torch.isnan(x), lo, x).clamp(lo, size + 4.0)


def bilinear_corners(x: torch.Tensor, y: torch.Tensor, h: int, w: int):
    """Four bilinear corners of pixel coordinates ``x, y`` in an (h, w) map.

    Returns a list of (flat pixel index, weight) per corner in the order
    (y0, x0), (y0, x1), (y1, x0), (y1, x1); indices are clamped into the
    map and weights are zero for corners outside it.
    """
    x = clip_coord(x, w)
    y = clip_coord(y, h)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    lx = x - x0f
    ly = y - y0f
    x0 = x0f.long()
    y0 = y0f.long()
    out = []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yi = y0 + dy
        xi = x0 + dx
        valid = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        wgt = (ly if dy else 1 - ly) * (lx if dx else 1 - lx)
        flat = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        out.append((flat, torch.where(valid, wgt, 0.0)))
    return out


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` (B, R, C) at ``idx`` (B, M) -> (B, M, C)."""
    return torch.gather(table, 1, idx[..., None].expand(-1, -1, table.shape[-1]))
