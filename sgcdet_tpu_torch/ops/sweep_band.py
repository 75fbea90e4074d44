"""Banded-Gram plane-sweep correlation — counterpart of
sgcdet_tpu/ops/sweep_band.py, which is XLA (a scan, a dynamic slice and
einsums) and reaches no Pallas kernel; here it is plain PyTorch on any
device.

The sweep's correlation is

    corr[d, p] = < bilinear(src, warp_d(p)), ref[p] > / sqrt(C)

and bilinear interpolation is linear, so the channel contraction commutes
with it exactly: interpolate the scalar Gram field G[(y, x), p] = <src[y, x],
ref[p]> instead of gathering C-wide rows a sample.  The samples of one
output row stay inside a narrow band of source rows, so G is needed only on
a (band x W) x W tile a row:

    per output row py:
      band = src[v0(py) : v0(py) + B]                   (a row slice)
      G    = band @ ref_row^T                           (B*W, C) @ (C, W)
      corr = sum_b Wv[d, b, q] * sum_x Wu[d, x, q] * G[b, x, q]

It equals the gather path (``ops/sweep.py``: zero padding, the same corner
and validity convention, coordinates clipped to [-4, size + 4] before the
floor) wherever every in-image source row an output row needs lies in its
band; ``band_violations`` counts the samples for which one does not (0:
exact).  No custom backward: autograd differentiates it, and the sample
coordinates are detached, as the sweep kernels have no coordinate
gradient.
"""
from __future__ import annotations

import math

import torch


def _corner_weights(x_eff, y_eff, h, w):
    """Floor corners (x0, y0) int32 and the factor pairs (wu0, wu1) along x
    and (wv0, wv1) along y, validity-masked, so that a corner's weight is
    wv * wu as on the gather path."""
    x = x_eff.clamp(-4.0, w + 4.0)
    y = y_eff.clamp(-4.0, h + 4.0)
    x0f, y0f = torch.floor(x), torch.floor(y)
    lx, ly = x - x0f, y - y0f
    x0, y0 = x0f.int(), y0f.int()
    vx0 = ((x0 >= 0) & (x0 <= w - 1)).to(x.dtype)
    vx1 = ((x0 + 1 >= 0) & (x0 + 1 <= w - 1)).to(x.dtype)
    vy0 = ((y0 >= 0) & (y0 <= h - 1)).to(y.dtype)
    vy1 = ((y0 + 1 >= 0) & (y0 + 1 <= h - 1)).to(y.dtype)
    return x0, y0, (1 - lx) * vx0, lx * vx1, (1 - ly) * vy0, ly * vy1


def _band_starts(y0, vy0, vy1, h, band):
    """Band start row a (pair, output row): the smallest in-image source row
    of nonzero vertical weight, clamped so the band fits the image.
    y0, vy0, vy1: (N, D, H, W).  Returns v0 (N, H) int32 and that row."""
    big = 10 * h
    lo0 = torch.where(vy0 > 0, y0, big)
    lo1 = torch.where(vy1 > 0, y0 + 1, big)
    lo = torch.minimum(lo0, lo1).amin(dim=(1, 3))  # (N, H)
    return lo.clamp(0, max(h - band, 0)).int(), lo


def band_violations(x_eff, y_eff, h, w, band):
    """The (pair, plane, pixel) samples whose in-image source rows do not
    fit the band: 0 means the banded result is exact."""
    n, d = y_eff.shape[:2]
    _, y0, _, _, wv0, wv1 = _corner_weights(x_eff.reshape(y_eff.shape), y_eff, h, w)
    y0, wv0, wv1 = (t.reshape(n, d, h, w) for t in (y0, wv0, wv1))
    v0, _ = _band_starts(y0, wv0, wv1, h, band)
    top = torch.maximum(torch.where(wv0 > 0, y0, -1), torch.where(wv1 > 0, y0 + 1, -1))
    return int((top > (v0[:, None, :, None] + band - 1)).sum())


def sweep_correlation_banded(src_img, ref_img, x_eff, y_eff, band, rows_per_step=4):
    """src_img/ref_img: (N, H, W, C); x_eff/y_eff: (N, D, H*W).  Returns corr
    (N, D, H*W) f32, scaled by 1/sqrt(C).  The Gram products take bf16
    inputs as they are (exact in f32) and sum in f32; ``rows_per_step``
    output rows a step (the largest divisor of H not above it)."""
    n, h, w, c = src_img.shape
    d = x_eff.shape[1]
    band = min(band, h)
    while h % rows_per_step:
        rows_per_step -= 1
    r = rows_per_step
    x_eff = x_eff.detach().reshape(n, d, h, w)
    y_eff = y_eff.detach().reshape(n, d, h, w)
    x0, y0, wu0, wu1, wv0, wv1 = _corner_weights(x_eff, y_eff, h, w)
    v0, _ = _band_starts(y0, wv0, wv1, h, band)
    src, ref = src_img.float(), ref_img.float()
    dev = src.device
    xs = torch.arange(w, dtype=torch.int32, device=dev)[:, None]     # (X, 1)
    bs = torch.arange(band, dtype=torch.int32, device=dev)[:, None]  # (B, 1)
    views = torch.arange(n, device=dev)[:, None, None]
    outs = []
    for row0 in range(0, h, r):
        rows = slice(row0, row0 + r)
        starts = v0[:, rows]  # (N, R)
        # one band of source rows a (pair, output row): (N, R, B, W, C)
        band_rows = src[views, starts[..., None] + bs[:, 0].long()]
        g = torch.einsum("nrbxc,nrqc->nrbxq", band_rows, ref[:, rows])
        x0s, yl = x0[:, :, rows, None, :], (y0[:, :, rows] - starts[:, None, :, None])[
            :, :, :, None, :]
        # the bilinear weights as one-hot factors along x and the band's rows
        wu = (wu0[:, :, rows, None, :] * (xs == x0s) + wu1[:, :, rows, None, :] * (xs == x0s + 1))
        wv = (wv0[:, :, rows, None, :] * (bs == yl) + wv1[:, :, rows, None, :] * (bs == yl + 1))
        t = torch.einsum("ndrxq,nrbxq->ndrbq", wu, g)
        outs.append(torch.einsum("ndrbq,ndrbq->ndrq", wv, t))
    out = torch.cat(outs, dim=2)  # (N, D, H, W)
    return out.reshape(n, d, h * w) / math.sqrt(c)


def plane_sweep_correlation_banded(src_fea, ref_fea, src_proj, ref_proj, depth_values,
                                   band, rows_per_step=4):
    """The banded counterpart of ``ops/sweep.py::plane_sweep_correlation``:
    src_fea/ref_fea (N, C, H, W) -> (N, D, H, W) in src_fea's dtype."""
    from ..models.depth_net import _warp_grid

    n, c, h, w = src_fea.shape
    x_eff, y_eff = _warp_grid(src_proj, ref_proj, depth_values, h, w)
    corr = sweep_correlation_banded(src_fea.permute(0, 2, 3, 1), ref_fea.permute(0, 2, 3, 1),
                                    x_eff.float(), y_eff.float(), band, rows_per_step)
    return corr.reshape(n, -1, h, w).to(src_fea.dtype)


def plane_sweep_band_violations(src_proj, ref_proj, depth_values, h, w, band):
    """The violation count of a rig (0: banded equals the gather path)."""
    from ..models.depth_net import _warp_grid

    x_eff, y_eff = _warp_grid(src_proj, ref_proj, depth_values, h, w)
    return band_violations(x_eff.float(), y_eff.float(), h, w, band)
