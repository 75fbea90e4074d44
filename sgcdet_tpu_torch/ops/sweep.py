"""Fused plane-sweep warp + correlation (counterpart of
sgcdet_tpu/ops/sweep_pallas.py).

For every (view, depth plane, reference pixel):

    corr = <bilinear_sample(src_fea, H_d(pixel)), ref_fea(pixel)> / sqrt(C)

with zero padding per corner (grid_sample(align_corners=False) semantics of
the reference's homo_warping + dot-product correlation).  The math is f32
whatever the input type, and the result is cast back to the input type,
as the TPU kernel does (sweep_pallas.py:596).

* ``sweep_fwd_plain`` — the plain PyTorch version, one depth plane at a time
  so the peak intermediate is one (N, H*W, C) corner gather.
* ``sweep_fwd_cuda`` / ``sweep_bwd_cuda`` — kernels K1 (csrc/sweep_fwd.cu)
  and K4 (csrc/sweep_bwd.cu) on CUDA tensors.
* ``sweep_fwd`` — the differentiable op: a ``torch.autograd.Function`` whose
  forward is K1 and backward K4 for CUDA tensors, and the plain version and
  its VJP for CPU tensors (or under ``plain_ops()``).  Like the TPU op
  (sweep_pallas.py:575-576) it has no coordinate gradient.
* ``plane_sweep_correlation`` — the op of the depth net, NCHW in and out,
  with the signature of ``sweep_pallas.plane_sweep_correlation_pallas``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._cuda import DTYPE_CODE, Kernel, check_cuda_input, use_kernel, zeros_f32
from .sampling import bilinear_corners, gather_rows

_P, _I = ctypes.c_void_p, ctypes.c_int
# sgc_sweep_fwd(dtype, src, ref, x_eff, y_eff, out, n, h, w, c, d, stream)
SWEEP_FWD = Kernel("sgc_sweep_fwd", [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I])
# sgc_sweep_bwd(dtype, src, ref, x_eff, y_eff, g, d_src, d_ref, n, h, w, c, d, stream)
SWEEP_BWD = Kernel("sgc_sweep_bwd",
                   [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I])


def sweep_fwd_plain(src_img, ref_img, x_eff, y_eff):
    """src_img/ref_img: (N, H, W, C); x_eff/y_eff: (N, D, H*W) f32 sample
    coordinates in src pixels.  Returns corr (N, D, H*W) f32."""
    n, h, w, c = src_img.shape
    d = x_eff.shape[1]
    src = src_img.reshape(n, h * w, c).float()
    ref = ref_img.reshape(n, h * w, c).float()
    inv_sqrt_c = 1.0 / math.sqrt(c)
    out = torch.empty((n, d, h * w), dtype=torch.float32, device=src.device)
    for di in range(d):
        warped = None
        for flat, wgt in bilinear_corners(x_eff[:, di].float(),
                                          y_eff[:, di].float(), h, w):
            term = wgt[..., None] * gather_rows(src, flat)
            warped = term if warped is None else warped + term
        out[:, di] = (warped * ref).sum(-1) * inv_sqrt_c
    return out


def sweep_bwd_plain(src_img, ref_img, x_eff, y_eff, g):
    """Plain version of K4: the VJP of ``sweep_fwd_plain`` in (src, ref),
    recomputed under autograd.  Returns (d_src, d_ref) in the inputs'
    dtypes."""
    with torch.enable_grad():
        src = src_img.detach().requires_grad_()
        ref = ref_img.detach().requires_grad_()
        out = sweep_fwd_plain(src, ref, x_eff, y_eff)
        return torch.autograd.grad(out, (src, ref), g)


def _check(src_img, ref_img, x_eff, y_eff):
    dev = src_img.device
    src = check_cuda_input(src_img, "src_img", (torch.float32, torch.bfloat16), 4, dev)
    ref = check_cuda_input(ref_img, "ref_img", (src.dtype,), 4, dev)
    n, h, w, c = src.shape
    if ref.shape != src.shape:
        raise ValueError(f"ref_img {tuple(ref.shape)} != src_img {tuple(src.shape)}")
    if c != 128:
        raise ValueError(f"sweep kernels take the matching net's C = 128, got {c}")
    xe = check_cuda_input(x_eff, "x_eff", (torch.float32,), 3, dev)
    ye = check_cuda_input(y_eff, "y_eff", (torch.float32,), 3, dev)
    d = xe.shape[1]
    if xe.shape != (n, d, h * w) or ye.shape != xe.shape:
        raise ValueError(f"x_eff/y_eff must be (N, D, H*W) = ({n}, {d}, {h * w})")
    return src, ref, xe, ye


def sweep_fwd_cuda(src_img, ref_img, x_eff, y_eff):
    """Kernel K1 on CUDA tensors; same contract as ``sweep_fwd_plain``."""
    src, ref, xe, ye = _check(src_img, ref_img, x_eff, y_eff)
    n, h, w, c = src.shape
    d = xe.shape[1]
    out = torch.empty((n, d, h * w), dtype=torch.float32, device=src.device)
    SWEEP_FWD(src.device, DTYPE_CODE[src.dtype], src.data_ptr(), ref.data_ptr(),
              xe.data_ptr(), ye.data_ptr(), out.data_ptr(), n, h, w, c, d)
    return out


def sweep_bwd_cuda(src_img, ref_img, x_eff, y_eff, g):
    """Kernel K4 on CUDA tensors: (d_src, d_ref) of the correlation for its
    incoming gradient ``g`` (N, D, H*W); same contract as
    ``sweep_bwd_plain``.  K4 accumulates both in f32 (d_src by 16-byte
    vector atomics into an aligned buffer); they are cast once to the input
    dtype."""
    src, ref, xe, ye = _check(src_img, ref_img, x_eff, y_eff)
    n, h, w, c = src.shape
    d = xe.shape[1]
    gg = check_cuda_input(g.float(), "g", (torch.float32,), 3, src.device)
    if gg.shape != xe.shape:
        raise ValueError(f"g {tuple(gg.shape)} must be {tuple(xe.shape)}")
    d_src = zeros_f32((n, h, w, c), src.device)
    d_ref = torch.empty((n, h, w, c), dtype=torch.float32, device=src.device)
    SWEEP_BWD(src.device, DTYPE_CODE[src.dtype], src.data_ptr(), ref.data_ptr(),
              xe.data_ptr(), ye.data_ptr(), gg.data_ptr(), d_src.data_ptr(),
              d_ref.data_ptr(), n, h, w, c, d)
    return d_src.to(src_img.dtype), d_ref.to(ref_img.dtype)


class _Sweep(torch.autograd.Function):
    """K1 forward / K4 backward on the card, the plain version and its VJP
    on the CPU.  The route is fixed in the forward, so the backward of a
    ``plain_ops()`` forward stays plain (the autograd engine does not see
    the context)."""

    @staticmethod
    def forward(ctx, src_img, ref_img, x_eff, y_eff):
        ctx.kernel = use_kernel(src_img)
        ctx.save_for_backward(src_img, ref_img, x_eff, y_eff)
        fwd = sweep_fwd_cuda if ctx.kernel else sweep_fwd_plain
        return fwd(src_img, ref_img, x_eff, y_eff)

    @staticmethod
    def backward(ctx, g):
        bwd = sweep_bwd_cuda if ctx.kernel else sweep_bwd_plain
        d_src, d_ref = bwd(*ctx.saved_tensors, g)
        return d_src, d_ref, None, None


def sweep_fwd(src_img, ref_img, x_eff, y_eff):
    """Plane-sweep correlation core, differentiable in src and ref: kernels
    for CUDA tensors, plain versions for CPU tensors (see
    ``sweep_fwd_plain`` for the contract)."""
    return _Sweep.apply(src_img, ref_img, x_eff, y_eff)


def _correlate(core, src_fea, ref_fea, src_proj, ref_proj, depth_values):
    from ..models.depth_net import _warp_grid

    n, c, h, w = src_fea.shape
    x_eff, y_eff = _warp_grid(src_proj, ref_proj, depth_values, h, w)
    corr = core(src_fea.permute(0, 2, 3, 1), ref_fea.permute(0, 2, 3, 1),
                x_eff, y_eff)
    return corr.reshape(n, -1, h, w).to(src_fea.dtype)


def plane_sweep_correlation(src_fea, ref_fea, src_proj, ref_proj, depth_values):
    """src_fea/ref_fea: (N, C, H, W); src_proj/ref_proj: (N, 4, 4);
    depth_values: (D,).  Returns (N, D, H, W) in src_fea's dtype."""
    return _correlate(sweep_fwd, src_fea, ref_fea, src_proj, ref_proj,
                      depth_values)


def plane_sweep_correlation_plain(src_fea, ref_fea, src_proj, ref_proj,
                                  depth_values):
    """``plane_sweep_correlation`` through the plain version on any device."""
    return _correlate(sweep_fwd_plain, src_fea, ref_fea, src_proj, ref_proj,
                      depth_values)
