"""Fused depth-weighted deformable attention (DFA3D) sampling — counterpart
of sgcdet_tpu/ops/msda.py (the spec), ops/dfa3d_fast.py (the layout) and the
Pallas kernels dfa3d_pallas.py::_fwd_kernel_s1 / _bwd_kernel_s1 (stage 1)
and dfa3d_pallas2.py::_fwd_kernel_v2 / _bwd_kernel_v2 (stage 2).

For every sampling location (u, v, d) the four bilinear corners of the
camera feature map are each re-weighted by the depth distribution linearly
interpolated along d at that corner, then attention-weighted and summed
over points.  Conventions: pixel = loc * size - 0.5, zero padding per
corner, depth lerp with validity per side.

Where the port follows the TPU kernels rather than the JAX CPU path: the
depth distribution is read in its own dtype (f32 on the model's path) and
all math is f32, whereas ``dfa3d_fast`` casts depth to the value dtype
before sampling.  Queries at or past ``valid_counts[cam]`` come back as
exact zeros, in the plain version as in the kernels, and get zero
gradients.

* ``dfa3d_attention_plain`` — plain PyTorch, chunked over queries;
  ``dfa3d_bwd_plain`` — its VJP, recomputed under autograd.
* ``dfa3d_fwd_cuda`` — kernels K2 (heads = P = 1) and K3 (multi-head),
  one entry point of csrc/dfa3d_fwd.cu with a launch count each;
  ``dfa3d_bwd_cuda`` — kernels K6 (stage 1) and K5 (stage 2), one entry
  point of csrc/dfa3d_bwd.cu.
* ``dfa3d_attend`` — the differentiable op the model calls.
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda import DTYPE_CODE, Kernel, check_cuda_input, use_kernel
from .sampling import bilinear_corners, clip_coord, gather_rows

_P, _I = ctypes.c_void_p, ctypes.c_int
# sgc_dfa3d_fwd(vdtype, ddtype, value, depth, locs, attn, counts, out,
#               n, h, w, heads, c, dsize, k, p, stream)
_FWD_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I]
DFA3D_FWD_S1 = Kernel("sgc_dfa3d_fwd", _FWD_ARGS)  # stage 1 launches (K2)
DFA3D_FWD_MH = Kernel("sgc_dfa3d_fwd", _FWD_ARGS)  # stage 2 launches (K3)
# sgc_dfa3d_bwd(vdtype, ddtype, value, depth, locs, attn, counts, g,
#               d_value, d_depth, d_locs, d_attn,
#               n, h, w, heads, c, dsize, k, p, stream)
_BWD_ARGS = [_I, _I] + [_P] * 10 + [_I] * 8
DFA3D_BWD_S1 = Kernel("sgc_dfa3d_bwd", _BWD_ARGS)  # stage 1 launches (K6)
DFA3D_BWD_MH = Kernel("sgc_dfa3d_bwd", _BWD_ARGS)  # stage 2 launches (K5)

# elements of one gathered corner tensor per query chunk of the plain version
_PLAIN_CHUNK_ELEMS = 1 << 25


def _count_mask(out, valid_counts, q0):
    """Zero the queries at or past each camera's count (out: (N, Kc, C))."""
    q = torch.arange(q0, q0 + out.shape[1], device=out.device)
    keep = q[None, :] < valid_counts.to(out.device)[:, None]
    return torch.where(keep[..., None], out, 0.0)


def dfa3d_attention_plain(value_img, dpt_img, locs, attn, num_heads,
                          valid_counts=None):
    """Plain version.

    value_img: (N, H, W, heads*c); dpt_img: (N, H, W, D);
    locs: (N, K, heads, P, 3) normalized (u, v, d); attn: (N, K, heads, P);
    valid_counts: optional (N,) int — queries at or past it return zeros.
    Returns (N, K, heads*c) in value_img's dtype.
    """
    n, h, w, cfull = value_img.shape
    dsize = dpt_img.shape[-1]
    k, heads, p = locs.shape[1], locs.shape[2], locs.shape[3]
    if heads != num_heads:
        raise ValueError(f"locs has {heads} heads, num_heads is {num_heads}")
    c = cfull // heads
    # (N, HW*heads, c): row pix*heads + head is one head's channels
    value = value_img.reshape(n, h * w * heads, c).float()
    depth = dpt_img.reshape(n, h * w, dsize).float()
    head_ids = torch.arange(heads, device=value.device).view(1, 1, heads, 1)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(1, n * heads * p * c))
    outs = []
    for q0 in range(0, k, chunk):
        lc = locs[:, q0:q0 + chunk].float()
        ac = attn[:, q0:q0 + chunk].float()
        kc = lc.shape[1]
        dd = clip_coord(lc[..., 2] * dsize - 0.5, dsize)
        d0f = torch.floor(dd)
        ld = dd - d0f
        d0 = d0f.long()
        wd0 = torch.where((d0 >= 0) & (d0 <= dsize - 1), 1 - ld, 0.0)
        wd1 = torch.where((d0 + 1 >= 0) & (d0 + 1 <= dsize - 1), ld, 0.0)
        d0c = d0.clamp(0, dsize - 1).reshape(n, -1, 1)
        d1c = (d0 + 1).clamp(0, dsize - 1).reshape(n, -1, 1)
        acc = None
        for flat, wb in bilinear_corners(lc[..., 0] * w - 0.5,
                                         lc[..., 1] * h - 0.5, h, w):
            drows = gather_rows(depth, flat.reshape(n, -1))  # (N, M, D)
            ds = (torch.gather(drows, 2, d0c)[..., 0] * wd0.reshape(n, -1)
                  + torch.gather(drows, 2, d1c)[..., 0] * wd1.reshape(n, -1))
            wgt = (wb * ac).reshape(n, -1) * ds
            rows = gather_rows(value, (flat * heads + head_ids).reshape(n, -1))
            term = wgt[..., None] * rows
            acc = term if acc is None else acc + term
        out = acc.reshape(n, kc, heads, p, c).sum(3).reshape(n, kc, cfull)
        if valid_counts is not None:
            out = _count_mask(out, valid_counts, q0)
        outs.append(out.to(value_img.dtype))
    return torch.cat(outs, 1)


def dfa3d_bwd_plain(value_img, dpt_img, locs, attn, g, num_heads,
                    valid_counts=None, sample_grads=True):
    """Plain version of K5/K6: the VJP of ``dfa3d_attention_plain``,
    recomputed under autograd.  Returns (d_value, d_dpt, d_locs, d_attn)
    in the inputs' dtypes; the last two are None unless ``sample_grads``."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(i < 2 or sample_grads)
               for i, t in enumerate((value_img, dpt_img, locs, attn))]
        out = dfa3d_attention_plain(*ins, num_heads, valid_counts)
        wrt = ins if sample_grads else ins[:2]
        grads = torch.autograd.grad(out, wrt, g)
    return tuple(grads) + (None, None) * (not sample_grads)


def _check(value_img, dpt_img, locs, attn, num_heads, valid_counts):
    """Validated kernel operands and sizes, shared by K2/K3 and K5/K6."""
    dev = value_img.device
    value = check_cuda_input(value_img, "value_img",
                             (torch.float32, torch.bfloat16), 4, dev)
    depth = check_cuda_input(dpt_img, "dpt_img", (torch.float32,), 4, dev)
    n, h, w, cfull = value.shape
    if depth.shape[:3] != (n, h, w):
        raise ValueError(f"dpt_img {tuple(depth.shape)} does not match value_img {tuple(value.shape)}")
    loc = check_cuda_input(locs.float(), "locs", (torch.float32,), 5, dev)
    k, heads, p = loc.shape[1], loc.shape[2], loc.shape[3]
    if heads != num_heads or loc.shape[0] != n or loc.shape[4] != 3:
        raise ValueError(f"locs {tuple(loc.shape)} must be (N, K, heads, P, 3)")
    att = check_cuda_input(attn.float(), "attn", (torch.float32,), 4, dev)
    if att.shape != loc.shape[:4]:
        raise ValueError(f"attn {tuple(att.shape)} must be {tuple(loc.shape[:4])}")
    c = cfull // heads
    if c * heads != cfull or c not in (32, 256):
        raise ValueError(f"dfa3d kernels take c in (32, 256) per head, got {cfull}/{heads}")
    counts = None
    if valid_counts is not None:
        counts = check_cuda_input(valid_counts.to(torch.int32), "valid_counts",
                                  (torch.int32,), 1, dev)
        if counts.shape[0] != n:
            raise ValueError(f"valid_counts must be ({n},)")
    stage1 = heads == 1 and p == 1
    sizes = (n, h, w, heads, c, depth.shape[-1], k, p)
    return value, depth, loc, att, counts, stage1, sizes


def _ptr(t):
    return None if t is None else t.data_ptr()


def dfa3d_fwd_cuda(value_img, dpt_img, locs, attn, num_heads,
                   valid_counts=None):
    """Kernels K2/K3 on CUDA tensors; same contract as the plain version,
    for bf16 or f32 values with an f32 depth distribution (the model's
    types).  heads = P = 1 counts as a stage-1 launch, anything else as
    stage 2."""
    value, depth, loc, att, counts, stage1, sizes = _check(
        value_img, dpt_img, locs, attn, num_heads, valid_counts)
    n, _, _, heads, c, _, k, _ = sizes
    out = torch.empty((n, k, heads * c), dtype=value.dtype, device=value.device)
    kernel = DFA3D_FWD_S1 if stage1 else DFA3D_FWD_MH
    kernel(value.device, DTYPE_CODE[value.dtype], DTYPE_CODE[depth.dtype],
           value.data_ptr(), depth.data_ptr(), loc.data_ptr(), att.data_ptr(),
           _ptr(counts), out.data_ptr(), *sizes)
    return out


def dfa3d_bwd_cuda(value_img, dpt_img, locs, attn, g, num_heads,
                   valid_counts=None, sample_grads=True):
    """Kernels K6 (heads = P = 1) / K5 (multi-head) on CUDA tensors; same
    contract as ``dfa3d_bwd_plain``.  The kernels accumulate every
    gradient in f32 (d_value and d_dpt by atomics) and write d_locs and
    d_attn directly; each is cast once to its input's dtype."""
    value, depth, loc, att, counts, stage1, sizes = _check(
        value_img, dpt_img, locs, attn, num_heads, valid_counts)
    gg = check_cuda_input(g.to(value.dtype), "g", (value.dtype,), 3, value.device)
    n, _, _, heads, c, _, k, _ = sizes
    if gg.shape != (n, k, heads * c):
        raise ValueError(f"g {tuple(gg.shape)} must be {(n, k, heads * c)}")
    f32 = dict(dtype=torch.float32, device=value.device)
    d_value = torch.zeros(value.shape, **f32)
    d_depth = torch.zeros(depth.shape, **f32)
    d_locs = torch.empty(loc.shape, **f32) if sample_grads else None
    d_attn = torch.empty(att.shape, **f32) if sample_grads else None
    kernel = DFA3D_BWD_S1 if stage1 else DFA3D_BWD_MH
    kernel(value.device, DTYPE_CODE[value.dtype], DTYPE_CODE[depth.dtype],
           value.data_ptr(), depth.data_ptr(), loc.data_ptr(), att.data_ptr(),
           _ptr(counts), gg.data_ptr(), d_value.data_ptr(), d_depth.data_ptr(),
           _ptr(d_locs), _ptr(d_attn), *sizes)
    if not sample_grads:
        return d_value.to(value_img.dtype), d_depth.to(dpt_img.dtype), None, None
    return (d_value.to(value_img.dtype), d_depth.to(dpt_img.dtype),
            d_locs.to(locs.dtype), d_attn.to(attn.dtype))


class _DFA3D(torch.autograd.Function):
    """K2/K3 forward with K6/K5 backward on the card; the plain version and
    its VJP on the CPU.  The route is fixed in the forward (the autograd
    engine does not see ``plain_ops()``).  Location and attention gradients
    are computed only where autograd asks for them: stage 1's locations are
    fixed voxel centres and its attention is 1."""

    @staticmethod
    def forward(ctx, value_img, dpt_img, locs, attn, valid_counts, num_heads):
        ctx.kernel = use_kernel(value_img)
        ctx.num_heads = num_heads
        ctx.save_for_backward(value_img, dpt_img, locs, attn, valid_counts)
        fwd = dfa3d_fwd_cuda if ctx.kernel else dfa3d_attention_plain
        return fwd(value_img, dpt_img, locs, attn, num_heads, valid_counts)

    @staticmethod
    def backward(ctx, g):
        value_img, dpt_img, locs, attn, valid_counts = ctx.saved_tensors
        bwd = dfa3d_bwd_cuda if ctx.kernel else dfa3d_bwd_plain
        sample_grads = ctx.needs_input_grad[2] or ctx.needs_input_grad[3]
        grads = bwd(value_img, dpt_img, locs, attn, g, ctx.num_heads,
                    valid_counts, sample_grads=sample_grads)
        return (*grads, None, None)


def dfa3d_attend(value_img, dpt_img, locs, attn, num_heads, valid_counts=None):
    """Fused DFA3D sampling, differentiable in value, depth, locations and
    attention: kernels for CUDA tensors, plain versions for CPU tensors (see
    ``dfa3d_attention_plain`` for the contract)."""
    return _DFA3D.apply(value_img, dpt_img, locs, attn, valid_counts, num_heads)
