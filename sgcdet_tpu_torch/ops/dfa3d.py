"""Fused depth-weighted deformable attention (DFA3D) sampling — counterpart
of sgcdet_tpu/ops/msda.py (the spec), ops/dfa3d_fast.py (the layout), the
dispatcher ops/dfa3d.py (``dfa3d_attend``, ``msda_2d_attend``) and every
Pallas DFA3D kernel of sgcdet_tpu/ops: dfa3d_pallas.py (v1), dfa3d_pallas2.py
(v2), dfa3d_pallas3.py (v3 quad and packed-quad).  Those are one function
at different combinations of value dtype, depth dtype, heads x points and
counted or not; here one forward and one backward template serve them all.

For every sampling location (u, v, d) the four bilinear corners of the
camera feature map are each re-weighted by the depth distribution linearly
interpolated along d at that corner, then attention-weighted and summed
over points.  Conventions: pixel = loc * size - 0.5, zero padding per
corner, depth lerp with validity per side.

Where the port follows the TPU kernels rather than the JAX CPU path: the
depth distribution is read in its own dtype (f32 on the DFA3D model path,
bf16 on the bf16 2D path) and all math is f32, whereas ``dfa3d_fast`` casts
depth to the value dtype before sampling.  The kernels take f32 or bf16
value with f32 depth, or bf16 value with bf16 depth (the packed-quad
kernels' pair); f32 value with bf16 depth, which nothing runs, raises.
Queries at or past ``valid_counts[cam]`` come back as exact zeros, in the
plain version as in the kernels, and get zero gradients.

* ``dfa3d_attention_plain`` — plain PyTorch, chunked over queries;
  ``dfa3d_bwd_plain`` — its VJP, recomputed under autograd.
* ``dfa3d_fwd_cuda`` — kernels K2 (heads = P = 1) and K3 (multi-head),
  and their bf16-depth instances K2' and K3', one entry point of
  csrc/dfa3d_fwd.cu with a launch count each; ``dfa3d_bwd_cuda`` — kernels
  K6 (stage 1) and K5 (stage 2), and K6' / K5' at bf16 depth, two entry
  points of csrc/dfa3d_bwd.cu (stage 1 its own: the gradients summed where
  they live, several CUDA kernels behind one launch count).
* ``dfa3d_attend`` — the differentiable op the model calls;
  ``msda_2d_attend`` — 2D multi-scale deformable attention as DFA3D with a
  uniform depth (the ``use_depth=False`` lifting path).
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda import DTYPE_CODE, Kernel, check_cuda_input, use_kernel, zeros_f32
from .sampling import bilinear_corners, clip_coord, gather_rows

_P, _I = ctypes.c_void_p, ctypes.c_int
# sgc_dfa3d_fwd(vdtype, ddtype, value, depth, locs, attn, counts, out,
#               n, h, w, heads, c, dsize, k, p, stream)
_FWD_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I]
DFA3D_FWD_S1 = Kernel("sgc_dfa3d_fwd", _FWD_ARGS)  # stage 1 launches (K2)
DFA3D_FWD_MH = Kernel("sgc_dfa3d_fwd", _FWD_ARGS)  # stage 2 launches (K3)
# ... with bf16 value and bf16 depth (K2', K3')
DFA3D_FWD_S1_BD = Kernel("sgc_dfa3d_fwd", _FWD_ARGS)
DFA3D_FWD_MH_BD = Kernel("sgc_dfa3d_fwd", _FWD_ARGS)
# sgc_dfa3d_bwd(vdtype, ddtype, value, depth, locs, attn, counts, g,
#               d_value, d_depth, d_locs, d_attn,
#               n, h, w, heads, c, dsize, k, p, stream)
_BWD_ARGS = [_I, _I] + [_P] * 10 + [_I] * 8
DFA3D_BWD_MH = Kernel("sgc_dfa3d_bwd", _BWD_ARGS)  # stage 2 launches (K5)
DFA3D_BWD_MH_BD = Kernel("sgc_dfa3d_bwd", _BWD_ARGS)  # ... at bf16 depth (K5')
# sgc_dfa3d_bwd_s1(vdtype, ddtype, value, depth, locs, attn, counts, g,
#                  d_value, d_depth, d_locs, d_attn, scratch,
#                  n, h, w, c, dsize, k, stream)
_BWD_S1_ARGS = [_I, _I] + [_P] * 11 + [_I] * 6
DFA3D_BWD_S1 = Kernel("sgc_dfa3d_bwd_s1", _BWD_S1_ARGS)  # stage 1 launches (K6)
DFA3D_BWD_S1_BD = Kernel("sgc_dfa3d_bwd_s1", _BWD_S1_ARGS)  # ... at bf16 depth (K6')

# elements of one gathered corner tensor per query chunk of the plain version
_PLAIN_CHUNK_ELEMS = 1 << 25


def _count_mask(out, valid_counts, q0):
    """Zero the queries at or past each camera's count (out: (N, Kc, C))."""
    q = torch.arange(q0, q0 + out.shape[1], device=out.device)
    keep = q[None, :] < valid_counts.to(out.device)[:, None]
    return torch.where(keep[..., None], out, 0.0)


def dfa3d_attention_plain(value_img, dpt_img, locs, attn, num_heads,
                          valid_counts=None, remap=None):
    """Plain version.

    value_img: (N, H, W, heads*c); dpt_img: (N, H, W, D);
    locs: (N, K, heads, P, 3) normalized (u, v, d); attn: (N, K, heads, P);
    valid_counts: optional (N,) int — queries at or past it return zeros;
    remap: optional ``(flat, weight, q0) -> (flat, weight)`` applied to each
    corner's pixel indices and bilinear weights (N, Kc, heads, P) of the
    query chunk starting at q0 (the windowed version's window reads).
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
            if remap is not None:
                flat, wb = remap(flat, wb, q0)
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
                    valid_counts=None, sample_grads=True, depth_grad=True,
                    remap=None):
    """Plain version of K5/K6: the VJP of ``dfa3d_attention_plain`` (with
    its ``remap``), recomputed under autograd.  Returns (d_value, d_dpt,
    d_locs, d_attn) in the inputs' dtypes; d_dpt is None unless
    ``depth_grad``, the last two are None unless ``sample_grads``."""
    wanted = (True, depth_grad, sample_grads, sample_grads)
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(want)
               for t, want in zip((value_img, dpt_img, locs, attn), wanted)]
        out = dfa3d_attention_plain(*ins, num_heads, valid_counts, remap)
        grads = iter(torch.autograd.grad(out, [t for t in ins if t.requires_grad], g))
    return tuple(next(grads) if want else None for want in wanted)


def check_dtypes(value_img, dpt_img):
    """The kernels' type pairs: f32 or bf16 value with f32 depth, bf16 value
    with bf16 depth.  f32 value with bf16 depth raises: no TPU kernel or
    model path runs that pair."""
    if dpt_img.dtype == torch.bfloat16 and value_img.dtype != torch.bfloat16:
        raise TypeError(f"bf16 depth is taken with bf16 value only, got value "
                        f"{value_img.dtype}")


def _check(value_img, dpt_img, locs, attn, num_heads, valid_counts):
    """Validated kernel operands and sizes, shared by K2/K3 and K5/K6."""
    dev = value_img.device
    value = check_cuda_input(value_img, "value_img",
                             (torch.float32, torch.bfloat16), 4, dev)
    depth = check_cuda_input(dpt_img, "dpt_img", (torch.float32, torch.bfloat16),
                             4, dev)
    check_dtypes(value, depth)
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


def _pick(kernels, stage1, depth):
    """The launch counter of this call: (stage 1 or multi-head) x (f32 or
    bf16 depth)."""
    return kernels[(not stage1) + 2 * (depth.dtype == torch.bfloat16)]


def _ptr(t):
    return None if t is None else t.data_ptr()


def dfa3d_fwd_cuda(value_img, dpt_img, locs, attn, num_heads,
                   valid_counts=None):
    """Kernels K2/K3 (f32 depth) and K2'/K3' (bf16 depth) on CUDA tensors;
    same contract as the plain version, for the type pairs of
    ``check_dtypes``.  heads = P = 1 counts as a stage-1 launch, anything
    else as stage 2."""
    value, depth, loc, att, counts, stage1, sizes = _check(
        value_img, dpt_img, locs, attn, num_heads, valid_counts)
    n, _, _, heads, c, _, k, _ = sizes
    out = torch.empty((n, k, heads * c), dtype=value.dtype, device=value.device)
    kernel = _pick((DFA3D_FWD_S1, DFA3D_FWD_MH, DFA3D_FWD_S1_BD,
                    DFA3D_FWD_MH_BD), stage1, depth)
    kernel(value.device, DTYPE_CODE[value.dtype], DTYPE_CODE[depth.dtype],
           value.data_ptr(), depth.data_ptr(), loc.data_ptr(), att.data_ptr(),
           _ptr(counts), out.data_ptr(), *sizes)
    return out


# the stage-1 backward's limits (csrc/dfa3d_bwd.cu): the list build counts
# a view's pixels in shared memory (kMaxMapPixels), the long pass the views'
# long lists (kMaxViews), and a long pass's block holds its warps' rows and
# depth sums and a bitmap of the list's queries in the 227 KB of shared
# memory an H100 block may take, less the pass's 8,324 static bytes
S1_MAX_VIEWS = 1024
S1_MAX_MAP_PIXELS = 56 * 1024
S1_LONG_SMEM = 227 * 1024 - 8324


def s1_long_bytes(c, dsize, k):
    """Dynamic shared memory of the stage-1 long pass's block
    (csrc/dfa3d_bwd.cu::launch_s1_passes): 32 warps' f32 rows of c
    channels, their 256 / c groups' f32 depth sums, and the bitmap of k
    queries with a prefix count a word."""
    return 4 * (32 * c + 32 * (256 // c) * dsize + 2 * (-(-k // 32)))


def check_bwd_sizes(stage1, n, h, w, c, dsize, k):
    """Raise ValueError before a backward launch at sizes its kernels do not
    take: multi-head (K5) c other than 32; stage 1 (K6) more than
    ``S1_MAX_VIEWS`` views, a map of more than ``S1_MAX_MAP_PIXELS``
    pixels, or a long pass that needs more than ``S1_LONG_SMEM`` bytes of
    shared memory (``s1_long_bytes``: at c = 256 and 12 bins, k up to
    ~760,000 queries)."""
    if not stage1:
        if c != 32:
            raise ValueError(f"the multi-head backward takes c = 32 per head, got {c}")
        return
    if n > S1_MAX_VIEWS:
        raise ValueError(f"the stage-1 backward takes at most {S1_MAX_VIEWS} views, got {n}")
    if h * w > S1_MAX_MAP_PIXELS:
        raise ValueError(f"the stage-1 backward takes maps of at most {S1_MAX_MAP_PIXELS} "
                         f"pixels, got {h} x {w}")
    need = s1_long_bytes(c, dsize, k)
    if need > S1_LONG_SMEM:
        raise ValueError(f"the stage-1 backward's long pass needs {need} bytes of shared "
                         f"memory at c = {c}, {dsize} bins and k = {k}; a block has "
                         f"{S1_LONG_SMEM}")


def s1_scratch_ints(n, h, w, k):
    """int32 elements of the stage-1 backward's scratch (csrc/dfa3d_bwd.cu::
    S1Scratch): per view an entry record of 8 ints for each of the 4 k
    entries, the list offsets of its pixels (h w + 1), the entries' order
    (4 k), its pixels with a long list (h w) and their count, and a float
    an entry (4 k)."""
    return n * (32 * k + 2 * h * w + 1 + 1 + 8 * k)


def dfa3d_bwd_cuda(value_img, dpt_img, locs, attn, g, num_heads,
                   valid_counts=None, sample_grads=True, depth_grad=True):
    """Kernels K6 (heads = P = 1) / K5 (multi-head), or K6' / K5' at bf16
    depth, on CUDA tensors; same contract as ``dfa3d_bwd_plain``.

    Stage 1 sums each output pixel's gradients where it lives: its kernels
    build per view the list of the (query, corner) entries of each pixel,
    then write every d_value and d_depth row once, at the inputs' dtypes
    (zeros where no counted corner lies), and d_locs and d_attn; the
    scratch is one ``torch.empty``.  It takes at most 1024 views, maps of
    at most 57,344 pixels and k within its long pass's shared memory
    (``check_bwd_sizes``).  Multi-head (c = 32), K5 accumulates d_value by
    16-byte vector atomics into an aligned f32 buffer and d_dpt by scalar
    ones, writes d_locs and d_attn directly, and each is cast once to its
    input's dtype.  Without ``depth_grad`` the kernels skip the depth
    gradient, and without ``sample_grads`` too the value gather and dot
    products."""
    value, depth, loc, att, counts, stage1, sizes = _check(
        value_img, dpt_img, locs, attn, num_heads, valid_counts)
    gg = check_cuda_input(g.to(value.dtype), "g", (value.dtype,), 3, value.device)
    n, h, w, heads, c, dsize, k, _ = sizes
    if gg.shape != (n, k, heads * c):
        raise ValueError(f"g {tuple(gg.shape)} must be {(n, k, heads * c)}")
    check_bwd_sizes(stage1, n, h, w, c, dsize, k)
    f32 = dict(dtype=torch.float32, device=value.device)
    d_locs = torch.empty(loc.shape, **f32) if sample_grads else None
    d_attn = torch.empty(att.shape, **f32) if sample_grads else None
    codes = DTYPE_CODE[value.dtype], DTYPE_CODE[depth.dtype]
    if stage1:
        d_value = torch.empty_like(value)
        d_depth = torch.empty_like(depth) if depth_grad else None
        scratch = torch.empty(s1_scratch_ints(n, h, w, k), dtype=torch.int32,
                              device=value.device)
        kernel = DFA3D_BWD_S1_BD if depth.dtype == torch.bfloat16 else DFA3D_BWD_S1
        kernel(value.device, *codes, value.data_ptr(), depth.data_ptr(),
               loc.data_ptr(), att.data_ptr(), _ptr(counts), gg.data_ptr(),
               d_value.data_ptr(), _ptr(d_depth), _ptr(d_locs), _ptr(d_attn),
               scratch.data_ptr(), n, h, w, c, dsize, k)
    else:
        d_value = zeros_f32(value.shape, value.device)
        d_depth = torch.zeros(depth.shape, **f32) if depth_grad else None
        kernel = DFA3D_BWD_MH_BD if depth.dtype == torch.bfloat16 else DFA3D_BWD_MH
        kernel(value.device, *codes, value.data_ptr(), depth.data_ptr(),
               loc.data_ptr(), att.data_ptr(), _ptr(counts), gg.data_ptr(),
               d_value.data_ptr(), _ptr(d_depth), _ptr(d_locs), _ptr(d_attn), *sizes)
    return tuple(None if grad is None else grad.to(inp.dtype) for grad, inp in
                 zip((d_value, d_depth, d_locs, d_attn),
                     (value_img, dpt_img, locs, attn)))


class _DFA3D(torch.autograd.Function):
    """K2/K3 (K2'/K3') forward with K6/K5 (K6'/K5') backward on the card;
    the plain version and its VJP on the CPU.  The route is fixed in the
    forward (the autograd engine does not see ``plain_ops()``).  Location
    and attention gradients are computed only where autograd asks for them
    (stage 1's locations are fixed voxel centres and its attention is 1),
    and so is the depth gradient (the 2D path's uniform depth is a
    constant)."""

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
                    valid_counts, sample_grads=sample_grads,
                    depth_grad=ctx.needs_input_grad[1])
        return (*grads, None, None)


def dfa3d_attend(value_img, dpt_img, locs, attn, num_heads, valid_counts=None):
    """Fused DFA3D sampling, differentiable in value, depth, locations and
    attention: kernels for CUDA tensors, plain versions for CPU tensors (see
    ``dfa3d_attention_plain`` for the contract and ``check_dtypes`` for the
    type pairs)."""
    check_dtypes(value_img, dpt_img)
    return _DFA3D.apply(value_img, dpt_img, locs, attn, valid_counts, num_heads)


def msda_2d_attend(value_img_list, sampling_locations, attention_weights,
                   num_heads):
    """2D multi-scale deformable attention (mmcv ``ms_deform_attn``
    semantics) as DFA3D with a uniform depth: per level a 2-bin depth of
    ones in the value dtype, sampled at d = 0.5, where the two lerp weights
    are 1/2 each, so every in-image corner's depth score is exactly 1.
    Counterpart of sgcdet_tpu/ops/dfa3d.py::msda_2d_attend
    (dfa3d_fast.py::msda_2d_fast routed through the DFA3D dispatcher).

    value_img_list: per level (N, H_l, W_l, heads*c); sampling_locations:
    (N, K, heads, L, P, 2) normalized (u, v); attention_weights:
    (N, K, heads, L, P).  Returns (N, K, heads*c) in the value dtype."""
    out = None
    for lvl, vimg in enumerate(value_img_list):
        locs = sampling_locations[:, :, :, lvl]
        locs3 = torch.cat([locs, torch.full_like(locs[..., :1], 0.5)], -1)
        ones = torch.ones(vimg.shape[:-1] + (2,), dtype=vimg.dtype,
                          device=vimg.device)
        o = dfa3d_attend(vimg, ones, locs3, attention_weights[:, :, :, lvl],
                         num_heads)
        out = o if out is None else out + o
    return out
