"""Windowed DFA3D sampling for spatially sorted queries — counterpart of the
windowed TPU kernels of experiments/dfa3d_pallas4.py (``_fwd_kernel_w``,
``_fwd_kernel_w_s1``, ``_fwd_kernel_wh``, ``_bwd_kernel_wh``) and
experiments/dfa3d_pallas5.py (``_fwd_kernel_ws``, ``_bwd_kernel_ws``).

``dfa3d_attention_pallas_w`` (forward only, dfa3d_pallas4.py:323),
``dfa3d_attention_pallas_wh`` (:636, VJP :703) and
``dfa3d_attention_pallas_ws`` (dfa3d_pallas5.py:467, VJP :540) are one
function: ``dfa3d_attention_plain``'s.  They differ only in how a TPU, which
has no gather, moves the rows: a one-hot selection matrix per chunk of
samples, multiplied on the MXU with a window of image rows.  What carries
over to Hopper is the idea.  With ``sort_queries`` each camera's compacted
queries are ordered by their projected pixel, so the samples of a chunk of
consecutive queries fall in a narrow band of pixels ``y * W + x``.  The
multi-head kernels take a chunk's heads in one block, whose window is the
union of its heads' bands, and run the templates' warps (K3, K5) with the
window in shared memory: the forward stages the window's depth bins, the
backward sums its ``d_depth`` there and adds it back by 16-byte
reductions.  Stage 1 (heads = P = 1) is the templates' K2 and K6
(``ops/dfa3d.py``): its chunks' unions span more pixels than their
corners read, so a window would stage more than it saves.

* ``plan_windows`` — counterpart of ``_chunk_meta`` (dfa3d_pallas4.py:83-96)
  and ``_ws_prep`` (dfa3d_pallas5.py:80-120): per (view, chunk of ``qc``
  consecutive queries) the window base (the lowest pixel a live corner of
  the chunk reads, over every head and point), its span and the ``ok``
  flag (every live corner lies in ``[base, base + wwin)``).  A live corner
  is an in-image corner of a query inside ``valid_counts``, whatever its
  weight: the kernels read it.  The kernels find the same windows
  themselves, each block over its own chunk (csrc/common.cuh::
  union_window); these torch ops serve the plain version and reports.
  ``window_length`` is the most pixels a kernel's window holds, from the
  shared memory a pixel takes (``window_bytes``, the kernels' reservation).
* ``dfa3d_windowed_plain`` / ``dfa3d_windowed_bwd_plain`` — the plain
  version: ``ok`` chunks read their corners from their window only (an
  index relative to the window, clipped into it, and a zero weight for a
  corner outside it), other chunks from the whole map.  A planning fault
  therefore shows up on the CPU as a wrong number.
* ``dfa3d_win_fwd_cuda`` (counters ``dfa3d_win_fwd_mh``, and
  ``dfa3d_win_fwd_mh_c16`` at c = 16) and ``dfa3d_win_bwd_cuda``
  (``dfa3d_win_bwd_mh``, ``dfa3d_win_bwd_mh_c16``) — the kernels of
  csrc/dfa3d_win_fwd.cu and csrc/dfa3d_win_bwd.cu (``win_counter`` names
  an instance's counter; ``win_fwd_launch`` / ``win_bwd_launch`` are the
  same launches at a chosen chunk length, for timing); ``kernel_resources``
  reads their registers, spills, shared memory and blocks an SM.
* ``dfa3d_attention_windowed`` — the differentiable op of the sorted path.
  Stage 1 goes to ``dfa3d_attend`` (K2 forward, K6 backward); on the TPU
  too the windowed stage 1 has no VJP and the sorted path takes
  ``pallas_c``'s.

Type pairs and counted zeros are those of ``ops/dfa3d.py``
(``check_dtypes``); ``c`` is 16, 32 or 256 per head (``WIN_FWD_WIDTHS``),
the backward 16 or 32 (``WIN_BWD_WIDTHS``): the ScanNet widths and the -L
configs' 16 at stage 2 (their stage 1, c = 128, is K2's and K6's).  Any
other width raises before any launch.  At c = 16 a warp takes two whole
queries of a chunk, as K3 and K5 do.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._cuda import DTYPE_CODE, LIBRARY, Kernel, check_cuda_input, use_kernel, zeros_f32
from .dfa3d import (
    _check,
    _ptr,
    check_dtypes,
    dfa3d_attend,
    dfa3d_attention_plain,
    dfa3d_bwd_plain,
)
from .sampling import clip_coord

# value channels of a head the windowed kernels are built for: the forward
# (csrc/dfa3d_win_fwd.cu) and the backward (csrc/dfa3d_win_bwd.cu)
WIN_FWD_WIDTHS = (16, 32, 256)
WIN_BWD_WIDTHS = (16, 32)
# the queries of a block's chunk (over all heads), by c a head: the
# forward's and the backward's.  At c = 16 a warp takes two queries, and a
# chunk's union window spans ~740 pixels at the sorted -L level 2 whatever
# its length (the heads' offsets set it), so longer chunks stage each
# window for more work: 64 and 32 queries ran 0.90x and 0.77x K3 and K5
# where 16 and 8 ran 1.32x and 1.15x (PERF.md, chip_smoke.py::
# chunk_sweep); a window of at most WIN_CAP pixels, above the 90th percentile of the unions' spans at the sorted
# level 2, holds the depth bins in f32 (forward) or their f32 d_depth sums
# (backward), 54 KB, in at most SMEM_MH bytes: depth bins, not channels,
# so the window is the same at every c
QC_FWD = {16: 64, 32: 16, 256: 16}
QC_BWD = {16: 32, 32: 8}
WIN_CAP = 1152
SMEM_MH = 56 * 1024


def chunk_length(c, backward=False):
    """The queries of a block's chunk at c a head (``QC_FWD`` / ``QC_BWD``);
    a width no kernel is built for, which only the plain versions take,
    gets c = 32's."""
    table = QC_BWD if backward else QC_FWD
    return table.get(c, table[32])

_P, _I = ctypes.c_void_p, ctypes.c_int
# sgc_dfa3d_win_fwd(vdtype, ddtype, value, depth, locs, attn, counts, out,
#                   n, h, w, heads, c, dsize, k, p, qc, wwin, stream)
_FWD_ARGS = [_I, _I] + [_P] * 6 + [_I] * 10
DFA3D_WIN_FWD_MH = Kernel("sgc_dfa3d_win_fwd", _FWD_ARGS)
# sgc_dfa3d_win_bwd(vdtype, ddtype, value, depth, locs, attn, counts, g,
#                   d_value, d_depth, d_locs, d_attn,
#                   n, h, w, heads, c, dsize, k, p, qc, wwin, stream)
_BWD_ARGS = [_I, _I] + [_P] * 10 + [_I] * 10
DFA3D_WIN_BWD_MH = Kernel("sgc_dfa3d_win_bwd", _BWD_ARGS)
# the instances at c = 16 (the sorted -L path) count their launches apart
DFA3D_WIN_FWD_MH_C16 = Kernel("sgc_dfa3d_win_fwd", _FWD_ARGS)
DFA3D_WIN_BWD_MH_C16 = Kernel("sgc_dfa3d_win_bwd", _BWD_ARGS)


def win_counter(backward, c):
    """The name of the launch counter of the windowed instance at c a head:
    ``dfa3d_win_{fwd,bwd}_mh``, with ``_c16`` at c = 16."""
    return f"dfa3d_win_{'bwd' if backward else 'fwd'}_mh" + ("_c16" if c == 16 else "")


WIN_COUNTERS = {"dfa3d_win_fwd_mh": DFA3D_WIN_FWD_MH,
                "dfa3d_win_fwd_mh_c16": DFA3D_WIN_FWD_MH_C16,
                "dfa3d_win_bwd_mh": DFA3D_WIN_BWD_MH,
                "dfa3d_win_bwd_mh_c16": DFA3D_WIN_BWD_MH_C16}


class WindowPlan(NamedTuple):
    """Per (view, chunk of ``qc`` queries), each (N, nchunk): the window's
    first pixel ``base`` and its length ``span`` (int32, 0 where the chunk
    has no live corner), and ``ok`` (bool): every live corner of every head
    lies in ``[base, base + span)`` with ``span <= wwin``."""
    base: torch.Tensor
    span: torch.Tensor
    ok: torch.Tensor
    qc: int
    wwin: int


def window_bytes(wwin, value_img, dpt_img, backward=False, depth_grad=True):
    """The dynamic shared memory a windowed kernel's block reserves for a
    window of ``wwin`` pixels (csrc/dfa3d_win_fwd.cu::window_smem,
    dfa3d_win_bwd.cu::bwd_smem): the forward the depth bins in f32; the
    backward, with ``depth_grad``, the bins' f32 d_depth sums.
    Neither ``value_img`` nor its c changes it: every window holds 4 bytes
    a bin."""
    d = dpt_img.shape[-1]
    return 0 if backward and not depth_grad else 4 * wwin * d


def window_length(value_img, dpt_img, backward=False, depth_grad=True):
    """The most pixels a windowed kernel's window holds on these operands
    (the ``wwin`` it is launched with): at most ``WIN_CAP``, the whole map
    where it is smaller, and what the kernel's shared memory budget allows
    at ``window_bytes`` a window; 0 for a backward without ``depth_grad``,
    whose window would hold nothing.  The same at every c."""
    if backward and not depth_grad:
        return 0
    h, w = value_img.shape[1:3]
    per_pixel = window_bytes(1, value_img, dpt_img, backward, depth_grad)
    return max(1, min(h * w, WIN_CAP, SMEM_MH // per_pixel))


def kernel_plan(value_img, dpt_img, locs, valid_counts, backward=False,
                depth_grad=True):
    """The windows a windowed kernel finds on these operands (each block
    computes its own), for the plain version and for reports."""
    h, w = value_img.shape[1:3]
    wwin = window_length(value_img, dpt_img, backward, depth_grad)
    qc = chunk_length(value_img.shape[-1] // locs.shape[2], backward)
    return plan_windows(locs, counts=valid_counts, h=h, w=w, wwin=wwin, qc=qc)


def plan_windows(locs, counts, h, w, wwin, qc):
    """The windows of one call, per (view, chunk of ``qc`` queries): a block
    takes every head of its chunk, so its window is the union of its heads'
    bands.  locs: (N, K, heads, P, 3) normalized; counts: (N,) visible-query
    counts or None; (h, w): the map.  Pixel coordinates are computed as the
    kernels do (loc * size - 0.5, clipped to [-4, size + 4], NaN to -4,
    then floor), so plan and kernel agree on every corner."""
    n, k = locs.shape[:2]
    dev = locs.device
    x0 = torch.floor(clip_coord(locs[..., 0].float() * w - 0.5, w)).int()
    y0 = torch.floor(clip_coord(locs[..., 1].float() * h - 0.5, h)).int()
    # a sample's in-image corners fill the box [xlo, xhi] x [ylo, yhi], so
    # its lowest and highest pixels are its (ylo, xlo) and (yhi, xhi)
    xlo, xhi = x0.clamp(min=0), (x0 + 1).clamp(max=w - 1)
    ylo, yhi = y0.clamp(min=0), (y0 + 1).clamp(max=h - 1)
    live = (xlo <= xhi) & (ylo <= yhi)
    if counts is not None:
        live &= (torch.arange(k, device=dev) < counts.to(dev)[:, None])[:, :, None, None]
    big = h * w
    lo = torch.where(live, ylo * w + xlo, big).flatten(2).amin(-1)  # (N, K)
    hi = torch.where(live, yhi * w + xhi, -1).flatten(2).amax(-1)
    nchunk = -(-k // qc)
    pad = (0, nchunk * qc - k)
    lo = torch.nn.functional.pad(lo, pad, value=big).view(n, nchunk, qc).amin(2)
    hi = torch.nn.functional.pad(hi, pad, value=-1).view(n, nchunk, qc).amax(2)
    empty = hi < 0
    base = torch.where(empty, 0, lo)
    span = torch.where(empty, 0, hi - lo + 1)
    return WindowPlan(base, span, span <= wwin, qc, wwin)


def window_remap(plan):
    """``dfa3d_attention_plain``'s corner remap for ``plan``: a corner of an
    ``ok`` chunk is read from its window, at its index relative to the base
    clipped into the window, and weighs zero if it lies outside it."""
    def remap(flat, wb, q0):
        kc = flat.shape[1]
        chunk = torch.arange(q0, q0 + kc, device=flat.device) // plan.qc
        base, span, ok = (t.to(flat.device)[:, chunk, None, None]  # (N, Kc, 1, 1)
                          for t in (plan.base.long(), plan.span.long(), plan.ok))
        rel = flat - base
        inside = (rel >= 0) & (rel < span)
        in_window = base + torch.minimum(rel.clamp(min=0), (span - 1).clamp(min=0))
        return (torch.where(ok, in_window, flat),
                torch.where(ok & ~inside, 0.0, wb))
    return remap


def dfa3d_windowed_plain(value_img, dpt_img, locs, attn, num_heads,
                         valid_counts=None, plan=None):
    """Plain version of the windowed forward, with ``plan`` (by default the
    forward kernels' own); the contract of ``dfa3d_attention_plain``."""
    if plan is None:
        plan = kernel_plan(value_img, dpt_img, locs, valid_counts)
    return dfa3d_attention_plain(value_img, dpt_img, locs, attn, num_heads,
                                 valid_counts, remap=window_remap(plan))


def dfa3d_windowed_bwd_plain(value_img, dpt_img, locs, attn, g, num_heads,
                             valid_counts=None, sample_grads=True,
                             depth_grad=True, plan=None):
    """Plain version of the windowed backward: the VJP of
    ``dfa3d_windowed_plain`` with ``plan`` (by default the backward kernel's
    own); the contract of ``dfa3d_bwd_plain``."""
    if plan is None:
        plan = kernel_plan(value_img, dpt_img, locs, valid_counts, True, depth_grad)
    return dfa3d_bwd_plain(value_img, dpt_img, locs, attn, g, num_heads,
                           valid_counts, sample_grads, depth_grad,
                           remap=window_remap(plan))


def dfa3d_win_fwd_cuda(value_img, dpt_img, locs, attn, num_heads,
                       valid_counts=None):
    """The windowed forward kernel on CUDA tensors; same contract as the
    plain version, whose windows are the kernels' own (``kernel_plan``)."""
    return win_fwd_launch(value_img, dpt_img, locs, attn, num_heads, valid_counts)


def win_fwd_launch(value_img, dpt_img, locs, attn, num_heads, valid_counts, qc=None):
    """``dfa3d_win_fwd_cuda`` with chunks of ``qc`` queries (None: the
    kernel's own, ``chunk_length``), so that a timing script can try other
    lengths; the plain version takes the same chunks through ``plan``."""
    value, depth, loc, att, counts, _, sizes = _check(
        value_img, dpt_img, locs, attn, num_heads, valid_counts)
    n, _, _, heads, c, _, k, _ = sizes
    if c not in WIN_FWD_WIDTHS:
        raise ValueError(f"the windowed forward takes c in {WIN_FWD_WIDTHS} per head, got {c}")
    out = torch.empty((n, k, heads * c), dtype=value.dtype, device=value.device)
    WIN_COUNTERS[win_counter(False, c)](value.device, DTYPE_CODE[value.dtype], DTYPE_CODE[depth.dtype],
                     value.data_ptr(), depth.data_ptr(), loc.data_ptr(), att.data_ptr(),
                     _ptr(counts), out.data_ptr(), *sizes, qc or chunk_length(c),
                     window_length(value, depth))
    return out


def dfa3d_win_bwd_cuda(value_img, dpt_img, locs, attn, g, num_heads,
                       valid_counts=None, sample_grads=True, depth_grad=True):
    """The windowed multi-head backward kernel on CUDA tensors (c = 16 or
    32 per head); same contract as ``dfa3d_bwd_cuda``.  Every gradient is
    summed in f32 and cast once to its input's dtype."""
    return win_bwd_launch(value_img, dpt_img, locs, attn, g, num_heads, valid_counts,
                          sample_grads, depth_grad)


def win_bwd_launch(value_img, dpt_img, locs, attn, g, num_heads, valid_counts,
                   sample_grads=True, depth_grad=True, qc=None):
    """``dfa3d_win_bwd_cuda`` with chunks of ``qc`` queries (None: the
    kernel's own), as ``win_fwd_launch``."""
    value, depth, loc, att, counts, _, sizes = _check(
        value_img, dpt_img, locs, attn, num_heads, valid_counts)
    n, h, w, heads, c, dsize, k, p = sizes
    if c not in WIN_BWD_WIDTHS:
        raise ValueError(f"the windowed backward takes c in {WIN_BWD_WIDTHS} per head, "
                         f"got {c}")
    gg = check_cuda_input(g.to(value.dtype), "g", (value.dtype,), 3, value.device)
    if gg.shape != (n, k, heads * c):
        raise ValueError(f"g {tuple(gg.shape)} must be {(n, k, heads * c)}")
    wwin = window_length(value, depth, True, depth_grad)
    f32 = dict(dtype=torch.float32, device=value.device)
    d_value = zeros_f32(value.shape, value.device)
    d_depth = zeros_f32(depth.shape, value.device) if depth_grad else None
    d_locs = torch.empty(loc.shape, **f32) if sample_grads else None
    d_attn = torch.empty(att.shape, **f32) if sample_grads else None
    WIN_COUNTERS[win_counter(True, c)](
        value.device, DTYPE_CODE[value.dtype], DTYPE_CODE[depth.dtype],
        value.data_ptr(), depth.data_ptr(), loc.data_ptr(), att.data_ptr(),
        _ptr(counts), gg.data_ptr(), d_value.data_ptr(), _ptr(d_depth),
        _ptr(d_locs), _ptr(d_attn), n, h, w, heads, c, dsize, k, p,
        qc or chunk_length(c, True), wwin)
    return tuple(None if grad is None else grad.to(inp.dtype) for grad, inp in
                 zip((d_value, d_depth, d_locs, d_attn),
                     (value_img, dpt_img, locs, attn)))


RESOURCE_KEYS = ("registers", "spill_bytes", "smem_bytes", "blocks_per_sm", "threads")


def kernel_resources(backward, value_dtype, depth_dtype, dsize, wwin, c=32,
                     depth_grad=True):
    """Registers and local (spill) bytes a thread, shared memory bytes a
    block and blocks an SM of the windowed forward, or with ``backward``
    the windowed backward (with every gradient, or without d_depth), at
    these types, c a head, bins and window length, as the CUDA runtime
    reports them.  Launches nothing."""
    out = (ctypes.c_int * len(RESOURCE_KEYS))()
    types = DTYPE_CODE[value_dtype], DTYPE_CODE[depth_dtype]
    if backward:
        fn = LIBRARY.get().sgc_dfa3d_win_bwd_attributes
        args = (c, 1, int(depth_grad), dsize, wwin)
    else:
        fn = LIBRARY.get().sgc_dfa3d_win_fwd_attributes
        args = (c, dsize, wwin)
    fn.argtypes, fn.restype = [_I] * (2 + len(args)) + [_P], _I
    err = fn(*types, *args, out)
    if err:
        raise RuntimeError(f"{win_counter(backward, c)}: kernel attributes failed with "
                           f"CUDA error {err}")
    return dict(zip(RESOURCE_KEYS, out))


class _DFA3DWindowed(torch.autograd.Function):
    """The windowed multi-head forward and backward on the card; the plain
    versions and their VJPs on the CPU.  The route is fixed in the forward,
    as in ``ops/dfa3d.py``."""

    @staticmethod
    def forward(ctx, value_img, dpt_img, locs, attn, valid_counts, num_heads):
        ctx.kernel = use_kernel(value_img)
        ctx.num_heads = num_heads
        ctx.save_for_backward(value_img, dpt_img, locs, attn, valid_counts)
        fwd = dfa3d_win_fwd_cuda if ctx.kernel else dfa3d_windowed_plain
        return fwd(value_img, dpt_img, locs, attn, num_heads, valid_counts)

    @staticmethod
    def backward(ctx, g):
        value_img, dpt_img, locs, attn, valid_counts = ctx.saved_tensors
        bwd = dfa3d_win_bwd_cuda if ctx.kernel else dfa3d_windowed_bwd_plain
        sample_grads = ctx.needs_input_grad[2] or ctx.needs_input_grad[3]
        grads = bwd(value_img, dpt_img, locs, attn, g, ctx.num_heads,
                    valid_counts, sample_grads=sample_grads,
                    depth_grad=ctx.needs_input_grad[1])
        return (*grads, None, None)


def dfa3d_attention_windowed(value_img, dpt_img, locs, attn, num_heads,
                             valid_counts=None):
    """DFA3D sampling through the windowed kernels (the ``sort_queries``
    path), differentiable in value, depth, locations and attention: the
    function of ``dfa3d_attention_plain`` (``ops/dfa3d.py``), which is
    also that of the TPU's ``dfa3d_attention_pallas_w`` (forward only),
    ``dfa3d_attention_pallas_wh`` and ``dfa3d_attention_pallas_ws``.  It is
    exact for any query order; sorted queries keep more chunks in their
    window.  Stage 1 (heads = P = 1) is ``dfa3d_attend``'s: K2 and K6."""
    if num_heads == 1 and locs.shape[3] == 1:
        return dfa3d_attend(value_img, dpt_img, locs, attn, num_heads, valid_counts)
    check_dtypes(value_img, dpt_img)
    return _DFA3DWindowed.apply(value_img, dpt_img, locs, attn, valid_counts,
                                num_heads)
