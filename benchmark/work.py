"""The yardstick of the kernels' rooflines: the bytes and operations that a
DFA3D or sweep call needs, and the least time the card could take for
them (a frozen copy of the arithmetic that the port's ``chip_smoke.py``
uses for its kernel table: ``nbytes``, ``bound``, ``touched_rows``,
``dfa3d_work``, ``sweep_work``), and ``WorkLog``, which the reference's ops
feed with their operands at the dtypes that the configuration runs.

Peaks: one NVIDIA H100 SXM's 3.35 TB/s of HBM and 67 TFLOP/s of float32
outside the tensor cores (the kernels compute in f32), and 989 TFLOP/s of
dense bf16 for the whole step's model FLOPs utilization."""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12


def nbytes(t, frac=1.0):
    return t.numel() * t.element_size() * frac


def bound(byte_count, flops):
    """The least time the card could take (ms) and what sets it: the bytes
    each input is read once and each output written once over the HBM rate,
    or the operations over the f32 rate."""
    t_bytes = byte_count / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def touched_rows(locs, counts, h, w, dsize):
    """Distinct (view, pixel, head) value rows and distinct (view, pixel,
    bin) depth elements that the in-image corners of this run's samples
    read: per corner the two bins of the depth lerp that lie in range (the
    rows past each view's count read nothing; NaN lands off the image and
    off the depth range, as in the kernels)."""
    n, k, heads = locs.shape[:3]
    dev = locs.device

    def cell(coord, size):
        return (coord * size - 0.5).nan_to_num(nan=-4.0).clamp(-4, size + 4).floor().long()

    x, y, d = cell(locs[..., 0], w), cell(locs[..., 1], h), cell(locs[..., 2], dsize)
    live = torch.ones(locs.shape[:4], dtype=torch.bool, device=dev)
    if counts is not None:
        q = torch.arange(k, device=dev)
        live = live & (q[None, :, None, None] < counts[:, None, None, None])
    cam = torch.arange(n, device=dev).view(n, 1, 1, 1)
    head = torch.arange(heads, device=dev).view(1, 1, heads, 1).expand_as(live)
    rows, bins = [], []
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x + dx, y + dy
            ok = live & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            pix = (cam * h + yi) * w + xi
            rows.append(pix[ok] * heads + head[ok])
            for di in (d, d + 1):
                ok_d = ok & (di >= 0) & (di < dsize)
                bins.append(pix[ok_d] * dsize + di[ok_d])
    return torch.cat(rows).unique().numel(), torch.cat(bins).unique().numel()


def dfa3d_work(args, outs, counts, backward, dot=True):
    """Bytes and flops of one DFA3D call on ``args`` = (value, depth, locs,
    attn[, g]) with outputs ``outs``: the value rows and depth bins the
    run's samples touch, the per-query operands and the FMAs (2 flops) of
    the rows its counts let through, every output.  Per (query, head,
    point, corner, channel) the forward does one FMA, the backward a
    d_value update and, where it needs the dot product <g, value row> for
    the sample or depth gradients (``dot``), one FMA of it; a backward
    without ``dot`` reads no value row."""
    value, depth, locs = args[:3]
    n, h, w, cfull = value.shape
    k, heads, p = locs.shape[1:4]
    c = cfull // heads
    frac = 1.0 if counts is None else float(counts.clamp(max=k).sum()) / (n * k)
    value_rows, depth_elems = touched_rows(locs, counts, h, w, depth.shape[-1])
    reads_value = dot or not backward
    byte_count = ((value_rows * c * value.element_size() if reads_value else 0)
                  + depth_elems * depth.element_size())
    byte_count += sum(nbytes(t, frac) for t in args[2:])  # locs, attn, g
    byte_count += sum(nbytes(t) for t in outs if t is not None)
    fmas = 1 + (backward and dot)
    flops = n * k * frac * heads * p * 4 * c * 2 * fmas
    return byte_count, flops


def sweep_work(args, outs, backward):
    """Bytes and flops of one sweep call on (src, ref, x, y[, g]): per
    (view, plane, pixel) four C-channel corner FMAs and a C-channel dot
    product (10 C flops); the backward recomputes the sample, scatters four
    corner updates and sums the reference gradient (18 C flops)."""
    c = args[0].shape[-1]
    samples = args[2].numel()
    byte_count = sum(nbytes(t) for t in args) + sum(nbytes(t) for t in outs)
    return byte_count, samples * c * (18 if backward else 10)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


class WorkLog:
    """Collects the bound (ms) and the flops of every DFA3D and sweep call
    that the reference makes, counted at the program's dtypes: value and
    features in ``compute`` (bf16 or f32), depth, locations, attention and
    the sweep's coordinates and output in f32.  With ``backward`` each call
    counts its backward too (the value, depth, location and attention
    gradients of a stage-2 call; value and depth only at stage 1, whose
    locations are fixed; both feature gradients of the sweep)."""

    def __init__(self, compute: torch.dtype, backward: bool):
        self.compute, self.backward = compute, backward
        self.ms = {"dfa3d": 0.0, "sweep": 0.0}
        self.flops = {"dfa3d": 0.0, "sweep": 0.0}

    def _add(self, kind, work):
        self.ms[kind] += bound(*work)[0]
        self.flops[kind] += work[1]

    @torch.no_grad()
    def dfa3d(self, value, depth, cam, locs, attn):
        """One call on flat (camera, query) pairs, laid out per camera as the
        program lays it out: each camera's seen queries first, padded to the
        most any camera sees, ``counts`` the seen ones."""
        n = value.shape[0]
        if cam.numel() == 0:
            return
        counts = torch.bincount(cam, minlength=n)
        kmax = int(counts.max())
        if kmax == 0:
            return
        order = torch.argsort(cam, stable=True)
        start = torch.cumsum(counts, 0) - counts
        slot = torch.arange(cam.numel(), device=cam.device) - start[cam[order]]
        grid = torch.zeros((n, kmax) + tuple(locs.shape[1:]), dtype=torch.float32,
                           device=locs.device)
        grid[cam[order], slot] = locs[order].float()
        heads, p = locs.shape[1], locs.shape[2]
        cfull = value.shape[-1]
        v = _meta(value.shape, self.compute)
        d = _meta(depth.shape, torch.float32)
        a = _meta((n, kmax, heads, p), torch.float32)
        out = _meta((n, kmax, cfull), self.compute)
        self._add("dfa3d", dfa3d_work((v, d, grid, a), (out,), counts, False))
        if self.backward:
            stage1 = heads == 1 and p == 1
            grads = (v, d) if stage1 else (v, d, _meta(grid.shape, torch.float32), a)
            self._add("dfa3d", dfa3d_work((v, d, grid, a, out), grads, counts, True))

    @torch.no_grad()
    def sweep(self, src, ref, x, y):
        s = _meta(src.shape, self.compute)
        xe, ye = _meta(x.shape, torch.float32), _meta(y.shape, torch.float32)
        out = _meta(x.shape, torch.float32)
        self._add("sweep", sweep_work((s, s, xe, ye), (out,), False))
        if self.backward:
            self._add("sweep", sweep_work((s, s, xe, ye, out), (s, s), True))
