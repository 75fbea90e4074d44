"""Plain sampling ops of the reference, float32, with backward passes that
recompute one chunk at a time so that a 40-view training step fits.

Conventions (those of the published model's CUDA ops): pixel = loc * size
- 0.5, zero padding per bilinear corner, coordinates clipped to
[-4, size + 4] before ``floor`` (NaN sent to -4, off the map), the depth
distribution linearly interpolated along d at each corner.

* ``dfa3d`` — depth-weighted deformable attention over a flat list of
  (camera, query) pairs: only the pairs that a camera sees are computed.
* ``sweep`` — the plane-sweep warp and dot-product correlation of the
  depth net, one depth plane at a time.

``WorkLog`` (optional) receives every call's operands, so that the
benchmark can count the kernels' bytes and operations on the reference's
own locations."""
from __future__ import annotations

import math

import torch

# elements of one gathered corner tensor a chunk
CHUNK_ELEMS = 1 << 25


def _clip(x, size):
    return torch.where(torch.isnan(x), -4.0, x).clamp(-4.0, size + 4.0)


def _corners(x, y, h, w):
    """Four bilinear corners: (flat pixel index clamped into the map, weight
    zero off the map)."""
    x, y = _clip(x, w), _clip(y, h)
    x0f, y0f = torch.floor(x), torch.floor(y)
    lx, ly = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()
    out = []
    for dy in (0, 1):
        for dx in (0, 1):
            yi, xi = y0 + dy, x0 + dx
            inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            wgt = (ly if dy else 1 - ly) * (lx if dx else 1 - lx)
            out.append((yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1),
                        torch.where(inside, wgt, 0.0)))
    return out


def _dfa3d_chunk(table, depth, cam, locs, attn, h, w, heads):
    """table: (N*H*W*heads, c) f32 value rows; depth: (N*H*W, D) f32;
    cam: (M,) camera of each pair; locs: (M, heads, P, 3); attn:
    (M, heads, P).  Returns (M, heads*c)."""
    m, _, p, _ = locs.shape
    dsize = depth.shape[1]
    c = table.shape[1]
    dd = _clip(locs[..., 2] * dsize - 0.5, dsize)
    d0f = torch.floor(dd)
    ld = dd - d0f
    d0 = d0f.long()
    wd0 = torch.where((d0 >= 0) & (d0 < dsize), 1 - ld, 0.0)
    wd1 = torch.where((d0 + 1 >= 0) & (d0 + 1 < dsize), ld, 0.0)
    d0c, d1c = d0.clamp(0, dsize - 1), (d0 + 1).clamp(0, dsize - 1)
    base = (cam * (h * w)).view(m, 1, 1)
    head = torch.arange(heads, device=locs.device).view(1, heads, 1)
    acc = 0.0
    for flat, wb in _corners(locs[..., 0] * w - 0.5, locs[..., 1] * h - 0.5, h, w):
        pix = base + flat
        drow = depth[pix.reshape(-1)].reshape(m, heads, p, dsize)
        ds = (torch.gather(drow, 3, d0c[..., None])[..., 0] * wd0
              + torch.gather(drow, 3, d1c[..., None])[..., 0] * wd1)
        rows = table[(pix * heads + head).reshape(-1)].reshape(m, heads, p, c)
        acc = acc + (wb * attn * ds)[..., None] * rows
    return acc.sum(2).reshape(m, heads * c)


def _chunk_len(heads, p, c):
    return max(1, CHUNK_ELEMS // max(1, heads * p * c))


class _DFA3D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, depth, cam, locs, attn, heads):
        ctx.heads = heads
        ctx.save_for_backward(value, depth, cam, locs, attn)
        n, h, w, cfull = value.shape
        table = value.reshape(n * h * w * heads, cfull // heads).float()
        dep = depth.reshape(n * h * w, -1).float()
        step = _chunk_len(heads, locs.shape[2], cfull // heads)
        outs = [_dfa3d_chunk(table, dep, cam[i:i + step], locs[i:i + step].float(),
                             attn[i:i + step].float(), h, w, heads)
                for i in range(0, locs.shape[0], step)]
        return torch.cat(outs, 0) if outs else value.new_zeros((0, cfull))

    @staticmethod
    def backward(ctx, g):
        value, depth, cam, locs, attn = ctx.saved_tensors
        heads = ctx.heads
        n, h, w, cfull = value.shape
        want = ctx.needs_input_grad
        table = value.detach().reshape(n * h * w * heads, cfull // heads).float()
        dep = depth.detach().reshape(n * h * w, -1).float()
        d_table = torch.zeros_like(table) if want[0] else None
        d_dep = torch.zeros_like(dep) if want[1] else None
        d_locs = torch.zeros_like(locs, dtype=torch.float32) if want[3] else None
        d_attn = torch.zeros_like(attn, dtype=torch.float32) if want[4] else None
        step = _chunk_len(heads, locs.shape[2], cfull // heads)
        for i in range(0, locs.shape[0], step):
            with torch.enable_grad():
                ins = [table.requires_grad_(want[0]), dep.requires_grad_(want[1]),
                       locs[i:i + step].detach().float().requires_grad_(want[3]),
                       attn[i:i + step].detach().float().requires_grad_(want[4])]
                out = _dfa3d_chunk(ins[0], ins[1], cam[i:i + step], ins[2], ins[3],
                                   h, w, heads)
                live = [t for t in ins if t.requires_grad]
                grads = iter(torch.autograd.grad(out, live, g[i:i + step].float()))
            for t, acc, sl in ((ins[0], d_table, None), (ins[1], d_dep, None),
                               (ins[2], d_locs, slice(i, i + step)),
                               (ins[3], d_attn, slice(i, i + step))):
                if t.requires_grad:
                    gr = next(grads)
                    if sl is None:
                        acc += gr
                    else:
                        acc[sl] = gr
        return (None if d_table is None else d_table.reshape(value.shape).to(value.dtype),
                None if d_dep is None else d_dep.reshape(depth.shape).to(depth.dtype),
                None, d_locs, d_attn, None)


def dfa3d(value, depth, cam, locs, attn, heads, log=None):
    """Depth-weighted deformable attention of (camera, query) pairs.

    value: (N, H, W, heads*c); depth: (N, H, W, D) distributions;
    cam: (M,) int64 camera of each pair; locs: (M, heads, P, 3) normalized
    (u, v, d); attn: (M, heads, P).  Returns (M, heads*c) f32,
    differentiable in value, depth, locs and attn."""
    if log is not None:
        log.dfa3d(value, depth, cam, locs, attn)
    return _DFA3D.apply(value, depth, cam, locs, attn, heads)


def _sweep_plane(src, ref, x, y, h, w):
    """src, ref: (N, H*W, C) f32; x, y: (N, H*W).  Returns (N, H*W)."""
    warped = 0.0
    for flat, wgt in _corners(x, y, h, w):
        rows = torch.gather(src, 1, flat[..., None].expand(-1, -1, src.shape[-1]))
        warped = warped + wgt[..., None] * rows
    return (warped * ref).sum(-1) / math.sqrt(src.shape[-1])


class _Sweep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, ref, x, y):
        ctx.save_for_backward(src, ref, x, y)
        n, h, w, c = src.shape
        s, r = src.reshape(n, h * w, c).float(), ref.reshape(n, h * w, c).float()
        return torch.stack([_sweep_plane(s, r, x[:, d], y[:, d], h, w)
                            for d in range(x.shape[1])], 1)

    @staticmethod
    def backward(ctx, g):
        src, ref, x, y = ctx.saved_tensors
        n, h, w, c = src.shape
        s = src.detach().reshape(n, h * w, c).float().requires_grad_()
        r = ref.detach().reshape(n, h * w, c).float().requires_grad_()
        ds, dr = torch.zeros_like(s), torch.zeros_like(r)
        for d in range(x.shape[1]):
            with torch.enable_grad():
                out = _sweep_plane(s, r, x[:, d], y[:, d], h, w)
                a, b = torch.autograd.grad(out, (s, r), g[:, d].float())
            ds += a
            dr += b
        return ds.reshape(src.shape), dr.reshape(ref.shape), None, None


def warp_grid(src_proj, ref_proj, depth_values, h, w):
    """Sample coordinates (in source pixels) of every reference pixel on
    every depth plane: (x, y), each (N, D, H*W) f32."""
    dev = src_proj.device
    proj = src_proj.float() @ torch.linalg.inv(ref_proj.float())
    rot, trans = proj[:, :3, :3], proj[:, :3, 3:4]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    xyz = torch.stack([xs.reshape(-1), ys.reshape(-1), torch.ones(h * w, device=dev)], 0)
    pts = (torch.einsum("nij,jk->nik", rot, xyz)[:, :, None, :]
           * depth_values.float().reshape(1, 1, -1, 1) + trans[:, :, None, :])
    z = pts[:, 2]
    return (pts[:, 0] / z) * (w / (w - 1)) - 0.5, (pts[:, 1] / z) * (h / (h - 1)) - 0.5


def sweep(src_fea, ref_fea, src_proj, ref_proj, depth_values, log=None):
    """Plane-sweep correlation.  src_fea/ref_fea: (N, C, H, W); projections
    (N, 4, 4) at feature resolution; depth_values (D,).  Returns
    (N, D, H, W) f32, differentiable in both feature maps."""
    n, c, h, w = src_fea.shape
    x, y = warp_grid(src_proj, ref_proj, depth_values, h, w)
    src, ref = src_fea.permute(0, 2, 3, 1), ref_fea.permute(0, 2, 3, 1)
    if log is not None:
        log.sweep(src, ref, x, y)
    return _Sweep.apply(src, ref, x, y).reshape(n, -1, h, w)
