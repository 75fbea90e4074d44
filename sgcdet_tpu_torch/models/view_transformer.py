"""Geometry- and context-aware 2D->3D lifting (the view transformer), port of
sgcdet_tpu/models/view_transformer.py: the DFA3D path (``use_depth=True``,
every released config) and the 2D MSDA path (``use_depth=False``, reached
at module level as in the JAX package: no config field selects it).

Every (camera, query) pair is computed with static shapes and the
visibility mask is applied at the inter-view fusion.  On the DFA3D path,
with a visibility budget each camera keeps its top-B queries by visibility
(all visible ones first, ties in index order, as ``jax.lax.top_k`` orders
them), both sampling stages run on that compacted set with
``valid_counts``, and the results are scattered back; the fusion masks
with ``mask & sel``.  With ``sort_queries`` the compacted queries are
ordered by their projected pixel (no budget then compacts at B = K) and
both sampling stages go through the windowed kernels
(``ops/dfa3d_windowed.py``); the order changes no result.  The 2D path never
compacts (the JAX package compacts only with ``use_depth``), ignores
``sort_queries`` and adds its stage-2 output to stage 1's.  Inside
``parallel.view_sharding(group)`` the projection, compaction and sampling
run on this rank's views, and the fusion over views on an all-gather of
every view's queries and mask, replicated on every rank.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .. import tracing
from ..ops.dfa3d import dfa3d_attend, msda_2d, msda_2d_attend
from ..ops.dfa3d_windowed import dfa3d_attention_windowed
from ..parallel import gather_views, view_group
from .layers import FFN, LayerNorm, Linear, MultiheadAttention


def point_sampling(ref_points, origin, projection, img_shape, dbound):
    """Project voxel centers into every camera.

    ref_points: (K, 3) origin-relative voxel centers; origin: (3,);
    projection: (N, 3, 4) world->pixel at image resolution; img_shape: (H, W).
    Returns ref_cam (N, K, 3) normalized (u, v, d) and mask (N, K).
    """
    eps = 1e-5
    ogf_h, ogf_w = img_shape
    pts = ref_points + origin[None, :]
    hom = torch.cat([pts, torch.ones_like(pts[:, :1])], -1)  # (K, 4)
    cam = torch.einsum("nij,kj->nki", projection, hom)  # (N, K, 3)
    d = cam[..., 2]
    uv = cam[..., :2] / torch.clamp(d, min=eps)[..., None]
    u = uv[..., 0] / ogf_w
    v = uv[..., 1] / ogf_h
    d_norm = (d - dbound[0]) / (dbound[1] - dbound[0])
    mask = (d > eps) & (u > eps) & (u < 1.0 - eps) & (v > eps) & (v < 1.0 - eps)
    return torch.stack([u, v, d_norm], -1), mask


def compact_queries(mask, visibility_budget, sort_queries=False, ref_cam=None,
                    spatial_shapes=None):
    """Budget compaction of one level's queries.

    mask: (N, K) visibility; visibility_budget: a fraction of K, or None.
    Each camera keeps B = K * budget queries, rounded up to a multiple of 128
    (at least 128): its visible queries first, index order among ties (the
    order of ``jax.lax.top_k``; ``torch.topk`` promises none).

    With ``sort_queries`` (ref_cam (N, K, 3) normalized, spatial_shapes
    ((h0, w0),) the level's feature size) the kept queries are ordered by
    the pixel their centre projects to, visible first, then row-major, with
    JAX's f32 score (view_transformer.py:296-309): that makes the windowed
    kernels' chunks pixel-coherent.  No budget then means B = K, and the
    level is compacted all the same.

    Returns (sel_idx (N, B) int64, valid_counts (N,) int32 = visible
    queries per camera, capped at B), or None where nothing is compacted.
    """
    k = mask.shape[1]
    if visibility_budget is None:
        budget = k if sort_queries else None
    else:
        budget = min(k, max(128, -(-int(k * visibility_budget) // 128) * 128))
    if budget is None or not (0 < budget < k or (sort_queries and budget == k)):
        return None
    valid_counts = torch.clamp(mask.sum(1), max=budget).to(torch.int32)
    scores = mask.float()
    if sort_queries:
        h0, w0 = spatial_shapes[0]
        u_pix = torch.clamp(torch.floor(ref_cam[..., 0].float() * w0 - 0.5),
                            -1.0, w0 - 1.0) + 1.0
        v_pix = torch.clamp(torch.floor(ref_cam[..., 1].float() * h0 - 0.5),
                            -1.0, h0 - 1.0) + 1.0
        row_norm = (v_pix * (w0 + 1) + u_pix) / float((h0 + 1) * (w0 + 1) + 1)
        scores = scores * 2.0 - row_norm
    sel_idx = torch.sort(scores, dim=1, descending=True, stable=True)[1][:, :budget]
    return sel_idx, valid_counts


def _uv_offset_bias(num_heads, num_levels, num_points):
    """Directional grid init of the 2D sampling-offset bias
    (deformable_cross_attention.py:194-208)."""
    thetas = np.arange(num_heads, dtype=np.float32) * (2.0 * math.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid.reshape(num_heads, 1, 1, 2), (1, num_levels, num_points, 1))
    for i in range(num_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


def _depth_offset_bias(num_heads, num_levels, num_points):
    """(cos+sin)/2 depth-offset bias (deformable_cross_attention.py:351-362)."""
    thetas = np.arange(num_heads, dtype=np.float32) * (2.0 * math.pi / num_heads)
    grid = ((np.cos(thetas) + np.sin(thetas)) / 2.0).reshape(num_heads, 1, 1, 1)
    grid = np.tile(grid, (1, num_levels, num_points, 1))
    for i in range(num_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


class MSDeformableAttention3D(nn.Module):
    """Context branch: learned-offset depth-weighted deformable attention
    (deformable_cross_attention.py:343-501), single level as in every
    released config."""

    num_levels = 1

    def __init__(self, embed_dims=256, num_heads=8, num_points=4):
        super().__init__()
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.num_points = num_points
        h, l, p = num_heads, self.num_levels, num_points
        self.sampling_offsets = Linear(embed_dims, h * l * p * 2)
        self.sampling_offsets_depth = Linear(embed_dims, h * l * p)
        self.attention_weights = Linear(embed_dims, h * l * p)
        self.value_proj = Linear(embed_dims, embed_dims)

    def reset_special_parameters(self, generator):
        h, l, p = self.num_heads, self.num_levels, self.num_points
        nn.init.xavier_uniform_(self.value_proj.weight, generator=generator)
        self.value_proj.bias.zero_()
        for lin, bias in ((self.sampling_offsets, _uv_offset_bias(h, l, p)),
                          (self.sampling_offsets_depth, _depth_offset_bias(h, l, p))):
            lin.weight.zero_()
            lin.bias.copy_(torch.from_numpy(bias))
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()

    def forward(self, query, value_img, dpt_img, ref_points, spatial_shapes,
                valid_counts=None, windowed=False):
        """query: (N, K, C); value_img: (N, H, W, C); dpt_img: (N, H, W, D);
        ref_points: (N, K, 1, 3) normalized; spatial_shapes: ((H, W),);
        windowed: sample through the windowed kernels (sorted queries).
        Returns (N, K, C)."""
        n, k, c = query.shape
        h, l, p = self.num_heads, self.num_levels, self.num_points
        d_dim = dpt_img.shape[-1]
        v_img = self.value_proj(value_img)
        off_uv = self.sampling_offsets(query).reshape(n, k, h, l, p, 2)
        off_d = self.sampling_offsets_depth(query).reshape(n, k, h, l, p, 1)
        offsets = torch.cat([off_uv, off_d], -1)
        attn = self.attention_weights(query).reshape(n, k, h, l * p)
        attn = torch.softmax(attn, -1).reshape(n, k, h, l, p)
        normalizer = torch.tensor([[w_, h_, d_dim] for (h_, w_) in spatial_shapes],
                                  dtype=torch.float32, device=query.device)
        locs = (ref_points[:, :, None, None, :, :]
                + offsets / normalizer[None, None, None, :, None, :])
        attend = dfa3d_attention_windowed if windowed else dfa3d_attend
        return attend(v_img, dpt_img, locs[:, :, :, 0], attn[:, :, :, 0],
                      num_heads=h, valid_counts=valid_counts)


class MSDeformableAttention2D(nn.Module):
    """Plain 2D multi-scale deformable attention, no depth weighting
    (deformable_cross_attention.py:119-340): the stage 2 of the 2D path.
    One level samples through the DFA3D kernels (``msda_2d_attend``); more
    levels, one flat value, through the plain ``ops/dfa3d.py::msda_2d``, as
    the JAX module sends them to the XLA ``ops/msda.py::msda_2d`` (no model
    path reaches that branch: ``ViewTransformer`` lifts one level)."""

    def __init__(self, embed_dims=256, num_heads=8, num_points=4, num_levels=1):
        super().__init__()
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.num_levels = num_levels
        self.num_points = num_points
        h, l, p = num_heads, num_levels, num_points
        self.sampling_offsets = Linear(embed_dims, h * l * p * 2)
        self.attention_weights = Linear(embed_dims, h * l * p)
        self.value_proj = Linear(embed_dims, embed_dims)

    def reset_special_parameters(self, generator):
        h, l, p = self.num_heads, self.num_levels, self.num_points
        nn.init.xavier_uniform_(self.value_proj.weight, generator=generator)
        self.value_proj.bias.zero_()
        self.sampling_offsets.weight.zero_()
        self.sampling_offsets.bias.copy_(torch.from_numpy(_uv_offset_bias(h, l, p)))
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()

    def forward(self, query, value, ref_points, spatial_shapes):
        """query: (N, K, C); value: (N, sum_l H_l * W_l, C) flat, the levels
        one after another; ref_points: (N, K, 1, 2) normalized;
        spatial_shapes: ((H_l, W_l), ...).  Returns (N, K, C)."""
        n, k, c = query.shape
        h, l, p = self.num_heads, self.num_levels, self.num_points
        v = self.value_proj(value)
        off = self.sampling_offsets(query).reshape(n, k, h, l, p, 2)
        attn = self.attention_weights(query).reshape(n, k, h, l * p)
        attn = torch.softmax(attn, -1).reshape(n, k, h, l, p)
        normalizer = torch.tensor([[w_, h_] for (h_, w_) in spatial_shapes],
                                  dtype=torch.float32, device=query.device)
        locs = (ref_points[:, :, None, None, :, :]
                + off / normalizer[None, None, None, :, None, :])
        if l > 1:
            return msda_2d(v.reshape(n, -1, h, c // h), spatial_shapes, locs, attn)
        h_, w_ = spatial_shapes[0]
        return msda_2d_attend([v.reshape(n, h_, w_, c)], locs, attn, num_heads=h)


class DeformCrossAttention(nn.Module):
    """Two-stage per-view aggregation + masked-mean / attention inter-view
    fusion (deformable_cross_attention.py:691-837).  ``use_depth`` picks the
    DFA3D path (stage 2 replaces stage 1) or the 2D path
    (deformable_cross_attention.py:504-688: a bilinear grid-sample stage 1,
    plain MSDA stage 2 added to it, no budget compaction).
    ``sort_queries`` orders the compacted queries by projected pixel and
    samples through the windowed kernels (DFA3D path only)."""

    def __init__(self, embed_dims=256, num_heads=8, num_points=4,
                 visibility_budget=None, use_depth=True, sort_queries=False):
        super().__init__()
        self.embed_dims = embed_dims
        self.visibility_budget = visibility_budget
        self.use_depth = use_depth
        self.sort_queries = sort_queries
        attention = MSDeformableAttention3D if use_depth else MSDeformableAttention2D
        self.deformable_attention = attention(embed_dims, num_heads, num_points)
        self.output_proj = Linear(embed_dims, embed_dims)
        self.attention_pooling = MultiheadAttention(embed_dims, 8)

    def reset_special_parameters(self, generator):
        nn.init.xavier_uniform_(self.output_proj.weight, generator=generator)
        self.output_proj.bias.zero_()

    def forward(self, query, value_img, dpt_img, ref_cam, mask, spatial_shapes):
        """query: (K, C); value_img: (N, H, W, C); dpt_img: (N, H, W, D)
        (unused on the 2D path); ref_cam: (N, K, 3); mask: (N, K)
        visibility.  Returns (K, C)."""
        if self.use_depth:
            queries, mask = self._sample_dfa3d(value_img, dpt_img, ref_cam, mask,
                                               spatial_shapes)
        else:
            queries = self._sample_2d(value_img, ref_cam, spatial_shapes)
        group = view_group()
        if group is not None:  # the fusion sees every view of the scene
            queries = gather_views(queries, group, "view_fusion")
            mask = gather_views(mask, group, "view_fusion")

        # inter-view fusion: masked mean over visible views ...
        slots = queries * mask.to(queries.dtype)[..., None]
        count = mask.sum(0)  # (K,)
        mean = slots.sum(0) / torch.clamp(count, min=1)[..., None]
        slots_mean = self.output_proj(mean)
        # ... then attention pooling over views (query = mean, keys = views)
        slots_mean = self.attention_pooling(slots_mean[None], slots, slots,
                                            ~mask.T)[0]
        # fully masked voxels: where, not a multiply (NaN-safe)
        output = torch.where((count > 0)[:, None], slots_mean, 0.0)
        return output + query

    def _sample_2d(self, value_img, ref_cam, spatial_shapes):
        """2D path, on every query (no compaction): bilinear sample of the
        features at the projected point, plus plain MSDA around it."""
        n, k = ref_cam.shape[:2]
        locs1 = ref_cam[:, :, None, None, None, :2].float()  # (N, K, 1, 1, 1, 2)
        attn1 = torch.ones((n, k, 1, 1, 1), dtype=torch.float32,
                           device=ref_cam.device)
        queries_per_image = msda_2d_attend([value_img], locs1, attn1, num_heads=1)
        queries = self.deformable_attention(
            queries_per_image, value_img.reshape(n, -1, self.embed_dims),
            ref_cam[:, :, None, :2], spatial_shapes)
        # stage 2 is a residual on stage 1 here (view_transformer.py:368)
        return queries + queries_per_image

    def _sample_dfa3d(self, value_img, dpt_img, ref_cam, mask, spatial_shapes):
        """DFA3D path: (per-view queries (N, K, C), fusion mask)."""
        n, k = mask.shape
        c = self.embed_dims
        compact = compact_queries(mask, self.visibility_budget, self.sort_queries,
                                  ref_cam, spatial_shapes)
        valid_counts = None
        if compact is not None:
            sel_idx, valid_counts = compact
            ref_cam_s = torch.gather(ref_cam, 1, sel_idx[..., None].expand(-1, -1, 3))
            sel = torch.zeros_like(mask).scatter_(1, sel_idx, True)
            mask = mask & sel
        else:
            ref_cam_s = ref_cam

        # stage 1 — geometry: depth-weighted trilinear sample at the
        # projected point (1 head = full C, 1 point, weight 1)
        kk = ref_cam_s.shape[1]
        tracing.count("lift.visible", mask if valid_counts is None else valid_counts)
        tracing.count("lift.slots", n * kk)
        locs1 = ref_cam_s[:, :, None, None, :].float()
        attn1 = torch.ones((n, kk, 1, 1), dtype=torch.float32, device=mask.device)
        attend = dfa3d_attention_windowed if self.sort_queries else dfa3d_attend
        queries_per_image = attend(value_img, dpt_img, locs1, attn1,
                                   num_heads=1, valid_counts=valid_counts)
        # stage 2 — context: REPLACES the stage-1 output (not a residual)
        queries = self.deformable_attention(
            queries_per_image, value_img, dpt_img, ref_cam_s[:, :, None, :],
            spatial_shapes, valid_counts=valid_counts, windowed=self.sort_queries)
        if compact is not None:
            queries = torch.zeros((n, k, c), dtype=queries.dtype,
                                  device=queries.device).scatter_(
                1, sel_idx[..., None].expand(-1, -1, c), queries)
        return queries, mask


class VoxFormerLayer(nn.Module):
    """cross_attn -> norm -> ffn -> norm (operation order of
    configs/SGCDet_ScanNet.py:50); reference names ``attentions.0``,
    ``ffns.0``, ``norms.{0,1}``."""

    def __init__(self, embed_dims=256, num_heads=8, num_points=4,
                 visibility_budget=None, ffn_dropout=0.1, use_depth=True,
                 sort_queries=False):
        super().__init__()
        self.attentions = nn.ModuleList([DeformCrossAttention(
            embed_dims, num_heads, num_points,
            visibility_budget=visibility_budget, use_depth=use_depth,
            sort_queries=sort_queries)])
        self.ffns = nn.ModuleList([FFN(embed_dims, embed_dims * 2, ffn_dropout)])
        self.norms = nn.ModuleList([LayerNorm(embed_dims), LayerNorm(embed_dims)])

    def forward(self, query, value_img, dpt_img, ref_cam, mask, spatial_shapes,
                generator=None):
        """generator: the FFN dropout's masks in train mode."""
        query = self.attentions[0](query, value_img, dpt_img, ref_cam, mask,
                                   spatial_shapes)
        query = self.norms[0](query)
        query = self.ffns[0](query, generator=generator)
        return self.norms[1](query)


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class _Transformer(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.encoder = _Encoder(layers)


class ViewTransformer(nn.Module):
    """One encoder pass of one layer over a set of voxel queries, as in every
    released config.  Parameters live under ``cross_transformer.encoder
    .layers.0`` as in the reference's DenseHead.  ``use_depth=False`` lifts
    through the 2D path (the depth input is then unused); ``sort_queries``
    orders the compacted queries by projected pixel and samples through the
    windowed kernels."""

    def __init__(self, embed_dims=256, num_heads=8, num_points=4,
                 visibility_budget=None, ffn_dropout=0.1, use_depth=True,
                 sort_queries=False):
        super().__init__()
        self.embed_dims = embed_dims
        self.cross_transformer = _Transformer([
            VoxFormerLayer(embed_dims, num_heads, num_points, visibility_budget,
                           ffn_dropout, use_depth, sort_queries)])

    def forward(self, ref_points, origin, projection, feat, dpt, img_shape, dbound,
                generator=None):
        """ref_points: (K, 3) origin-relative voxel centers; feat:
        (N, C, H, W); dpt: (N, D, H, W); generator: the FFN dropout's masks
        in train mode.  Returns seed features (K, C)."""
        spatial_shapes = ((feat.shape[2], feat.shape[3]),)
        value_img = feat.permute(0, 2, 3, 1)
        dpt_img = dpt.permute(0, 2, 3, 1)
        ref_cam, mask = point_sampling(ref_points, origin, projection, img_shape,
                                       dbound)
        query = torch.zeros((ref_points.shape[0], self.embed_dims),
                            dtype=value_img.dtype, device=value_img.device)
        for layer in self.cross_transformer.encoder.layers:
            query = layer(query, value_img, dpt_img, ref_cam, mask, spatial_shapes,
                          generator)
        return query
