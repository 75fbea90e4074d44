"""Adaptive sparse 3D volume construction, coarse to fine
(sgcdet_tpu/models/sparse_head.py; reference AdaptiveSparseHead +
DenseHead).  Level 0 lifts every voxel; each finer level trilinearly
upsamples the previous volume, scores occupancy per voxel, lifts a static
top-k of voxels and adds them back; unselected voxels keep the upsampled
value.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..voxel_grid import voxel_centers_zero_origin
from .layers import Linear, interpolate_linear
from .view_transformer import ViewTransformer


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores, lower index first among ties (the
    order of ``jax.lax.top_k``; ``torch.topk`` promises no tie order, and
    ties are common among bf16 sigmoids)."""
    return torch.sort(scores, descending=True, stable=True)[1][:k]


class AdaptiveSparseVolume(nn.Module):
    def __init__(self, embed_dims=256,
                 voxel_size_list: Sequence = ((0.64, 0.64, 0.8), (0.32, 0.32, 0.4),
                                              (0.16, 0.16, 0.2)),
                 n_voxels_list: Sequence = ((10, 10, 4), (20, 20, 8), (40, 40, 16)),
                 topk_list: Sequence = (800, 6400), num_heads=8, num_points=4,
                 visibility_budget=None, ffn_dropout=0.1, sort_queries=False):
        """visibility_budget: None, a fraction for every level, or one
        fraction per level (1.0 disables compaction at that level);
        ffn_dropout: the rate of the lifting FFN's dropouts in train mode;
        sort_queries: order each level's compacted queries by projected
        pixel and sample through the windowed kernels."""
        super().__init__()
        self.embed_dims = embed_dims
        self.voxel_size_list = tuple(voxel_size_list)
        self.n_voxels_list = tuple(tuple(v) for v in n_voxels_list)
        self.topk_list = tuple(topk_list)
        heads = []
        for i in range(len(self.n_voxels_list)):
            vb = visibility_budget
            if isinstance(vb, (list, tuple)):
                vb = float(vb[i])
                if vb >= 1.0:
                    vb = None
            heads.append(ViewTransformer(embed_dims, num_heads, num_points,
                                         visibility_budget=vb,
                                         ffn_dropout=ffn_dropout,
                                         sort_queries=sort_queries))
        self.base_heads = nn.ModuleList(heads)
        self.occ_pred_heads = nn.ModuleList(
            [nn.Sequential(Linear(embed_dims, 1), nn.Sigmoid())
             for _ in range(len(self.n_voxels_list) - 1)])

    def forward(self, mlvl_feats, mlvl_dpt_dists, origin, projection, img_shape,
                dbound, generator=None):
        """mlvl_feats: list of (N, C, H_l, W_l), finest first (FPN order);
        mlvl_dpt_dists: list of (N, D, H_l, W_l), finest first; origin: (3,);
        projection: (N, 3, 4) at image resolution; generator: the FFN
        dropout's masks in train mode.
        Returns (volume (C, X, Y, Z), valid (X, Y, Z) f32, occ_preds or None).
        """
        n_levels = len(self.n_voxels_list)
        img_h, img_w = img_shape
        finest_ds = 4
        dev = origin.device
        volume = valid = None
        occ_preds_list = []
        for i in range(n_levels):
            ds = finest_ds * (2 ** (n_levels - 1 - i))
            h_i, w_i = img_h // ds, img_w // ds
            feat_idx = n_levels - 1 - i
            feat = mlvl_feats[feat_idx][:, :, :h_i, :w_i]
            dpt = mlvl_dpt_dists[feat_idx][:, :, :h_i, :w_i]
            nvox = self.n_voxels_list[i]
            ref_all = torch.from_numpy(
                voxel_centers_zero_origin(nvox, self.voxel_size_list[i])).to(dev)
            head = self.base_heads[i]
            if i == 0:
                seeds = head(ref_all, origin, projection, feat, dpt, img_shape, dbound,
                             generator)
                volume = seeds.T.reshape(self.embed_dims, *nvox)
                continue
            upsampled = interpolate_linear(volume[None], nvox)[0]  # (C, X, Y, Z)
            occ = self.occ_pred_heads[i - 1](upsampled.permute(1, 2, 3, 0)).reshape(-1)
            occ_preds_list.append(occ)
            # spatial scan order (the reference's nonzero() order)
            top_idx = torch.sort(top_k_indices(occ, self.topk_list[i - 1]))[0]
            seeds = head(ref_all[top_idx], origin, projection, feat, dpt,
                         img_shape, dbound, generator)  # (K, C)
            flat = torch.zeros((int(np.prod(nvox)), self.embed_dims),
                               dtype=seeds.dtype, device=dev)
            flat[top_idx] = seeds
            volume = upsampled + flat.T.reshape(self.embed_dims, *nvox)
            if i == n_levels - 1:
                valid = torch.zeros(int(np.prod(nvox)), dtype=torch.float32,
                                    device=dev)
                valid[top_idx] = 1.0
                valid = valid.reshape(nvox)

        if occ_preds_list:
            return volume, valid, torch.cat(occ_preds_list[::-1], 0)
        return volume, torch.ones(self.n_voxels_list[-1], device=dev), None


def occ_loss(occ_pred, geo_occ, weight=0.5):
    """BCE between the predicted occupancy and the box-derived geometric
    occupancy (sparse_head.py:131-138).  occ_pred (M,), geo_occ (>=M,)
    bool."""
    target = geo_occ[:occ_pred.shape[0]].to(occ_pred.dtype)
    p = occ_pred.clamp(1e-7, 1 - 1e-7)
    bce = -(target * torch.log(p) + (1 - target) * torch.log(1 - p))
    return bce.mean() * weight
