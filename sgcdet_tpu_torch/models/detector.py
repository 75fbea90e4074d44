"""SGCDet detector (sgcdet_tpu/models/detector.py): backbone -> FPN -> depth
head -> adaptive sparse volume -> 3D neck -> FCOS3D head, one scene of N
posed views per call; and its training losses (``compute_losses``)."""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import tracing
from ..configs import ModelConfig
from ..parallel import view_sharding
from .depth_net import DepthNetFusion, depth_loss, downsample_gt_depth
from .det_head import ImVoxelHead, head_loss_single, head_points
from .fpn import FPN
from .layers import (
    init_weights,
    interpolate_linear,
    interpolate_nearest_size,
    remat_contexts,
    set_compute_dtype,
)
from .neck3d import FastIndoorImVoxelNeck
from .resnet import ResNet50
from .sparse_head import AdaptiveSparseVolume, occ_loss


class SGCDet(nn.Module):
    """cfg: a ``configs.ModelConfig`` (or the JAX package's, which has the
    same fields); img_shape: static (H, W) of the
    resized (pre-pad) image.  ``compute_dtype`` follows
    ``cfg.compute_dtype`` ('bfloat16' or 'float32'); BatchNorm statistics,
    the depth softmax, sampling coordinates and the fused-op accumulation
    stay f32.  Weights come from ``generator`` (seeded init) and can be
    replaced with ``load_state_dict``.  The model is built on ``device``,
    the card unless the caller passes ``device="cpu"`` (where every op runs
    its plain version); without a card the default raises."""

    def __init__(self, cfg: ModelConfig, img_shape, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but torch sees no CUDA device; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU")
        if cfg.head_type not in ("scannet", "sunrgbd"):
            raise ValueError(f"unknown head_type {cfg.head_type!r}")
        self.cfg = cfg
        self.img_shape = tuple(img_shape)
        self.backbone = ResNet50()
        self.neck = FPN(out_channels=cfg.embed_dims)
        # registered with use_gt_dpt too, as in the JAX package's tree (its
        # init sees no GT depth): its parameters then get zero gradients
        self.depth_head = DepthNetFusion(cfg.dbound, cfg.neighbor_img_num,
                                         mono_channels=cfg.embed_dims,
                                         sweep_band=cfg.sweep_band)
        self.voxel_head = AdaptiveSparseVolume(
            cfg.embed_dims, cfg.voxel_size_list, cfg.n_voxels_list,
            cfg.topk_list, cfg.num_heads, cfg.num_points,
            visibility_budget=cfg.visibility_budget, ffn_dropout=cfg.ffn_dropout,
            sort_queries=cfg.sort_queries)
        self.neck_3d = FastIndoorImVoxelNeck(
            cfg.embed_dims, cfg.neck3d_out_channels, cfg.neck3d_n_blocks)
        self.bbox_head = ImVoxelHead(cfg.neck3d_out_channels, cfg.n_classes,
                                     cfg.n_reg_outs, cfg.n_scales, cfg.head_type)
        init_weights(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))
        self.compute_dtype = (torch.float32 if cfg.compute_dtype == "float32"
                              else getattr(torch, cfg.compute_dtype))
        set_compute_dtype(self, self.compute_dtype)
        self.eval()
        self.to(device)

    def forward(self, imgs, proj_img, proj_feat4, origin, generator=None,
                gt_depth=None, view_group=None):
        """imgs: (N, 3, Hp, Wp) normalized padded images; proj_img:
        (N, 3, 4) world->pixel at image resolution; proj_feat4: (N, 4, 4)
        K[R|t] at feature stride 4; origin: (3,); generator: a
        ``torch.Generator`` on the model's device for the dropout masks in
        train mode; gt_depth: optional (N, Hp, Wp) metric depth, the depth
        distribution's one-hot where ``cfg.use_gt_dpt``; view_group: the
        process group of a view-sharded step, whose ranks each pass their
        slice of the scene's views (``parallel.view_slice``; N is then the
        slice's).  The per-view region (backbone to the lifting's sampling)
        runs on the slice; from the fusion over views on, everything is
        replicated, and the dropout masks are drawn alike on every rank
        from ``generator``.

        Returns dict: head_outs (per scale (centerness, bbox, cls) without
        the batch dim, f32), valid (X, Y, Z) f32, occ_preds, dpt_dist
        (N, D, H/4, W/4) f32 (this rank's views)."""
        with view_sharding(view_group):
            volume, valid, occ_preds, dpt_dist = self._lift(
                imgs, proj_img, proj_feat4, origin, generator, gt_depth)
        with tracing.span("sgc.model.head"):
            neck_outs = self.neck_3d(volume[None])
            head_outs = [tuple(o[0].float() for o in scale)
                         for scale in self.bbox_head(neck_outs)]
        return dict(
            head_outs=head_outs,
            valid=valid.float(),
            occ_preds=None if occ_preds is None else occ_preds.float(),
            dpt_dist=dpt_dist.float(),
        )

    def _lift(self, imgs, proj_img, proj_feat4, origin, generator, gt_depth):
        """Backbone, FPN, depth head and the adaptive sparse volume:
        (volume (C, X, Y, Z), valid, occ_preds, dpt_dist)."""
        cfg = self.cfg
        with tracing.span("sgc.model.backbone"):
            feats = self.neck(self.backbone(imgs))
        with tracing.span("sgc.model.depth"):
            if cfg.use_gt_dpt and gt_depth is not None:
                n, _, h4, w4 = feats[0].shape
                onehot = downsample_gt_depth(gt_depth, 4, cfg.dbound, cfg.depth_channels,
                                             cfg.depth_max_tol)
                dpt_dist = onehot.reshape(n, h4, w4, cfg.depth_channels).permute(0, 3, 1, 2)
            else:
                # with the depth loss on, the depth net does not train the
                # trunk through feats[0] (detector.py:55)
                depth_in = feats[0].detach() if cfg.depth_loss else feats[0]
                if cfg.depth_remat and self.training and torch.is_grad_enabled():
                    # the backward recomputes the depth net instead of keeping
                    # its activations (flax's nn.remat); its BNs move their
                    # running statistics once.  It draws no random numbers (a
                    # generator passed in would not be rewound for the
                    # recomputation)
                    dpt_dist = checkpoint(self.depth_head, depth_in, imgs, proj_feat4,
                                          use_reentrant=False, context_fn=remat_contexts)
                else:
                    dpt_dist = self.depth_head(depth_in, imgs, proj_feat4)
        with tracing.span("sgc.model.lifting"):
            h4, w4 = dpt_dist.shape[-2:]
            mlvl_dpt = [
                dpt_dist,
                interpolate_nearest_size(dpt_dist, (h4 // 2, w4 // 2)),
                interpolate_nearest_size(dpt_dist, (h4 // 4, w4 // 4)),
            ]
            volume, valid, occ_preds = self.voxel_head(
                feats[:3], mlvl_dpt, origin, proj_img, self.img_shape, cfg.dbound,
                generator)
        return volume, valid, occ_preds, dpt_dist


def flatten_valids(valid, featmap_sizes):
    """Per-scale trilinearly upsampled valid masks, flattened and
    concatenated in head-point order (detector.py:116-123)."""
    outs = []
    for fs in featmap_sizes:
        v = interpolate_linear(valid[None, None].float(), tuple(fs))[0, 0]
        outs.append(torch.round(v).bool().reshape(-1))
    return torch.cat(outs)


def compute_losses(cfg, outputs, origin, gt_boxes, gt_labels, gt_mask,
                   gt_depth=None, group=None, view_group=None):
    """The loss dict of one scene (detector.py:126-157) and n_pos.

    gt_boxes: (B, 7) gravity-centre boxes (padded); gt_labels: (B,);
    gt_mask: (B,) bool; gt_depth: (N, H, W) metric depth at
    downsample_factor x the stride-4 grid, read when ``cfg.depth_loss``;
    group: the process group of a data-parallel step (the head's average
    factor is then the ranks' mean positive count); view_group: that of a
    view-sharded step (gt_depth and ``outputs["dpt_dist"]`` are this
    rank's views; the depth loss sums over every view, and the head's
    losses, replicated, take the whole scene's n_pos as it is)."""
    head_outs = outputs["head_outs"]
    featmap_sizes = [h[0].shape[-3:] for h in head_outs]
    points, scales, level_sizes = head_points(featmap_sizes, cfg.voxel_size, origin)
    valids_flat = flatten_valids(outputs["valid"], featmap_sizes)
    loss_centerness, loss_bbox, loss_cls, _, geo_occ, n_pos = head_loss_single(
        head_outs, valids_flat, points, scales, level_sizes, gt_boxes,
        gt_labels, gt_mask, cfg, group)
    losses = dict(loss_centerness=loss_centerness, loss_bbox=loss_bbox,
                  loss_cls=loss_cls)
    if cfg.occ_loss and outputs["occ_preds"] is not None:
        losses["loss_occ"] = occ_loss(outputs["occ_preds"], geo_occ)
    if cfg.depth_loss and gt_depth is not None:
        losses["loss_dpt"] = depth_loss(
            gt_depth, outputs["dpt_dist"], cfg.downsample_factor, cfg.dbound,
            cfg.depth_loss_weight, cfg.depth_max_tol, group=view_group)
    return losses, n_pos
