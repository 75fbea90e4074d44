"""SGCDet detector, eval forward (sgcdet_tpu/models/detector.py): backbone ->
FPN -> depth head -> adaptive sparse volume -> 3D neck -> FCOS3D head, one
scene of N posed views per call."""
from __future__ import annotations

import torch
from torch import nn

from ..configs import ModelConfig
from .depth_net import DepthNetFusion
from .det_head import ImVoxelHead
from .fpn import FPN
from .layers import init_weights, interpolate_nearest_size, set_compute_dtype
from .neck3d import FastIndoorImVoxelNeck
from .resnet import ResNet50
from .sparse_head import AdaptiveSparseVolume


class SGCDet(nn.Module):
    """cfg: a ``configs.ModelConfig`` (or the JAX package's, which has the
    same fields); img_shape: static (H, W) of the
    resized (pre-pad) image.  ``compute_dtype`` follows
    ``cfg.compute_dtype`` ('bfloat16' or 'float32'); BatchNorm statistics,
    the depth softmax, sampling coordinates and the fused-op accumulation
    stay f32.  Weights come from ``generator`` (seeded init) and can be
    replaced with ``load_state_dict``."""

    def __init__(self, cfg: ModelConfig, img_shape, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.head_type != "scannet":
            raise NotImplementedError("the port runs the ScanNet head only")
        # options of the JAX package's ModelConfig that the port does not run
        if (getattr(cfg, "sort_queries", False) or getattr(cfg, "use_gt_dpt", False)
                or getattr(cfg, "sweep_band", None) is not None):
            raise NotImplementedError(
                "sort_queries, sweep_band and use_gt_dpt are not ported")
        self.cfg = cfg
        self.img_shape = tuple(img_shape)
        self.backbone = ResNet50()
        self.neck = FPN(out_channels=cfg.embed_dims)
        self.depth_head = DepthNetFusion(cfg.dbound, cfg.neighbor_img_num,
                                         mono_channels=cfg.embed_dims)
        self.voxel_head = AdaptiveSparseVolume(
            cfg.embed_dims, cfg.voxel_size_list, cfg.n_voxels_list,
            cfg.topk_list, cfg.num_heads, cfg.num_points,
            visibility_budget=cfg.visibility_budget)
        self.neck_3d = FastIndoorImVoxelNeck(
            cfg.embed_dims, cfg.neck3d_out_channels, cfg.neck3d_n_blocks)
        self.bbox_head = ImVoxelHead(cfg.neck3d_out_channels, cfg.n_classes,
                                     cfg.n_reg_outs, cfg.n_scales)
        init_weights(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))
        self.compute_dtype = (torch.float32 if cfg.compute_dtype == "float32"
                              else getattr(torch, cfg.compute_dtype))
        set_compute_dtype(self, self.compute_dtype)
        self.eval()
        if device is not None:
            self.to(device)

    def forward(self, imgs, proj_img, proj_feat4, origin):
        """imgs: (N, 3, Hp, Wp) normalized padded images; proj_img:
        (N, 3, 4) world->pixel at image resolution; proj_feat4: (N, 4, 4)
        K[R|t] at feature stride 4; origin: (3,).

        Returns dict: head_outs (per scale (centerness, bbox, cls) without
        the batch dim, f32), valid (X, Y, Z) f32, occ_preds, dpt_dist
        (N, D, H/4, W/4) f32."""
        cfg = self.cfg
        feats = self.neck(self.backbone(imgs))
        dpt_dist = self.depth_head(feats[0], imgs, proj_feat4)
        h4, w4 = dpt_dist.shape[-2:]
        mlvl_dpt = [
            dpt_dist,
            interpolate_nearest_size(dpt_dist, (h4 // 2, w4 // 2)),
            interpolate_nearest_size(dpt_dist, (h4 // 4, w4 // 4)),
        ]
        volume, valid, occ_preds = self.voxel_head(
            feats[:3], mlvl_dpt, origin, proj_img, self.img_shape, cfg.dbound)
        neck_outs = self.neck_3d(volume[None])
        head_outs = [tuple(o[0].float() for o in scale)
                     for scale in self.bbox_head(neck_outs)]
        return dict(
            head_outs=head_outs,
            valid=valid.float(),
            occ_preds=None if occ_preds is None else occ_preds.float(),
            dpt_dist=dpt_dist.float(),
        )
