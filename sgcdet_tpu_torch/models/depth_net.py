"""Multi-view-stereo + monocular depth-distribution head
(sgcdet_tpu/models/depth_net.py, reference DepthNet_Fusion): per-view
categorical depth distributions over D bins from (a) a plane-sweep
dot-product cost volume against the temporally adjacent views, through the
truncated ResNet-18 matching extractor, and (b) a monocular branch from FPN
features, fused by 2D U-Nets and a softmax taken in f32; and the depth
loss against GT depth maps (``downsample_gt_depth``, ``depth_loss``).
With ``sweep_band`` the correlation goes through the banded-Gram sweep
(``ops/sweep_band.py``) instead of the sweep kernels.  Inside
``parallel.view_sharding(group)`` each rank holds a slice of the scene's
views: the neighbours come from the scene's view ids, the sweep reads them
from an all-gather of every view's matching features, and the depth loss
sums over every view.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.sweep import plane_sweep_correlation
from ..ops.sweep_band import plane_sweep_correlation_banded
from ..parallel import gather_views, sum_over_ranks, view_group
from .layers import BatchNorm2d, Conv2d, ConvTranspose2d
from .resnet import ResNetFPNMatching


def get_closest_frame_ids(num_cams: int, num_select: int) -> np.ndarray:
    """Temporally adjacent neighbour ids (depth_est_fusion.py:53-64):
    boundary rows are shifted inward by k/2+1."""
    assert num_select % 2 == 0
    main = np.arange(num_cams)[:, None]
    offsets = np.concatenate(
        [np.arange(-num_select // 2, 0), np.arange(1, num_select // 2 + 1)]
    )[None]
    closest = main + offsets
    closest[0:num_select // 2, :] += num_select // 2 + 1
    closest[num_cams - num_select // 2:num_cams, :] -= num_select // 2 + 1
    return closest


def _warp_grid(src_proj, ref_proj, depth_values, h, w):
    """Plane-sweep sample coordinates, always in f32.

    Reproduces homo_warping's grid convention (pixel / ((S-1)/2) - 1 fed to
    grid_sample(align_corners=False), i.e. sample position
    ``p * S/(S-1) - 0.5``).  Planes behind the source camera give huge, inf
    or NaN coordinates (division by z); the sweep ops clip them.
    Returns x_eff, y_eff of shape (N, D, H*W).
    """
    d = depth_values.shape[0]
    dev = src_proj.device
    proj = src_proj.float() @ torch.linalg.inv(ref_proj.float())
    rot = proj[:, :3, :3]
    trans = proj[:, :3, 3:4]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    xyz = torch.stack([xs.reshape(-1), ys.reshape(-1),
                       torch.ones(h * w, device=dev)], 0)  # (3, HW)
    rot_xyz = torch.einsum("nij,jk->nik", rot, xyz)  # (N, 3, HW)
    proj_xyz = (rot_xyz[:, :, None, :] * depth_values.float().reshape(1, 1, d, 1)
                + trans[:, :, None, :])
    z = proj_xyz[:, 2]
    px = proj_xyz[:, 0] / z
    py = proj_xyz[:, 1] / z
    return px * (w / (w - 1)) - 0.5, py * (h / (h - 1)) - 0.5


class ConvBnReLU2D(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn = BatchNorm2d(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _deconv_bn_relu(cin, cout):
    return nn.Sequential(
        ConvTranspose2d(cin, cout, 3, 2, 1, output_padding=1, bias=False),
        BatchNorm2d(cout), nn.ReLU(),
    )


class SimpleUnet2D(nn.Module):
    """2-level residual U-Net (depth_est_fusion.py:139-163)."""

    def __init__(self, channels):
        super().__init__()
        d = channels
        self.conv1 = ConvBnReLU2D(d, 2 * d, stride=2)
        self.conv2 = ConvBnReLU2D(2 * d, 2 * d)
        self.conv3 = ConvBnReLU2D(2 * d, 4 * d, stride=2)
        self.conv4 = ConvBnReLU2D(4 * d, 4 * d)
        self.conv9 = _deconv_bn_relu(4 * d, 2 * d)
        self.conv11 = _deconv_bn_relu(2 * d, d)

    def forward(self, x):
        conv2 = self.conv2(self.conv1(x))
        y = self.conv4(self.conv3(conv2))
        y = conv2 + self.conv9(y)
        return x + self.conv11(y)


class DepthNetFusion(nn.Module):
    """Depth distribution head for one scene of N views.

    forward(feats (N, C_mono, H, W) FPN level 0, imgs (N, 3, Hi, Wi),
    proj_feat (N, 4, 4) K[R|t] at feature resolution) -> (N, D, H, W) f32
    softmax depth distributions.  ``sweep_band``: the source-row band of the
    banded-Gram sweep, or None for the sweep kernels.
    """

    def __init__(self, dbound, neighbor_img_num=2, mono_channels=256, sweep_band=None):
        super().__init__()
        self.dbound = tuple(dbound)
        self.neighbor_img_num = neighbor_img_num
        self.sweep_band = sweep_band
        d_ch = self.depth_channels
        self.fnet_mvs = ResNetFPNMatching(output_dim=128)
        self.correlation_regulation = SimpleUnet2D(d_ch)
        self.fnet_mono = ConvBnReLU2D(mono_channels, 128)
        self.mono_regulation = SimpleUnet2D(128)
        self.fusion_regulation = SimpleUnet2D(d_ch + 128)
        self.depth_reg = Conv2d(d_ch + 128, d_ch, 3, 1, 1)

    @property
    def depth_channels(self):
        return round((self.dbound[1] - self.dbound[0]) / self.dbound[2])

    def forward(self, feats, imgs, proj_feat):
        n = feats.shape[0]
        d0, d1, step = self.dbound
        depth_values = torch.from_numpy(
            np.arange(d0, d1, step, dtype=np.float32) + step / 2).to(feats.device)

        f_mvs = self.fnet_mvs(imgs)
        # the sources: every view of the scene (a view-sharded rank holds
        # views first .. first + n - 1 of n_all; an end view's neighbours lie
        # up to 3 views away, so every view is gathered)
        f_src, proj_src, n_all, first = f_mvs, proj_feat, n, 0
        group = view_group()
        if group is not None:
            f_src, proj_src = gather_views(f_mvs, group), gather_views(proj_feat, group)
            n_all, first = f_src.shape[0], n * dist.get_rank(group)
        k = min(self.neighbor_img_num, n_all - 1)
        neighbor_ids = get_closest_frame_ids(n_all, k)[first:first + n]
        corr = torch.zeros((n, self.depth_channels) + tuple(f_mvs.shape[2:]),
                           dtype=f_mvs.dtype, device=f_mvs.device)
        for j in range(k):
            nei = torch.from_numpy(neighbor_ids[:, j]).to(f_mvs.device)
            args = (f_src[nei], f_mvs, proj_src[nei], proj_feat, depth_values)
            corr = corr + (plane_sweep_correlation(*args) if self.sweep_band is None
                           else plane_sweep_correlation_banded(*args, self.sweep_band))
        corr = corr / k

        cost_reg = self.correlation_regulation(corr)
        mono_reg = self.mono_regulation(self.fnet_mono(feats))
        fused = self.fusion_regulation(torch.cat([cost_reg, mono_reg], 1))
        logits = self.depth_reg(fused)
        # the distributions reweight the value sampling and must sum to 1:
        # normalize in f32 whatever the compute dtype
        return torch.softmax(logits.float(), dim=1)


def downsample_gt_depth(gt_depths, downsample_factor, dbound, depth_channels,
                        max_tol=0):
    """GT depth -> one-hot bins at feature resolution with min-pooling
    (depth_net.py:236-264).

    gt_depths: (N, H, W) meters (0 = invalid).  Returns (N*h*w, D) float
    one-hot, with an optional +-max_tol bin tolerance."""
    n, h, w = gt_depths.shape
    ds = downsample_factor
    g = gt_depths.reshape(n, h // ds, ds, w // ds, ds).permute(0, 1, 3, 2, 4)
    g = g.reshape(n, h // ds, w // ds, ds * ds)
    g = torch.where(g == 0.0, 1e5, g).amin(-1)
    g = (g - (dbound[0] - dbound[2])) / dbound[2]
    g = torch.where((g < depth_channels + 1) & (g >= 0.0), g, 0.0)
    onehot = F.one_hot(g.long(), depth_channels + 1).to(gt_depths.dtype)
    onehot = onehot.reshape(-1, depth_channels + 1)[:, 1:]
    if max_tol >= 1:
        acc = onehot
        for err in range(-max_tol, max_tol + 1):
            if err < 0:
                acc = acc + F.pad(acc[..., 1:], (0, 1))
            elif err > 0:
                acc = acc + F.pad(acc[..., :-1], (1, 0))
        onehot = acc / (acc + 1e-5)
    return onehot


def depth_loss(gt_depths, depth_preds, downsample_factor, dbound,
               loss_weight=0.5, max_tol=0, group=None):
    """Masked BCE between the predicted distributions (N, D, H, W) and the
    one-hot GT bins (depth_net.py:267-277).  With the ``group`` of a
    view-sharded step (this rank's views in, the loss of every view out),
    the BCE sum and the foreground count are summed over the ranks."""
    d_ch = depth_preds.shape[1]
    labels = downsample_gt_depth(gt_depths, downsample_factor, dbound, d_ch, max_tol)
    preds = depth_preds.permute(0, 2, 3, 1).reshape(-1, d_ch)
    fg = labels.amax(1) > 0.0
    preds = preds.clamp(1e-7, 1 - 1e-7)
    bce = -(labels * torch.log(preds) + (1 - labels) * torch.log(1 - preds))
    bce = torch.where(fg[:, None], bce, 0.0).sum()
    n_fg = fg.sum()
    if group is not None:
        bce, n_fg = sum_over_ranks(torch.stack([bce, n_fg.to(bce.dtype)]), group,
                                   "view_depth_loss")
    return loss_weight * bce / n_fg.clamp(min=1)
