"""The plain reference of SGCDet: a frozen float32 copy of the detector's
equations in plain PyTorch (ResNet-50 + FPN, the MVS + monocular depth net,
the coarse-to-fine sparse volume with DFA3D lifting, the 3D neck and the
FCOS3D head), parameter names as the published checkpoints have them, so
that one state dict loads into the reference and into the program alike.

It imports nothing of the program.  Departures from the program's code,
none of which changes a result:

* DFA3D runs on the flat list of (camera, query) pairs that a camera sees
  (``ops.dfa3d``), where the program pads each camera to a budget;
* every layer computes in float32; ``set_quant`` makes the casting layers
  (convolutions, transposed convolutions, linear layers) round their input
  and weight through a lower precision first, the control of the
  benchmark's comparison;
* ``AdaptiveSparseVolume.forward`` can take the occupancy picks of another
  run (``picks``) and returns its own occupancy scores, so that the
  comparison can follow a run whose top-k fell otherwise near the cut.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from . import ops
from .voxel import voxel_centers_zero_origin


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


class _Quant:
    """Casting layers: ``quant`` (None, or a function of a tensor) rounds the
    input and the weight before the f32 computation."""

    quant = None

    def _q(self, t):
        return t if self.quant is None or t is None else self.quant(t)


class Conv2d(_Quant, nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(self._q(x), self._q(self.weight), self.bias)


class Conv3d(_Quant, nn.Conv3d):
    def forward(self, x):
        return self._conv_forward(self._q(x), self._q(self.weight), self.bias)


class ConvTranspose2d(_Quant, nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(self._q(x), self._q(self.weight), self.bias, self.stride,
                                  self.padding, self.output_padding, self.groups,
                                  self.dilation)


class ConvTranspose3d(_Quant, nn.ConvTranspose3d):
    def forward(self, x):
        return F.conv_transpose3d(self._q(x), self._q(self.weight), self.bias, self.stride,
                                  self.padding, self.output_padding, self.groups,
                                  self.dilation)


class Linear(_Quant, nn.Linear):
    def forward(self, x):
        return F.linear(self._q(x), self._q(self.weight), self.bias)


def set_quant(module: nn.Module, fn) -> None:
    for m in module.modules():
        if isinstance(m, _Quant):
            m.quant = fn


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with a per-tensor scale (its
    largest magnitude at 448), back in its own type.  The gradient passes
    straight through the rounding at float32, as float8 training keeps
    its gradients wider than e4m3 (a cast alone would pass none)."""
    if t.numel() == 0:
        return t
    with torch.no_grad():
        amax = t.abs().amax().float().clamp(min=1e-30)
        scale = amax / 448.0
        q = ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)
    return t + (q - t).detach() if t.requires_grad else q


class _MeanOverRanks(torch.autograd.Function):
    """The mean over the ranks of a group; its gradient is the mean of the
    ranks' gradients."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g / dist.get_world_size(ctx.group), None


class _BN:
    """BatchNorm in f32: running statistics in eval mode and when
    ``frozen``; biased batch statistics in train mode, the running ones
    moved with momentum 0.1 by the unbiased estimate.  With a process
    ``group`` (data parallel, one scene a rank) the batch mean and mean of
    squares are the ranks' means, var = E[x^2] - E[x]^2, and the unbiased
    factor takes the local count."""

    group = None

    def __init__(self, *args, frozen=False, **kwargs):
        super().__init__(*args, **kwargs)
        self.frozen = frozen

    def forward(self, x):
        train = self.training and not self.frozen
        if not train or self.group is None:
            return F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight,
                                self.bias, train, self.momentum, self.eps)
        ch, xf = x.shape[1], x.float()
        axes = (0,) + tuple(range(2, x.ndim))
        stats = _MeanOverRanks.apply(torch.cat([xf.mean(axes), xf.square().mean(axes)]),
                                     self.group)
        mean, var = stats[:ch], stats[ch:] - stats[:ch].square()
        n = x.numel() // ch
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var * n / max(n - 1, 1))
        shape = (1, ch) + (1,) * (x.ndim - 2)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return xf * inv.reshape(shape) + (self.bias - mean * inv).reshape(shape)


def set_group(module: nn.Module, group) -> None:
    """Every BatchNorm of ``module`` syncs its batch statistics over
    ``group`` in train mode (None: no sync)."""
    for m in module.modules():
        if isinstance(m, _BN):
            m.group = group


class BatchNorm2d(_BN, nn.BatchNorm2d):
    pass


class BatchNorm3d(_BN, nn.BatchNorm3d):
    pass


class LayerNorm(nn.Module):
    def __init__(self, features, eps=1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


def dropout(x, rate, generator):
    """Keep with probability 1 - rate (one uniform draw an element from
    ``generator``), kept values scaled by 1 / (1 - rate)."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class FFN(nn.Module):
    def __init__(self, embed_dims, feedforward_channels, rate=0.1):
        super().__init__()
        self.rate = rate
        self.layers = nn.ModuleList([
            nn.Sequential(Linear(embed_dims, feedforward_channels), nn.ReLU()),
            Linear(feedforward_channels, embed_dims)])

    def forward(self, x, generator=None):
        rate = self.rate if self.training else 0.0
        y = dropout(self.layers[0](x), rate, generator)
        return x + dropout(self.layers[1](y), rate, generator)


class MultiheadAttention(nn.Module):
    """Sequence-first attention; rows whose every key is masked attend to
    nothing."""

    def __init__(self, embed_dims, num_heads):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dims, embed_dims))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dims))
        self.out_proj = Linear(embed_dims, embed_dims)

    def forward(self, query, key, value, key_padding_mask):
        e, h = self.embed_dims, self.num_heads
        hd = e // h
        w, b = self.in_proj_weight, self.in_proj_bias
        q, k, v = (F.linear(x, w[i * e:(i + 1) * e], b[i * e:(i + 1) * e])
                   for i, x in enumerate((query, key, value)))
        lq, bsz, _ = q.shape
        lk = k.shape[0]
        q = q.reshape(lq, bsz, h, hd).permute(1, 2, 0, 3)
        k = k.reshape(lk, bsz, h, hd).permute(1, 2, 0, 3)
        v = v.reshape(lk, bsz, h, hd).permute(1, 2, 0, 3)
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        mask = key_padding_mask[:, None, None, :]
        attn = torch.softmax(logits.masked_fill(mask, float("-inf")), -1)
        attn = torch.where(key_padding_mask.all(-1)[:, None, None, None], 0.0, attn)
        return self.out_proj((attn @ v).permute(2, 0, 1, 3).reshape(lq, bsz, e))


def interpolate_nearest_size(x, size):
    out = x
    for axis, new_s in enumerate(size):
        s = out.shape[axis + 2]
        if new_s != s:
            idx = torch.floor(torch.arange(new_s, dtype=torch.float32, device=x.device)
                              * (s / new_s)).long().clamp(0, s - 1)
            out = out.index_select(axis + 2, idx)
    return out


def interpolate_linear(x, size):
    """Separable trilinear / bilinear resize, align_corners=False."""
    out = x
    for axis, new_s in enumerate(size):
        s = out.shape[axis + 2]
        if new_s == s:
            continue
        src = ((torch.arange(new_s, dtype=torch.float32, device=x.device) + 0.5)
               * (s / new_s) - 0.5).clamp(min=0.0)
        lo = torch.floor(src).long().clamp(0, s - 1)
        hi = (lo + 1).clamp(0, s - 1)
        shape = [1] * out.dim()
        shape[axis + 2] = new_s
        wgt = (src - lo).reshape(shape)
        out = out.index_select(axis + 2, lo) * (1 - wgt) + out.index_select(axis + 2, hi) * wgt
    return out


# ---------------------------------------------------------------------------
# backbone, FPN
# ---------------------------------------------------------------------------


class Bottleneck(nn.Module):
    def __init__(self, inplanes, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, frozen=True)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes, frozen=True)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4, frozen=True)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                                            BatchNorm2d(planes * 4, frozen=True))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + identity)


class ResNet50(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64, frozen=True)
        inplanes = 64
        for s, (planes, blocks, stride) in enumerate(
                [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)], start=1):
            layers = []
            for b in range(blocks):
                layers.append(Bottleneck(inplanes, planes, stride if b == 0 else 1, b == 0))
                inplanes = planes * 4
            setattr(self, f"layer{s}", nn.Sequential(*layers))

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        outs = []
        for s in range(1, 5):
            x = getattr(self, f"layer{s}")(x)
            outs.append(x)
        return outs


class _ConvModule(nn.Module):
    def __init__(self, cin, cout, k, pad=0):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, padding=pad)

    def forward(self, x):
        return self.conv(x)


class FPN(nn.Module):
    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels=256):
        super().__init__()
        self.lateral_convs = nn.ModuleList([_ConvModule(c, out_channels, 1) for c in in_channels])
        self.fpn_convs = nn.ModuleList(
            [_ConvModule(out_channels, out_channels, 3, pad=1) for _ in in_channels])

    def forward(self, inputs):
        lat = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + interpolate_nearest_size(lat[i], lat[i - 1].shape[2:])
        return [conv(x) for conv, x in zip(self.fpn_convs, lat)]


# ---------------------------------------------------------------------------
# depth net
# ---------------------------------------------------------------------------


class MatchingBasicBlock(nn.Module):
    def __init__(self, inplanes, planes, stride=1):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1)
        self.bn1 = BatchNorm2d(planes)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.bn3 = BatchNorm2d(planes)
            self.downsample = nn.Sequential(Conv2d(inplanes, planes, 1, stride), self.bn3)

    def forward(self, x):
        y = F.relu(self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x))))))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class ResNetFPNMatching(nn.Module):
    def __init__(self, output_dim=128):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3)
        self.bn1 = BatchNorm2d(64)
        self.layer1 = nn.Sequential(MatchingBasicBlock(64, 64), MatchingBasicBlock(64, 64))
        self.layer2 = nn.Sequential(MatchingBasicBlock(64, 128, 2), MatchingBasicBlock(128, 128))
        self.final_conv_3ddet = Conv2d(128, output_dim, 1)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return self.final_conv_3ddet(self.layer2(self.layer1(x)))


class ConvBnReLU2D(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn = BatchNorm2d(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _deconv_bn_relu(cin, cout):
    return nn.Sequential(ConvTranspose2d(cin, cout, 3, 2, 1, output_padding=1, bias=False),
                         BatchNorm2d(cout), nn.ReLU())


class SimpleUnet2D(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.conv1 = ConvBnReLU2D(d, 2 * d, stride=2)
        self.conv2 = ConvBnReLU2D(2 * d, 2 * d)
        self.conv3 = ConvBnReLU2D(2 * d, 4 * d, stride=2)
        self.conv4 = ConvBnReLU2D(4 * d, 4 * d)
        self.conv9 = _deconv_bn_relu(4 * d, 2 * d)
        self.conv11 = _deconv_bn_relu(2 * d, d)

    def forward(self, x):
        conv2 = self.conv2(self.conv1(x))
        y = conv2 + self.conv9(self.conv4(self.conv3(conv2)))
        return x + self.conv11(y)


def closest_frame_ids(num_cams, num_select):
    """Temporally adjacent neighbours, boundary rows shifted inward."""
    main = np.arange(num_cams)[:, None]
    offsets = np.concatenate([np.arange(-num_select // 2, 0),
                              np.arange(1, num_select // 2 + 1)])[None]
    closest = main + offsets
    closest[0:num_select // 2, :] += num_select // 2 + 1
    closest[num_cams - num_select // 2:num_cams, :] -= num_select // 2 + 1
    return closest


class DepthNetFusion(nn.Module):
    def __init__(self, dbound, neighbor_img_num=2, mono_channels=256):
        super().__init__()
        self.dbound = tuple(dbound)
        self.neighbor_img_num = neighbor_img_num
        d_ch = round((dbound[1] - dbound[0]) / dbound[2])
        self.fnet_mvs = ResNetFPNMatching(128)
        self.correlation_regulation = SimpleUnet2D(d_ch)
        self.fnet_mono = ConvBnReLU2D(mono_channels, 128)
        self.mono_regulation = SimpleUnet2D(128)
        self.fusion_regulation = SimpleUnet2D(d_ch + 128)
        self.depth_reg = Conv2d(d_ch + 128, d_ch, 3, 1, 1)

    def forward(self, feats, imgs, proj_feat, log=None):
        n = feats.shape[0]
        d0, d1, step = self.dbound
        depth_values = torch.from_numpy(
            np.arange(d0, d1, step, dtype=np.float32) + step / 2).to(feats.device)
        f_mvs = self.fnet_mvs(imgs)
        k = min(self.neighbor_img_num, n - 1)
        nei_ids = closest_frame_ids(n, k)
        corr = 0.0
        for j in range(k):
            nei = torch.from_numpy(nei_ids[:, j]).to(f_mvs.device)
            corr = corr + ops.sweep(f_mvs[nei], f_mvs, proj_feat[nei], proj_feat,
                                    depth_values, log)
        corr = corr / k
        fused = self.fusion_regulation(torch.cat(
            [self.correlation_regulation(corr),
             self.mono_regulation(self.fnet_mono(feats))], 1))
        return torch.softmax(self.depth_reg(fused).float(), dim=1)


# ---------------------------------------------------------------------------
# lifting
# ---------------------------------------------------------------------------


def point_sampling(ref_points, origin, projection, img_shape, dbound):
    """(N, K, 3) normalized (u, v, d) of every voxel centre in every camera
    and its visibility (N, K)."""
    eps = 1e-5
    pts = ref_points + origin[None, :]
    hom = torch.cat([pts, torch.ones_like(pts[:, :1])], -1)
    cam = torch.einsum("nij,kj->nki", projection, hom)
    d = cam[..., 2]
    uv = cam[..., :2] / torch.clamp(d, min=eps)[..., None]
    u, v = uv[..., 0] / img_shape[1], uv[..., 1] / img_shape[0]
    d_norm = (d - dbound[0]) / (dbound[1] - dbound[0])
    mask = (d > eps) & (u > eps) & (u < 1.0 - eps) & (v > eps) & (v < 1.0 - eps)
    return torch.stack([u, v, d_norm], -1), mask


def _offset_biases(num_heads, num_points):
    """The directional grid init of the uv offsets and the (cos + sin) / 2
    init of the depth offsets, (heads * points * 2,) and (heads * points,)."""
    thetas = np.arange(num_heads, dtype=np.float32) * (2.0 * math.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid.reshape(num_heads, 1, 2), (1, num_points, 1))
    dgrid = np.tile(((np.cos(thetas) + np.sin(thetas)) / 2).reshape(num_heads, 1),
                    (1, num_points))
    scale = np.arange(1, num_points + 1, dtype=np.float32)
    return ((grid * scale[None, :, None]).reshape(-1).astype(np.float32),
            (dgrid * scale[None, :]).reshape(-1).astype(np.float32))


class MSDeformableAttention3D(nn.Module):
    def __init__(self, embed_dims, num_heads, num_points):
        super().__init__()
        self.embed_dims, self.num_heads, self.num_points = embed_dims, num_heads, num_points
        h, p = num_heads, num_points
        self.sampling_offsets = Linear(embed_dims, h * p * 2)
        self.sampling_offsets_depth = Linear(embed_dims, h * p)
        self.attention_weights = Linear(embed_dims, h * p)
        self.value_proj = Linear(embed_dims, embed_dims)

    def forward(self, query, value_img, dpt_img, cam, ref_points, log=None):
        """query (M, C) of the seen pairs; ref_points (M, 3); cam (M,)."""
        m = query.shape[0]
        h, p = self.num_heads, self.num_points
        _, hh, ww, d_dim = dpt_img.shape
        v_img = self.value_proj(value_img)
        off = torch.cat([self.sampling_offsets(query).reshape(m, h, p, 2),
                         self.sampling_offsets_depth(query).reshape(m, h, p, 1)], -1)
        attn = torch.softmax(self.attention_weights(query).reshape(m, h, p), -1)
        norm = torch.tensor([ww, hh, d_dim], dtype=torch.float32, device=query.device)
        locs = ref_points[:, None, None, :] + off / norm
        return ops.dfa3d(v_img, dpt_img, cam, locs, attn, h, log)


class DeformCrossAttention(nn.Module):
    def __init__(self, embed_dims, num_heads, num_points):
        super().__init__()
        self.embed_dims = embed_dims
        self.deformable_attention = MSDeformableAttention3D(embed_dims, num_heads, num_points)
        self.output_proj = Linear(embed_dims, embed_dims)
        self.attention_pooling = MultiheadAttention(embed_dims, 8)

    def forward(self, query, value_img, dpt_img, ref_cam, mask, log=None):
        n, k = mask.shape
        cam, q = mask.nonzero(as_tuple=True)
        ref = ref_cam[cam, q].float()
        ones = torch.ones((cam.numel(), 1, 1), dtype=torch.float32, device=mask.device)
        stage1 = ops.dfa3d(value_img, dpt_img, cam, ref[:, None, None, :], ones, 1, log)
        pairs = self.deformable_attention(stage1, value_img, dpt_img, cam, ref, log)
        queries = torch.zeros((n, k, self.embed_dims), dtype=pairs.dtype, device=mask.device)
        queries = queries.index_put((cam, q), pairs)
        slots = queries * mask.to(queries.dtype)[..., None]
        count = mask.sum(0)
        mean = slots.sum(0) / torch.clamp(count, min=1)[..., None]
        pooled = self.attention_pooling(self.output_proj(mean)[None], slots, slots, ~mask.T)[0]
        return torch.where((count > 0)[:, None], pooled, 0.0) + query


class VoxFormerLayer(nn.Module):
    def __init__(self, embed_dims, num_heads, num_points, ffn_dropout):
        super().__init__()
        self.attentions = nn.ModuleList([DeformCrossAttention(embed_dims, num_heads, num_points)])
        self.ffns = nn.ModuleList([FFN(embed_dims, embed_dims * 2, ffn_dropout)])
        self.norms = nn.ModuleList([LayerNorm(embed_dims), LayerNorm(embed_dims)])

    def forward(self, query, value_img, dpt_img, ref_cam, mask, generator=None, log=None):
        query = self.norms[0](self.attentions[0](query, value_img, dpt_img, ref_cam, mask, log))
        return self.norms[1](self.ffns[0](query, generator))


class _Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class _Transformer(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.encoder = _Layers(layers)


class ViewTransformer(nn.Module):
    def __init__(self, embed_dims, num_heads, num_points, ffn_dropout):
        super().__init__()
        self.embed_dims = embed_dims
        self.cross_transformer = _Transformer(
            [VoxFormerLayer(embed_dims, num_heads, num_points, ffn_dropout)])

    def forward(self, ref_points, origin, projection, feat, dpt, img_shape, dbound,
                generator=None, log=None):
        value_img, dpt_img = feat.permute(0, 2, 3, 1), dpt.permute(0, 2, 3, 1)
        ref_cam, mask = point_sampling(ref_points, origin, projection, img_shape, dbound)
        query = torch.zeros((ref_points.shape[0], self.embed_dims), device=feat.device)
        for layer in self.cross_transformer.encoder.layers:
            query = layer(query, value_img, dpt_img, ref_cam, mask, generator, log)
        return query


class AdaptiveSparseVolume(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.embed_dims = cfg["embed_dims"]
        self.voxel_size_list = [tuple(v) for v in cfg["voxel_size_list"]]
        self.n_voxels_list = [tuple(v) for v in cfg["n_voxels_list"]]
        self.topk_list = tuple(cfg["topk_list"])
        self.base_heads = nn.ModuleList([
            ViewTransformer(self.embed_dims, cfg["num_heads"], cfg["num_points"],
                            cfg["ffn_dropout"]) for _ in self.n_voxels_list])
        self.occ_pred_heads = nn.ModuleList([
            nn.Sequential(Linear(self.embed_dims, 1), nn.Sigmoid())
            for _ in self.n_voxels_list[1:]])

    def forward(self, feats, dpts, origin, projection, img_shape, dbound, generator=None,
                picks=None, log=None):
        """Returns (volume (C, X, Y, Z), valid (X, Y, Z), occ_preds, scores
        of each finer level, the picks each finer level lifted).  ``picks``:
        for each finer level, the voxel indices to lift in place of the
        top-k of this run's own scores."""
        n_levels = len(self.n_voxels_list)
        dev = origin.device
        volume = valid = None
        scores, used = [], []
        for i in range(n_levels):
            ds = 4 * 2 ** (n_levels - 1 - i)
            h_i, w_i = img_shape[0] // ds, img_shape[1] // ds
            f = n_levels - 1 - i
            feat, dpt = feats[f][:, :, :h_i, :w_i], dpts[f][:, :, :h_i, :w_i]
            nvox = self.n_voxels_list[i]
            ref_all = torch.from_numpy(voxel_centers_zero_origin(nvox, self.voxel_size_list[i])).to(dev)
            head = self.base_heads[i]
            if i == 0:
                seeds = head(ref_all, origin, projection, feat, dpt, img_shape, dbound,
                             generator, log)
                volume = seeds.T.reshape(self.embed_dims, *nvox)
                continue
            up = interpolate_linear(volume[None], nvox)[0]
            occ = self.occ_pred_heads[i - 1](up.permute(1, 2, 3, 0)).reshape(-1)
            scores.append(occ)
            if picks is None:
                top = torch.sort(occ.detach(), descending=True, stable=True)[1][:self.topk_list[i - 1]]
            else:
                top = picks[i - 1].to(dev)
            top = torch.sort(top)[0]
            used.append(top)
            seeds = head(ref_all[top], origin, projection, feat, dpt, img_shape, dbound,
                         generator, log)
            flat = torch.zeros((int(np.prod(nvox)), self.embed_dims), dtype=seeds.dtype,
                               device=dev)
            volume = up + flat.index_put((top,), seeds).T.reshape(self.embed_dims, *nvox)
            if i == n_levels - 1:
                valid = torch.zeros(int(np.prod(nvox)), device=dev)
                valid[top] = 1.0
                valid = valid.reshape(nvox)
        return volume, valid, torch.cat(scores[::-1], 0), scores, used


# ---------------------------------------------------------------------------
# 3D neck and head
# ---------------------------------------------------------------------------


class BasicBlock3dV2(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = Conv3d(cin, cout, 3, stride, 1, bias=False)
        self.norm1 = BatchNorm3d(cout)
        self.conv2 = Conv3d(cout, cout, 3, 1, 1, bias=False)
        self.norm2 = BatchNorm3d(cout)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(Conv3d(cin, cout, 1, stride, bias=False),
                                            BatchNorm3d(cout))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.norm2(self.conv2(F.relu(self.norm1(self.conv1(x)))))
        return F.relu(y + identity)


class FastIndoorImVoxelNeck(nn.Module):
    def __init__(self, in_channels, out_channels, n_blocks):
        super().__init__()
        self.n_scales = len(n_blocks)
        ch = in_channels
        for i, nb in enumerate(n_blocks):
            blocks = []
            for b in range(nb):
                if b == 0 and i > 0:
                    blocks.append(BasicBlock3dV2(ch, ch * 2, 2))
                    ch *= 2
                else:
                    blocks.append(BasicBlock3dV2(ch, ch))
            setattr(self, f"down_layer_{i}", nn.Sequential(*blocks))
            if i > 0:
                setattr(self, f"up_block_{i}", nn.Sequential(
                    ConvTranspose3d(ch, ch // 2, 2, 2, bias=False), BatchNorm3d(ch // 2),
                    nn.ReLU(), Conv3d(ch // 2, ch // 2, 3, 1, 1, bias=False),
                    BatchNorm3d(ch // 2), nn.ReLU()))
            setattr(self, f"out_block_{i}", nn.Sequential(
                Conv3d(ch, out_channels, 3, 1, 1, bias=False), BatchNorm3d(out_channels),
                nn.ReLU()))

    def forward(self, x):
        downs = []
        for i in range(self.n_scales):
            x = getattr(self, f"down_layer_{i}")(x)
            downs.append(x)
        outs = []
        for i in range(self.n_scales - 1, -1, -1):
            if i < self.n_scales - 1:
                x = downs[i] + getattr(self, f"up_block_{i + 1}")(x)
            outs.append(getattr(self, f"out_block_{i}")(x))
        return outs[::-1]


class Scale(nn.Module):
    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(1.0))


class ImVoxelHead(nn.Module):
    def __init__(self, n_channels, n_classes, n_reg_outs, n_scales):
        super().__init__()
        self.centerness_conv = Conv3d(n_channels, 1, 3, padding=1, bias=False)
        self.reg_conv = Conv3d(n_channels, n_reg_outs, 3, padding=1, bias=False)
        self.cls_conv = Conv3d(n_channels, n_classes, 3, padding=1)
        self.scales = nn.ModuleList([Scale() for _ in range(n_scales)])

    def forward(self, xs):
        return [(self.centerness_conv(x), torch.exp(s.scale * self.reg_conv(x)),
                 self.cls_conv(x)) for x, s in zip(xs, self.scales)]


class SGCDet(nn.Module):
    """The detector at float32.  ``cfg``: the configuration file's
    ``model`` object (a dict)."""

    def __init__(self, cfg):
        super().__init__()
        if cfg["head_type"] != "scannet":
            raise ValueError("the reference has the ScanNet head only")
        if cfg["depth_loss"] or cfg["use_gt_dpt"] or cfg["sweep_band"] is not None:
            raise ValueError("the reference has neither the depth loss, nor GT depth, "
                             "nor the banded sweep")
        self.cfg = cfg
        self.backbone = ResNet50()
        self.neck = FPN(out_channels=cfg["embed_dims"])
        self.depth_head = DepthNetFusion(cfg["dbound"], cfg["neighbor_img_num"],
                                         mono_channels=cfg["embed_dims"])
        self.voxel_head = AdaptiveSparseVolume(cfg)
        self.neck_3d = FastIndoorImVoxelNeck(cfg["embed_dims"], cfg["neck3d_out_channels"],
                                             cfg["neck3d_n_blocks"])
        self.bbox_head = ImVoxelHead(cfg["neck3d_out_channels"], cfg["n_classes"],
                                     cfg["n_reg_outs"], cfg["n_scales"])

    def forward(self, imgs, proj_img, proj_feat4, origin, img_shape, generator=None,
                picks=None, log=None):
        cfg = self.cfg
        feats = self.neck(self.backbone(imgs))
        dpt = self.depth_head(feats[0], imgs, proj_feat4, log)
        h4, w4 = dpt.shape[-2:]
        dpts = [dpt, interpolate_nearest_size(dpt, (h4 // 2, w4 // 2)),
                interpolate_nearest_size(dpt, (h4 // 4, w4 // 4))]
        volume, valid, occ_preds, scores, used = self.voxel_head(
            feats[:3], dpts, origin, proj_img, img_shape, cfg["dbound"], generator, picks, log)
        head_outs = [tuple(o[0] for o in scale)
                     for scale in self.bbox_head(self.neck_3d(volume[None]))]
        return dict(head_outs=head_outs, valid=valid, occ_preds=occ_preds, scores=scores,
                    picks=used)
