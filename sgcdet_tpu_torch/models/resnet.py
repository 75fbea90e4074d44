"""Backbones (sgcdet_tpu/models/resnet.py), with the reference's torchvision
naming so ``state_dict`` keys match the released checkpoints.

* ``ResNet50`` — mmdet ResNet-50 'pytorch' style.  Every BN is frozen
  (running statistics in train mode too, resnet.py:45-61,75), and the
  optimizer keeps the stem, stage 1 and every BN affine fixed
  (configs/SGCDet_ScanNet.py:74-83, ``train/optim.py::param_label``).
  Channels-last on the card, each BN fused with its add and ReLU.
* ``ResNetFPNMatching`` — the truncated ResNet-18 stereo-matching extractor
  of the depth head, output stride 4; its BNs train normally.  Its blocks register the downsample
  BN twice, as ``bn3`` and as ``downsample.1`` (the same module), exactly as
  the reference does (layer_matching.py:118-127), so both key sets appear in
  ``state_dict``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm2d, Conv2d


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, frozen=True)
        # 'pytorch' style: stride on the 3x3 conv
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes, frozen=True)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4, frozen=True)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                BatchNorm2d(planes * 4, frozen=True),
            )

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.bn1.fused(self.conv1(x), relu=True)
        out = self.bn2.fused(self.conv2(out), relu=True)
        return self.bn3.fused(self.conv3(out), identity, relu=True)


class ResNet50(nn.Module):
    """ResNet-50 returning the four stage outputs, (N, C, H, W).

    On the card it runs in channels-last memory: the input is cast to the
    compute dtype and laid out channels-last in one copy, cuDNN's convs
    keep that layout (no NCHW <-> NHWC transposes around them), and each
    frozen BN with its residual add and ReLU is one kernel
    (``BatchNorm2d.fused``).  The stage outputs stay channels-last.  On the
    CPU it keeps its input's layout (oneDNN's channels-last convs round
    otherwise than its NCHW ones)."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64, frozen=True)
        inplanes = 64
        for s, (planes, blocks, stride) in enumerate(
            [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)], start=1
        ):
            layers = []
            for b in range(blocks):
                layers.append(Bottleneck(inplanes, planes,
                                         stride if b == 0 else 1,
                                         downsample=(b == 0)))
                inplanes = planes * 4
            setattr(self, f"layer{s}", nn.Sequential(*layers))

    def forward(self, x):
        layout = torch.channels_last if x.is_cuda else torch.preserve_format
        x = x.to(self.conv1.compute_dtype or x.dtype, memory_format=layout)
        x = self.bn1.fused(self.conv1(x), relu=True)
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for s in range(1, 5):
            x = getattr(self, f"layer{s}")(x)
            outs.append(x)
        return outs


class MatchingBasicBlock(nn.Module):
    """Convs with bias; relu after bn2 before the residual add; a BN'd 1x1
    downsample whenever stride != 1 or the channels change."""

    def __init__(self, inplanes, planes, stride=1):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1)
        self.bn1 = BatchNorm2d(planes)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.bn3 = BatchNorm2d(planes)
            self.downsample = nn.Sequential(
                Conv2d(inplanes, planes, 1, stride), self.bn3
            )

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class ResNetFPNMatching(nn.Module):
    """Truncated ResNet-18 matching feature extractor, output stride 4."""

    def __init__(self, output_dim=128):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3)
        self.bn1 = BatchNorm2d(64)
        self.layer1 = nn.Sequential(MatchingBasicBlock(64, 64),
                                    MatchingBasicBlock(64, 64))
        self.layer2 = nn.Sequential(MatchingBasicBlock(64, 128, stride=2),
                                    MatchingBasicBlock(128, 128))
        self.final_conv_3ddet = Conv2d(128, output_dim, 1)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.layer2(self.layer1(x))
        return self.final_conv_3ddet(x)
