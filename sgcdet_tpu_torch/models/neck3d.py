"""3D convolutional neck over the voxel volume (sgcdet_tpu/models/neck3d.py;
reference FastIndoorImVoxelNeck): 3-scale residual encoder-decoder, outputs
finest first.  Names follow the reference (``down_layer_i``,
``up_block_i``, ``out_block_i``)."""
from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm3d, Conv3d, ConvTranspose3d


class BasicBlock3dV2(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = Conv3d(cin, cout, 3, stride, 1, bias=False)
        self.norm1 = BatchNorm3d(cout)
        self.conv2 = Conv3d(cout, cout, 3, 1, 1, bias=False)
        self.norm2 = BatchNorm3d(cout)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                Conv3d(cin, cout, 1, stride, bias=False), BatchNorm3d(cout))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        return F.relu(y + identity)


class FastIndoorImVoxelNeck(nn.Module):
    def __init__(self, in_channels, out_channels=128,
                 n_blocks: Sequence[int] = (1, 1, 1)):
        super().__init__()
        self.n_scales = len(n_blocks)
        ch = in_channels
        for i, nb in enumerate(n_blocks):
            stride = 1 if i == 0 else 2
            blocks = []
            for b in range(nb):
                if b == 0 and stride != 1:
                    blocks.append(BasicBlock3dV2(ch, ch * 2, stride))
                    ch *= 2
                else:
                    blocks.append(BasicBlock3dV2(ch, ch))
            setattr(self, f"down_layer_{i}", nn.Sequential(*blocks))
            if i > 0:
                setattr(self, f"up_block_{i}", nn.Sequential(
                    ConvTranspose3d(ch, ch // 2, 2, 2, bias=False),
                    BatchNorm3d(ch // 2), nn.ReLU(),
                    Conv3d(ch // 2, ch // 2, 3, 1, 1, bias=False),
                    BatchNorm3d(ch // 2), nn.ReLU(),
                ))
            setattr(self, f"out_block_{i}", nn.Sequential(
                Conv3d(ch, out_channels, 3, 1, 1, bias=False),
                BatchNorm3d(out_channels), nn.ReLU(),
            ))

    def forward(self, x):
        """x: (B, C, X, Y, Z) -> list of n_scales outputs, finest first."""
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
