"""Feature Pyramid Network as configured by SGCDet
(sgcdet_tpu/models/fpn.py): 1x1 laterals, nearest top-down upsample to the
lower level's size, 3x3 output convs, no extra levels.  Names follow mmdet
(``lateral_convs.i.conv``, ``fpn_convs.i.conv``)."""
from __future__ import annotations

from typing import Sequence

from torch import nn

from .layers import Conv2d, interpolate_nearest_size


class _ConvModule(nn.Module):
    """mmcv ConvModule without norm or activation: just ``.conv``."""

    def __init__(self, cin, cout, k, pad=0):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, padding=pad)

    def forward(self, x):
        return self.conv(x)


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            [_ConvModule(c, out_channels, 1) for c in in_channels])
        self.fpn_convs = nn.ModuleList(
            [_ConvModule(out_channels, out_channels, 3, pad=1) for _ in in_channels])

    def reset_special_parameters(self, generator):
        # xavier-uniform kernels (the JAX FPN's kernel_init)
        for m in (*self.lateral_convs, *self.fpn_convs):
            nn.init.xavier_uniform_(m.conv.weight, generator=generator)

    def forward(self, inputs):
        """Every op keeps the inputs' layout (channels-last from
        ``ResNet50`` on the card); the levels leave contiguous (N, C, H, W),
        the layout the depth net and the lifting read."""
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + interpolate_nearest_size(
                laterals[i], laterals[i - 1].shape[2:])
        return [conv(x).contiguous() for conv, x in zip(self.fpn_convs, laterals)]
