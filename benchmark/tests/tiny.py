"""A tiny cell of each mode for the benchmark's CPU tests: the released
configurations' structure at cut widths and grids (embed 32, 4 heads x 2
points, a 16 x 16 x 8 finest grid, 47 x 64 images, 4 views), built from
the benchmark's own configuration and traffic files."""
from __future__ import annotations

import copy

import torch

from benchmark import harness, traffic

TINY_MODEL = dict(
    embed_dims=32, num_heads=4, num_points=2,
    n_voxels_list=[[4, 4, 2], [8, 8, 4], [16, 16, 8]],
    topk_list=[64, 512], dbound=[0.2, 3.4, 0.4], n_classes=3, neck3d_out_channels=16,
)
TINY_DATA = dict(img_shape=[47, 64], pad_size=[48, 64], max_boxes=16)


def tiny_cell(mode="serve", views=4, limits=None, config="scannet"):
    """A Cell of the tiny configuration under a cut copy of the mode's mix."""
    base = harness.load_cell("scannet.serve100" if mode == "serve" else "scannet.train40")
    cfg = copy.deepcopy(base.config)
    cfg["model"].update(TINY_MODEL)
    cfg["data"].update(TINY_DATA)
    mix = dict(copy.deepcopy(base.mix), views=views, profile=2)
    mix["rigs"] = mix["rigs"][:3 if mode == "train" else 2]
    if mode == "train":
        mix["gt_real"] = [4, 8]
    lim = base.limits if limits is None else limits
    return harness.Cell(f"tiny.{mode}", cfg, mix, 1, dict(lim), base.end_to_end,
                        base.per_layer, base.readers, base.mode)


def cpu():
    return torch.device("cpu")


__all__ = ["tiny_cell", "cpu", "traffic"]
