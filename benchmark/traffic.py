"""The one generator of the benchmark's traffic: a pool of synthetic posed
scans, from a mix's data file (``traffic/<mix>.json``) and the run's seed.

A scan is the indoor walkthrough of a camera on a small loop inside the
room, panning a full turn twice, as a hand-held ScanNet capture moves:
each view sees part of the voxel grid.  The mix file fixes every rig of
the pool (loop radius, camera height, start angle and pan offset), so
every seed serves the same set of sizes and visibilities; the seed orders
the pool and draws the images (normalized, standard normal, drawn on the
card in one call) and the ground truth.

Keys of a mix file:
  mode        the mode that drives the program: ``modes/<mode>.py``
  views       views of every scan
  rigs        [{"radius", "height", "start", "pan"}, ...], one a pool scan
  gt_real     [lo, hi]: real GT boxes of a training scan, drawn in between
              (the rest of the configuration's padded slots are padding)
  ranks       data-parallel ranks, a card each, each with a pool of its own
              (train; 1 when absent)
  profile     calls in the traced run's profiled sub-window
  cls_prior   the seeded weights' classification prior (weights.py)
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

ORI_H = 968
FOCAL = 1000.0
CENTRE = (648.0, 484.0)


def load(name: str, root: Path = Path(__file__).resolve().parent) -> dict:
    """The mix ``name``: ``traffic/<name>.json`` under ``root``."""
    return json.loads((Path(root) / "traffic" / f"{name}.json").read_text())


def _extrinsics(rig, n_views):
    """(N, 4, 4) world -> camera: the camera on a loop of ``radius`` at
    ``height``, its bearing going twice round while it walks once."""
    exts = []
    for i in range(n_views):
        t = i / max(n_views, 1)
        walk = rig["start"] + 2 * np.pi * t
        ang = rig["pan"] + 2 * np.pi * 2 * t
        pos = np.array([rig["radius"] * np.cos(walk), rig["radius"] * np.sin(walk),
                        rig["height"]], np.float32)
        c, s = np.cos(ang), np.sin(ang)
        e = np.eye(4, dtype=np.float32)
        e[:3, :3] = np.array([[c, -s, 0], [0, 0, -1], [s, c, 0]], np.float32)
        e[:3, 3] = -e[:3, :3] @ pos
        exts.append(e)
    return np.stack(exts)


def projections(rig, n_views, img_h):
    """proj_img (N, 3, 4) at the network's input resolution and proj_feat4
    (N, 4, 4) K[R|t] at stride 4."""
    intr = np.eye(4, dtype=np.float32)
    intr[0, 0] = intr[1, 1] = FOCAL
    intr[0, 2], intr[1, 2] = CENTRE
    ext = _extrinsics(rig, n_views)
    k = intr[:3, :3].copy()
    k[:2] /= ORI_H / img_h
    proj_img = np.einsum("ij,njk->nik", k, ext[:, :3, :]).astype(np.float32)
    intr4 = intr.copy()
    intr4[:2] /= ORI_H / (img_h / 4)
    proj4 = np.einsum("ij,njk->nik", intr4, ext).astype(np.float32)
    return proj_img, proj4


def _gt(rng, slots, n_real, n_classes):
    """Axis-aligned gravity-centre boxes standing where the loop's cameras
    look (1.2-2.4 m from its axis at any bearing, centre 0.2-1.2 m high,
    0.3-1.5 m a side), ``n_real`` of ``slots`` real, random labels."""
    radius = rng.uniform(1.2, 2.4, slots)
    bearing = rng.uniform(-np.pi, np.pi, slots)
    boxes = np.zeros((slots, 7), np.float32)
    boxes[:, 0], boxes[:, 1] = radius * np.cos(bearing), radius * np.sin(bearing)
    boxes[:, 2] = rng.uniform(0.2, 1.2, slots)
    boxes[:, 3:6] = rng.uniform(0.3, 1.5, (slots, 3))
    return dict(gt_boxes=boxes,
                gt_labels=rng.randint(0, n_classes, slots).astype(np.int32),
                gt_mask=np.arange(slots) < n_real)


def pool(mix: dict, seed: int, data_cfg: dict, n_classes: int, device) -> list:
    """The mix's scans for ``seed``: a list of dicts of host float32 arrays
    (imgs (N, 3, H, W), proj_img, proj_feat4, origin, and for training
    gt_boxes, gt_labels, gt_mask), in the seed's order."""
    rng = np.random.RandomState(seed % 2 ** 32)
    rigs = [mix["rigs"][i] for i in rng.permutation(len(mix["rigs"]))]
    n = mix["views"]
    pad_h, pad_w = data_cfg["pad_size"]
    gen = torch.Generator(device=device).manual_seed(seed)
    imgs = torch.randn((len(rigs), n, 3, pad_h, pad_w), generator=gen, device=device)
    imgs = imgs.cpu().numpy()
    scans = []
    for j, rig in enumerate(rigs):
        proj_img, proj4 = projections(rig, n, data_cfg["img_shape"][0])
        scan = dict(imgs=imgs[j], proj_img=proj_img, proj_feat4=proj4,
                    origin=np.array([0.0, 0.0, 0.5], np.float32))
        if mix["mode"] == "train":
            lo, hi = mix["gt_real"]
            scan.update(_gt(rng, data_cfg["max_boxes"], rng.randint(lo, hi + 1), n_classes))
        scans.append(scan)
    return scans
