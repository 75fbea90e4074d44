"""Dataset readers for the pkl-info format shared by ScanNet / ScanNet200 /
ARKitScenes, the port's copy of sgcdet_tpu/data/datasets.py (mmdet3d's
Custom3DDataset pkl loading, the reference's multi-view ScanNet and ARKit
datasets, and its class-balanced wrapper)."""
from __future__ import annotations

import os.path as osp
import pickle

import numpy as np

from ..geometry.boxes import DepthBoxes3D
from .pipeline import prepare_scene, scene_poses


def load_infos(ann_file):
    with open(ann_file, "rb") as f:
        data = pickle.load(f)
    # mmdet3d pkls are either a list or {metainfo, data_list}
    if isinstance(data, dict) and "data_list" in data:
        return data["data_list"]
    return data


class MultiViewDataset:
    """Multi-view scene dataset over an infos pkl.

    Yields fixed-shape scene dicts through :func:`prepare_scene`; GT is padded
    by the loader. `filter_empty_gt` drops GT-less scenes in train mode
    (Custom3DDataset behavior).
    """

    def __init__(self, data_cfg, train=True, load_depth=False, seed=0):
        self.cfg = data_cfg
        self.train = train
        self.load_depth = load_depth
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        ann = data_cfg.ann_train if train else data_cfg.ann_val
        self.infos = load_infos(osp.join(data_cfg.data_root, ann))
        if train and data_cfg.filter_empty_gt:
            self.infos = [i for i in self.infos if i["annos"]["gt_num"] != 0]

    def __len__(self):
        return len(self.infos)

    def set_epoch(self, epoch):
        """Reseed the train draws (view sampling, origin jitter) from the
        seed and ``epoch``, so an epoch's scenes do not depend on the
        epochs before it: a run resumed at an epoch's start draws what the
        uninterrupted run drew, when one thread reads the scenes in order.
        (The JAX package's dataset has no such method.)"""
        self.rng = np.random.RandomState([self.seed, epoch])

    def gt_arrays(self, index):
        """(boxes (G, 7) gravity-center form, labels (G,)) for one scene."""
        annos = self.infos[index]["annos"]
        if annos["gt_num"] != 0:
            raw = annos["gt_boxes_upright_depth"].astype(np.float32)
            labels = annos["class"].astype(np.int32)
        else:
            raw = np.zeros((0, 7), np.float32)
            labels = np.zeros((0,), np.int32)
        boxes = DepthBoxes3D(
            raw, box_dim=raw.shape[-1] if len(raw) else 7,
            with_yaw=raw.shape[-1] == 7, origin=(0.5, 0.5, 0.5),
        )
        grav = np.concatenate(
            [boxes.gravity_center, boxes.dims, boxes.tensor[:, 6:7]], axis=1
        )
        return grav.astype(np.float32), labels

    def gt_anno(self, index):
        """Raw gt dict for indoor_eval."""
        annos = self.infos[index]["annos"]
        return dict(
            gt_num=annos["gt_num"],
            gt_boxes_upright_depth=(
                annos["gt_boxes_upright_depth"].astype(np.float32)
                if annos["gt_num"] != 0
                else np.zeros((0, 7), np.float32)
            ),
            **{"class": annos["class"] if annos["gt_num"] != 0 else np.zeros(0, np.int64)},
        )

    def scene_poses(self, index):
        """(origin, proj_img, proj_feat4) for one scene without loading
        images, for whole-dataset geometry statistics (visibility budgets)."""
        return scene_poses(self.infos[index], self.cfg, self.train, self.rng)

    def __getitem__(self, index):
        scene = prepare_scene(
            self.infos[index], self.cfg, self.train, self.rng, self.load_depth
        )
        if self.train:
            boxes, labels = self.gt_arrays(index)
            scene["gt_boxes"] = boxes
            scene["gt_labels"] = labels
        scene["index"] = index
        return scene


class CBGSDataset:
    """Class-balanced resampling wrapper (the reference's CBGSDataset, which
    no released config uses): duplicates scene indices so every class
    appears in ~1/n_classes of the samples."""

    def __init__(self, dataset, n_classes, seed=0):
        self.ds = dataset
        # seeded: epoch composition must be deterministic across hosts so
        # host-sharded loaders slice the same duplicated index list
        self._rng = np.random.RandomState(seed)
        self.sample_indices = self._balanced_indices(n_classes)

    def _balanced_indices(self, n_classes):
        class_scenes = {i: [] for i in range(n_classes)}
        for idx in range(len(self.ds)):
            annos = self.ds.infos[idx]["annos"]
            labels = set(
                np.asarray(annos["class"]).tolist() if annos["gt_num"] else []
            )
            for l in labels:
                if l in class_scenes:
                    class_scenes[l].append(idx)
        duplicated = sum(len(v) for v in class_scenes.values())
        out = []
        frac = 1.0 / n_classes
        for cls, scenes in class_scenes.items():
            if not scenes:
                continue
            ratio = frac / (len(scenes) / duplicated)
            take = int(len(scenes) * ratio)
            out.extend(self._rng.choice(scenes, take).tolist())
        return out or list(range(len(self.ds)))

    def __len__(self):
        return len(self.sample_indices)

    def __getitem__(self, idx):
        return self.ds[self.sample_indices[idx]]

    @property
    def infos(self):
        return self.ds.infos

    def gt_anno(self, index):
        return self.ds.gt_anno(index)
