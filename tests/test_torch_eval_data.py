"""The host data pipeline, box geometry, BEV NMS and indoor mAP eval of the
PyTorch port against the JAX package's NumPy modules, on the CPU: every
copy gives equal arrays on seeded inputs.

* ``box_iou_rotated``, ``DepthBoxes3D`` (corners, gravity centres, BEV,
  height overlaps, 3D IoU and IoF), ``axis_aligned_overlaps_3d``,
  ``rotation_3d_in_axis`` on every axis (and its torch twin within f32
  rounding);
* ``nms_bev``, ``nms_normal_bev`` (equal indices) and
  ``box3d_multiclass_nms``;
* ``indoor_eval`` on aligned and yawed detections (the same dict), and GT
  given back as detections scores AP 1.0;
* ``prepare_scene``, ``scene_poses``, ``MultiViewDataset``,
  ``CBGSDataset``, ``SceneLoader`` and ``pad_gt`` on a synthetic on-disk
  ScanNet set (4x4 intrinsics, extrinsics and an axis-alignment matrix,
  aligned boxes, a scene without GT) and ARKit set (3x3 intrinsics, camera
  poses, the ``pose_center`` origin, yawed boxes), with small frames
  (90 x 128, resized to 45 x 64 and padded to 48 x 64; ``ori_shape`` set
  to match).
"""
import dataclasses
import pickle

import numpy as np
import pytest
import torch

from sgcdet_tpu.configs import config as jconfigs
from sgcdet_tpu.data import datasets as jdatasets
from sgcdet_tpu.data import loader as jloader
from sgcdet_tpu.data import pipeline as jpipeline
from sgcdet_tpu.eval.indoor_eval import indoor_eval as jax_indoor_eval
from sgcdet_tpu.geometry import boxes as jboxes
from sgcdet_tpu.geometry.rotated_iou import box_iou_rotated as jax_box_iou_rotated
from sgcdet_tpu.ops import nms as jnms

from sgcdet_tpu_torch import configs
from sgcdet_tpu_torch.data import (
    CBGSDataset,
    MultiViewDataset,
    SceneLoader,
    pad_gt,
    prepare_scene,
    scene_poses,
)
from sgcdet_tpu_torch.eval import indoor_eval
from sgcdet_tpu_torch.geometry import (
    DepthBoxes3D,
    axis_aligned_overlaps_3d,
    box_iou_rotated,
    rotation_3d_in_axis,
)
from sgcdet_tpu_torch.ops.nms import box3d_multiclass_nms, nms_bev, nms_normal_bev

from torch_port_tiny import keep_global_torch_rng  # noqa: F401 (autouse)

FRAME = (90, 128)  # (h, w) of the synthetic frames
DEPTH_FRAME = (60, 80)
SMALL_DATA = dict(img_scale=(64, 48), pad_size=(48, 64), img_shape=(45, 64),
                  ori_shape=FRAME, n_images_train=4, n_images_test=3, max_boxes=8)


def _yawed(n, seed):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.uniform(-2, 2, (n, 3)), rng.uniform(0.2, 1.5, (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], 1).astype(np.float32)


def _assert_tree_equal(a, b, path="scene"):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def test_box_iou_rotated_matches_jax():
    a, b = _yawed(9, 0)[:, [0, 1, 3, 4, 6]], _yawed(7, 1)[:, [0, 1, 3, 4, 6]]
    b[:3] = a[:3]  # identical rects among the pairs
    got = box_iou_rotated(a, b)
    np.testing.assert_array_equal(got, jax_box_iou_rotated(a, b))
    assert got.shape == (9, 7) and got.dtype == np.float32
    assert box_iou_rotated(a[:0], b).shape == (0, 7)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_rotation_3d_in_axis_matches_jax(axis):
    rng = np.random.RandomState(axis)
    pts = rng.randn(5, 8, 3).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, 5).astype(np.float32)
    got = rotation_3d_in_axis(pts, ang, axis=axis)
    np.testing.assert_array_equal(got, jboxes.rotation_3d_in_axis(pts, ang, axis=axis))
    np.testing.assert_array_equal(rotation_3d_in_axis(pts[0], ang[0], axis=axis),
                                  jboxes.rotation_3d_in_axis(pts[0], ang[0], axis=axis))
    twin = rotation_3d_in_axis(torch.from_numpy(pts), torch.from_numpy(ang), axis=axis)
    np.testing.assert_allclose(twin.numpy(), got, rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_yaw", [True, False], ids=["yawed", "aligned"])
def test_depth_boxes_match_jax(with_yaw):
    raw = _yawed(10, 2) if with_yaw else _yawed(10, 2)[:, :6]
    other = _yawed(6, 3) if with_yaw else _yawed(6, 3)[:, :6]
    other[:2] = raw[:2]
    dim = raw.shape[1]
    ours = [DepthBoxes3D(x, box_dim=dim, origin=(0.5, 0.5, 0.5)) for x in (raw, other)]
    ref = [jboxes.DepthBoxes3D(x, box_dim=dim, origin=(0.5, 0.5, 0.5)) for x in (raw, other)]
    for name in ("tensor", "corners", "gravity_center", "bev", "volume", "dims",
                 "top_height"):
        np.testing.assert_array_equal(getattr(ours[0], name), getattr(ref[0], name),
                                      err_msg=name)
    assert ours[0].with_yaw == ref[0].with_yaw == with_yaw and ours[0].box_dim == 7
    np.testing.assert_array_equal(ours[0][3].tensor, ref[0][3].tensor)
    np.testing.assert_array_equal(ours[0][2:5].tensor, ref[0][2:5].tensor)
    np.testing.assert_array_equal(DepthBoxes3D.height_overlaps(*ours),
                                  jboxes.DepthBoxes3D.height_overlaps(*ref))
    for mode in ("iou", "iof"):
        got = DepthBoxes3D.overlaps(*ours, mode=mode)
        np.testing.assert_array_equal(got, jboxes.DepthBoxes3D.overlaps(*ref, mode=mode))
    np.testing.assert_allclose(np.diag(DepthBoxes3D.overlaps(*ours)[:2, :2]), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("is_aligned", [True, False], ids=["paired", "matrix"])
def test_axis_aligned_overlaps_match_jax(is_aligned):
    rng = np.random.RandomState(4)
    lo = rng.uniform(-1, 1, (2, 7, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 1.5, (2, 7, 3)).astype(np.float32)
    a, b = (np.concatenate([lo[i], hi[i]], 1) for i in (0, 1))
    np.testing.assert_array_equal(
        axis_aligned_overlaps_3d(a, b, is_aligned=is_aligned),
        jboxes.axis_aligned_overlaps_3d(a, b, is_aligned=is_aligned))


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------


def _bev_candidates(n=120, seed=5):
    """Clustered BEV boxes (x1, y1, x2, y2, yaw) with tied scores."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(-2, 2, (6, 2))[rng.randint(0, 6, n)] + rng.randn(n, 2) * 0.15
    half = rng.uniform(0.2, 0.6, (n, 2))
    boxes = np.concatenate([centres - half, centres + half,
                            rng.uniform(-np.pi, np.pi, (n, 1))], 1).astype(np.float32)
    scores = np.round(rng.uniform(0, 1, n), 2).astype(np.float32)
    return boxes, scores


@pytest.mark.parametrize("thresh", [0.15, 0.5])
def test_bev_nms_match_jax(thresh):
    boxes, scores = _bev_candidates()
    for ours, ref in ((nms_bev, jnms.nms_bev), (nms_normal_bev, jnms.nms_normal_bev)):
        got = ours(boxes, scores, thresh)
        np.testing.assert_array_equal(got, ref(boxes, scores, thresh))
        assert 1 < len(got) < len(boxes)


@pytest.mark.parametrize("rotate", [True, False], ids=["rotated", "normal"])
def test_box3d_multiclass_nms_matches_jax(rotate):
    bev, _ = _bev_candidates()
    rng = np.random.RandomState(6)
    boxes = np.concatenate([(bev[:, :2] + bev[:, 2:4]) / 2, rng.uniform(0, 1, (len(bev), 1)),
                            bev[:, 2:4] - bev[:, :2], rng.uniform(0.2, 1, (len(bev), 1)),
                            bev[:, 4:]], 1).astype(np.float32)
    scores = rng.uniform(0, 1, (len(bev), 5)).astype(np.float32)
    scores[:, 3] = 0.0  # a class with no candidate above the threshold
    args = (boxes, bev, scores, 0.05, 20, 0.15)
    got = box3d_multiclass_nms(*args, use_rotate_nms=rotate)
    want = jnms.box3d_multiclass_nms(*args, use_rotate_nms=rotate)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    assert len(got[0]) == 20 and 3 not in got[2]


# ---------------------------------------------------------------------------
# indoor eval
# ---------------------------------------------------------------------------


def _eval_case(with_yaw, n_scenes=3, seed=7):
    rng = np.random.RandomState(seed)
    gts, dets = [], []
    for s in range(n_scenes):
        n = 0 if s == 1 else 5
        g = _yawed(n, seed + s) if with_yaw else _yawed(n, seed + s)[:, :6]
        labels = rng.randint(0, 4, n)
        gts.append(dict(gt_num=n, gt_boxes_upright_depth=g, **{"class": labels}))
        m = 8
        d = np.concatenate([g, _yawed(m - n, seed + 10 + s)[:, :g.shape[1]]]) if n \
            else _yawed(m, seed + 20)[:, :g.shape[1]]
        d = d + rng.randn(*d.shape).astype(np.float32) * 0.05
        dets.append(dict(boxes=d, scores=rng.uniform(0, 1, m).astype(np.float32),
                         labels=np.concatenate([labels, rng.randint(0, 5, m - n)])))
    return gts, dets


def _dt_annos(boxes_cls, dets, with_yaw):
    return [dict(boxes_3d=boxes_cls(d["boxes"], box_dim=d["boxes"].shape[1],
                                    with_yaw=with_yaw, origin=(0.5, 0.5, 0.5)),
                 scores_3d=d["scores"], labels_3d=d["labels"]) for d in dets]


@pytest.mark.parametrize("with_yaw", [True, False], ids=["yawed", "aligned"])
def test_indoor_eval_matches_jax(with_yaw, capsys):
    gts, dets = _eval_case(with_yaw)
    label2cat = {i: f"c{i}" for i in range(5)}
    got = indoor_eval(gts, _dt_annos(DepthBoxes3D, dets, with_yaw), [0.25, 0.5], label2cat)
    want = jax_indoor_eval(gts, _dt_annos(jboxes.DepthBoxes3D, dets, with_yaw),
                           [0.25, 0.5], label2cat)
    assert got == want
    assert 0 < got["mAP_0.25"] < 1
    # the GT given back as detections of score 1
    perfect = [dict(boxes=g["gt_boxes_upright_depth"], scores=np.ones(g["gt_num"], np.float32),
                    labels=g["class"]) for g in gts]
    res = indoor_eval(gts, _dt_annos(DepthBoxes3D, perfect, with_yaw), [0.25, 0.5], label2cat)
    present = {int(c) for g in gts for c in g["class"]}
    for t in ("0.25", "0.50"):
        assert all(res[f"c{c}_AP_{t}"] == 1.0 for c in present), res
        assert res[f"mAP_{t}"] == 1.0
    capsys.readouterr()


# ---------------------------------------------------------------------------
# the data pipeline on synthetic on-disk sets
# ---------------------------------------------------------------------------


def _write_set(root, kind, n_views=5):
    """A train and a val infos pkl of 3 and 2 scenes under ``root``: JPEG
    frames and uint16 PNG depth maps, ScanNet's or ARKit's pose fields."""
    import cv2

    rng = np.random.RandomState(0 if kind == "scannet" else 1)
    root.mkdir(parents=True, exist_ok=True)

    def camera(s, v):
        ang = 2 * np.pi * v / n_views + 0.3 * s
        c, si = np.cos(ang), np.sin(ang)
        cam_to_world = np.eye(4, dtype=np.float32)
        cam_to_world[:3, :3] = np.array([[c, 0, si], [-si, 0, c], [0, -1, 0]], np.float32)
        cam_to_world[:3, 3] = [0.4 * c, 0.4 * si, 1.2 + 0.1 * s]
        return cam_to_world

    def scene(split, s):
        info = dict(img_paths=[], depth_paths=[])
        for v in range(n_views):
            ip, dp = f"{kind}_{split}{s}_v{v}.jpg", f"{kind}_{split}{s}_v{v}.png"
            cv2.imwrite(str(root / ip), rng.randint(0, 255, FRAME + (3,), np.uint8))
            cv2.imwrite(str(root / dp), rng.randint(0, 5000, DEPTH_FRAME).astype(np.uint16))
            info["img_paths"].append(ip)
            info["depth_paths"].append(dp)
        n = 0 if (split, s) == ("train", 1) else 2 + s
        if kind == "scannet":
            aam = np.eye(4, dtype=np.float32)
            aam[:2, :2] = [[np.cos(0.2), -np.sin(0.2)], [np.sin(0.2), np.cos(0.2)]]
            aam[:3, 3] = [0.1, -0.2, 0.0]
            info["extrinsics"] = [np.linalg.inv(aam) @ camera(s, v) for v in range(n_views)]
            intr = np.eye(4, dtype=np.float32)
            intr[0, 0] = intr[1, 1] = 100.0
            intr[0, 2], intr[1, 2] = 64.0, 45.0
            info["intrinsics"] = intr
            boxes = _yawed(n, 30 + s)[:, :6]
        else:
            info["poses"] = [camera(s, v) for v in range(n_views)]
            info["intrinsic"] = np.array([[110.0, 0, 63.5], [0, 110.0, 44.5], [0, 0, 1]],
                                         np.float32)
            aam = None
            boxes = _yawed(n, 40 + s)
        info["annos"] = dict(gt_num=n, gt_boxes_upright_depth=boxes,
                             **{"class": rng.randint(0, 4, n)})
        if aam is not None:
            info["annos"]["axis_align_matrix"] = aam
        return info

    for split, n in (("train", 3), ("val", 2)):
        with open(root / f"{kind}_infos_{split}.pkl", "wb") as f:
            pickle.dump([scene(split, s) for s in range(n)], f)


@pytest.fixture(scope="module", params=["scannet", "arkit"])
def data_sets(request, tmp_path_factory):
    """The synthetic set of one kind, and the data config of that kind for
    the port and for the JAX package (small frames)."""
    kind = request.param
    root = tmp_path_factory.mktemp(kind)
    _write_set(root, kind)
    over = dict(SMALL_DATA, data_root=str(root), ann_train=f"{kind}_infos_train.pkl",
                ann_val=f"{kind}_infos_val.pkl")
    return (kind, dataclasses.replace(configs.get_config(kind).data, **over),
            dataclasses.replace(jconfigs.get_config(kind).data, **over))


@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
def test_prepare_scene_and_poses_match_jax(data_sets, train):
    kind, ours, ref = data_sets
    info = jdatasets.load_infos(f"{ours.data_root}/{ours.ann_train}")[0]
    got = prepare_scene(info, ours, train, np.random.RandomState(2), load_depth=True)
    want = jpipeline.prepare_scene(info, ref, train, np.random.RandomState(2), load_depth=True)
    _assert_tree_equal(got, want)
    assert got["imgs"].shape == (4 if train else 3, 3, 48, 64)
    assert got["img_shape"] == (45, 64) and got["gt_depth"].shape[1:] == (48, 64)
    if kind == "arkit":  # pose_center: the mean camera position (+ jitter)
        assert abs(float(got["origin"][2]) - 1.2) < (1.0 if train else 1e-5)
    _assert_tree_equal(scene_poses(info, ours, train, np.random.RandomState(3)),
                       jpipeline.scene_poses(info, ref, train, np.random.RandomState(3)))


def test_datasets_match_jax(data_sets):
    kind, ours, ref = data_sets
    for train in (True, False):
        ds = MultiViewDataset(ours, train=train, load_depth=train, seed=4)
        jds = jdatasets.MultiViewDataset(ref, train=train, load_depth=train, seed=4)
        assert len(ds) == len(jds) == (2 if train else 2)  # the train scene without GT goes
        for i in range(len(ds)):
            _assert_tree_equal(ds[i], jds[i])
            _assert_tree_equal(ds.gt_anno(i), jds.gt_anno(i))
            _assert_tree_equal(ds.gt_arrays(i), jds.gt_arrays(i))
        _assert_tree_equal(ds.scene_poses(0), jds.scene_poses(0))
    cb = CBGSDataset(MultiViewDataset(ours, seed=5), 4, seed=6)
    jcb = jdatasets.CBGSDataset(jdatasets.MultiViewDataset(ref, seed=5), 4, seed=6)
    assert cb.sample_indices == jcb.sample_indices and len(cb) == len(jcb) > 0
    _assert_tree_equal(cb[len(cb) - 1], jcb[len(jcb) - 1])
    _assert_tree_equal(cb.gt_anno(0), jcb.gt_anno(0))


@pytest.mark.parametrize("train,num_workers", [(True, 0), (False, 2)],
                         ids=["train_inline", "val_threads"])
def test_scene_loader_matches_jax(data_sets, train, num_workers):
    """Train batches read inline (the dataset's RandomState is drawn in
    scene order); val batches, which draw nothing, through two threads."""
    kind, ours, ref = data_sets
    kw = dict(batch_size=2, repeat_times=2, num_workers=num_workers, max_boxes=8, seed=1)
    loader = SceneLoader(MultiViewDataset(ours, train=train, seed=7), **kw)
    jl = jloader.SceneLoader(jdatasets.MultiViewDataset(ref, train=train, seed=7), **kw)
    try:
        assert len(loader) == len(jl) == 2
        for epoch in range(2):
            batches, jbatches = list(loader), list(jl)
            assert len(batches) == len(jbatches) == 2
            for b, jb in zip(batches, jbatches):
                _assert_tree_equal(b, jb, f"epoch {epoch}")
                assert b["imgs"].shape[:2] == (2, 4 if train else 3)
                if train:
                    assert b["gt_boxes"].shape == (2, 8, 7) and b["gt_mask"].any()
    finally:
        loader.close()
        jl.close()


def test_pad_gt_matches_jax():
    boxes, labels = _yawed(11, 9), np.arange(11)
    for max_boxes in (4, 11, 16):
        _assert_tree_equal(pad_gt(boxes, labels, max_boxes),
                           jloader.pad_gt(boxes, labels, max_boxes))
    assert pad_gt(boxes[:0], labels[:0], 4)[2].sum() == 0
