"""Per-view preprocessing, the port's copy of sgcdet_tpu/data/pipeline.py:
view sampling, keep-ratio resize to ``img_scale``, ImageNet normalisation,
bottom/right zero pad to ``pad_size``, uint16 depth / ``depth_shift``, the
projections at image and stride-4 resolution, and the scene origin (fixed,
or ARKit's mean camera position).

Host NumPy feeding fixed-shape device batches.  OpenCV (or PIL where OpenCV
is missing) decodes and resizes images; both are imported by the functions
that read image files, so the package imports where neither is installed.
"""
from __future__ import annotations

import os.path as osp

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def sample_view_ids(n_total, n_images, method, rng=None):
    """View indices: 'random' (with replacement iff n_images > n_total),
    'linear' (linspace) or 'uniform_random' (linspace with a jitter of the
    interior ids), sorted."""
    rng = rng or np.random
    ids = np.arange(n_total)
    if method == "random":
        ids = rng.choice(ids, n_images, replace=n_images > n_total)
    elif method == "uniform_random":
        base = np.linspace(0, n_total - 1, n_images, dtype=int)
        offsets = np.zeros_like(base)
        if n_images > 2:
            offsets[1:-1] = rng.randint(-2, 3, size=n_images - 2)
        ids = np.sort(np.clip(base + offsets, 0, n_total - 1))
    elif method == "linear":
        ids = np.linspace(0, n_total - 1, n_images, dtype=int)
    else:
        raise ValueError(f"unknown sample method {method}")
    return np.sort(ids)


def rescale_size(ori_w, ori_h, scale_wh):
    """mmcv's keep-ratio target size: scale = min(max_l / l, max_s / s),
    then int(dim * scale + 0.5)."""
    max_long, max_short = max(scale_wh), min(scale_wh)
    long_side, short_side = max(ori_w, ori_h), min(ori_w, ori_h)
    f = min(max_long / long_side, max_short / short_side)
    return int(ori_w * f + 0.5), int(ori_h * f + 0.5)


def load_and_preprocess_image(path, img_scale, pad_size, mean, std, to_rgb=True):
    """-> ((3, Hp, Wp) normalised f32 image, its resized (pre-pad) shape)."""
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(str(path), cv2.IMREAD_COLOR)  # BGR
        h, w = img.shape[:2]
        new_w, new_h = rescale_size(w, h, img_scale)
        img = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
        if to_rgb:
            img = img[:, :, ::-1]
    else:
        from PIL import Image

        pil = Image.open(str(path)).convert("RGB")
        w, h = pil.size
        new_w, new_h = rescale_size(w, h, img_scale)
        img = np.asarray(pil.resize((new_w, new_h), Image.BILINEAR))
    img = (img.astype(np.float32) - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    out = np.zeros((pad_size[0], pad_size[1], 3), np.float32)
    out[: img.shape[0], : img.shape[1]] = img
    return out.transpose(2, 0, 1), (img.shape[0], img.shape[1])


def imread_any(path):
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if img is not None:
            return img
    from PIL import Image

    return np.asarray(Image.open(str(path)))


def load_depth_map(path, depth_shift, pad_size=None):
    """uint16 depth png -> metres (0 = invalid), nearest-resized to
    ``pad_size``."""
    depth = np.asarray(imread_any(path)).astype(np.float32) / depth_shift
    if pad_size is not None and depth.shape != tuple(pad_size):
        cv2 = _cv2()
        if cv2 is not None:
            depth = cv2.resize(depth, (pad_size[1], pad_size[0]),
                               interpolation=cv2.INTER_NEAREST)
        else:
            from PIL import Image

            depth = np.asarray(Image.fromarray(depth).resize(
                (pad_size[1], pad_size[0]), Image.NEAREST))
    return depth


def build_projection_matrices(intrinsic, extrinsics, ori_h, img_h):
    """(proj_img (N, 3, 4) at image resolution, proj_feat4 (N, 4, 4) at
    stride 4) from a (3|4, 3|4) or per-view (N, ...) intrinsic at the
    original height ``ori_h`` and world->camera extrinsics (N, 4, 4)."""
    intrinsic = np.asarray(intrinsic, np.float32)
    extrinsics = np.asarray(extrinsics, np.float32)
    intr44 = np.zeros((len(extrinsics), 4, 4), np.float32)
    intr44[:] = np.eye(4)
    intr44[:, :3, :3] = intrinsic[..., :3, :3]
    k1 = intr44.copy()
    k1[:, :2] /= ori_h / img_h
    proj_img = np.einsum("nij,njk->nik", k1[:, :3, :3], extrinsics[:, :3, :])
    k4 = intr44.copy()
    k4[:, :2] /= ori_h / (img_h / 4)
    proj_feat4 = np.einsum("nij,njk->nik", k4, extrinsics)
    return proj_img.astype(np.float32), proj_feat4.astype(np.float32)


def _views_and_origin(info, data_cfg, train, rng):
    """The sampled view ids, their world->camera extrinsics (ScanNet's
    ``extrinsics`` after the axis alignment, or ARKit's inverted ``poses``)
    and the volume origin (jittered by ``shift_origin_std`` in train)."""
    n_images = data_cfg.n_images_train if train else data_cfg.n_images_test
    method = data_cfg.sample_method_train if train else "linear"
    ids = sample_view_ids(len(info["img_paths"]), n_images, method, rng)
    if "extrinsics" in info:  # ScanNet: axis-aligned world
        aam = info["annos"]["axis_align_matrix"].astype(np.float32)
        ext = [np.linalg.inv(aam @ np.asarray(info["extrinsics"][i], np.float32))
               for i in ids]
    else:  # ARKit
        ext = [np.linalg.inv(np.asarray(info["poses"][i], np.float32)) for i in ids]
    if data_cfg.origin == "fixed":
        origin = np.array([0.0, 0.0, 0.5], np.float32)
    else:
        poses = np.stack([np.asarray(p, np.float32) for p in info["poses"]])
        origin = poses[:, :3, 3].mean(axis=0).astype(np.float32)
    if train:
        origin = origin + rng.normal(0.0, data_cfg.shift_origin_std, 3).astype(np.float32)
    return ids, np.stack(ext), origin.astype(np.float32)


def _intrinsic(info):
    return info.get("intrinsics", info.get("intrinsic"))


def scene_poses(info, data_cfg, train, rng=None):
    """(origin (3,), proj_img (N, 3, 4), proj_feat4 (N, 4, 4)) of one scene
    at the configured ``img_shape`` without reading any image: the view
    sampling and origin of ``prepare_scene``, for whole-dataset geometry
    statistics (visibility budgets)."""
    _, extrinsics, origin = _views_and_origin(info, data_cfg, train, rng or np.random)
    proj_img, proj_feat4 = build_projection_matrices(
        _intrinsic(info), extrinsics, data_cfg.ori_shape[0], data_cfg.img_shape[0])
    return origin, proj_img, proj_feat4


def prepare_scene(info, data_cfg, train, rng=None, load_depth=False):
    """One scene of the infos pkl as fixed-shape arrays: imgs (N, 3, Hp, Wp),
    proj_img, proj_feat4, origin, img_shape and, with ``load_depth``,
    gt_depth (N, Hp, Wp)."""
    ids, extrinsics, origin = _views_and_origin(info, data_cfg, train, rng or np.random)
    imgs, img_shape = [], data_cfg.img_shape
    for i in ids:
        img, img_shape = load_and_preprocess_image(
            osp.join(data_cfg.data_root, info["img_paths"][i]), data_cfg.img_scale,
            data_cfg.pad_size, data_cfg.mean, data_cfg.std)
        imgs.append(img)
    proj_img, proj_feat4 = build_projection_matrices(
        _intrinsic(info), extrinsics, data_cfg.ori_shape[0], img_shape[0])
    out = dict(imgs=np.stack(imgs), proj_img=proj_img, proj_feat4=proj_feat4,
               origin=origin, img_shape=img_shape)
    if load_depth:
        out["gt_depth"] = np.stack([
            load_depth_map(osp.join(data_cfg.data_root, info["depth_paths"][i]),
                           data_cfg.depth_shift, data_cfg.pad_size) for i in ids])
    return out
