"""Shared tiny configuration and JAX-side helpers for the tests of the
PyTorch port (tests/test_torch_*.py).

The widths are cut (embed 32, 4 heads x 2 points, a 16x16x8 finest grid,
47x64 images, 4 views) so the JAX reference runs in seconds on the CPU;
the structure is the ScanNet config's.  Level 2 keeps 512 of its 2048
voxels with a 0.5 visibility budget, so the budget compaction (and the
counted DFA3D path) is on.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

IMG_SHAPE = (47, 64)
PAD = (48, 64)
N_VIEWS = 4


@pytest.fixture(scope="module", autouse=True)
def keep_global_torch_rng():
    """Leave torch's global CPU generator as the module found it.

    Building a module runs torch's default init, which draws from the global
    generator even where the weights are then replaced; other test files seed
    that generator once at import and draw their weights from it later.
    Imported by every tests/test_torch_*.py module."""
    with torch.random.fork_rng(devices=[]):
        yield


TINY_MODEL = dict(
    embed_dims=32, num_heads=4, num_points=2,
    n_voxels_list=((4, 4, 2), (8, 8, 4), (16, 16, 8)),
    topk_list=(64, 512), dbound=(0.2, 3.4, 0.4), n_classes=3,
    neck3d_out_channels=16, visibility_budget=(1.0, 1.0, 0.5),
)


def tiny_model_cfg(compute_dtype="float32", configs=None):
    """The tiny ModelConfig, built from ``configs.scannet()``: the JAX
    package's configs module by default (both models take it), or the
    port's (``sgcdet_tpu_torch.configs``)."""
    if configs is None:
        from sgcdet_tpu import configs
    return dataclasses.replace(configs.scannet().model,
                               compute_dtype=compute_dtype, **TINY_MODEL)


def randomize_batch_stats(tree, seed=7):
    """Random BN running statistics (nested dict of arrays -> NumPy), so a
    dropped or misnamed statistic cannot hide behind mean 0 / var 1."""
    rng = np.random.RandomState(seed)

    def walk(node, key=None):
        if hasattr(node, "items"):
            return {k: walk(v, k) for k, v in node.items()}
        shape = np.shape(node)
        if key == "var":
            return rng.uniform(0.7, 1.2, shape).astype(np.float32)
        return (rng.randn(*shape) * 0.2).astype(np.float32)

    return walk(tree)


def to_numpy_tree(tree):
    if hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.array(tree)


def assert_close_scaled(actual, expected, rel, name):
    """max |actual - expected| <= rel * max(|expected|, 1e-3)."""
    actual = np.asarray(actual, np.float32)
    expected = np.asarray(expected, np.float32)
    assert actual.shape == expected.shape, (name, actual.shape, expected.shape)
    scale = max(float(np.abs(expected).max()), 1e-3)
    err = float(np.abs(actual - expected).max())
    assert err <= rel * scale, f"{name}: max abs err {err:.3e} > {rel} x {scale:.3e}"


def sweep_inputs(c=32, seed=0, dbound=(0.2, 5.0, 0.4)):
    """Features and projections of the tiny indoor rig for one sweep call:
    (src, ref, src_proj, ref_proj, depth_values) as NumPy, with src the
    first neighbour of each view.  The 5 m planes fall behind some
    neighbour cameras."""
    from sgcdet_tpu_torch.models.depth_net import get_closest_frame_ids
    from sgcdet_tpu_torch.scene import example_scene

    rng = np.random.RandomState(seed)
    scene = example_scene(IMG_SHAPE, PAD, N_VIEWS, trajectory="indoor")
    h, w = PAD[0] // 4, PAD[1] // 4
    fea = rng.randn(N_VIEWS, c, h, w).astype(np.float32)
    nei = get_closest_frame_ids(N_VIEWS, 2)[:, 0]
    proj = scene["proj_feat4"]
    dv = np.arange(*dbound, dtype=np.float32) + dbound[2] / 2
    return fea[nei], fea, proj[nei], proj, dv


def dfa3d_inputs(heads, p, c, n=3, h=6, w=9, d=8, k=40, seed=0):
    """Random DFA3D operands as NumPy: value (n, h, w, heads*c), a softmaxed
    depth distribution (n, h, w, d), locations (n, k, heads, p, 3) that
    spill outside [0, 1] on every axis (off-image corners, depth bins past
    either end) and attention weights (n, k, heads, p)."""
    rng = np.random.RandomState(seed)
    value = rng.randn(n, h, w, heads * c).astype(np.float32)
    logits = rng.randn(n, h, w, d).astype(np.float32)
    dpt = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    locs = rng.uniform(-0.2, 1.2, (n, k, heads, p, 3)).astype(np.float32)
    attn = rng.uniform(0.0, 1.0, (n, k, heads, p)).astype(np.float32)
    return value, dpt.astype(np.float32), locs, attn


def windowed_inputs(n, h, w, k, heads, c, p, d, coherent, seed=0):
    """tests/test_dfa3d_windowed.py's DFA3D operands, made with numpy:
    bf16-rounded value (n, h, w, heads*c) and depth distribution (n, h, w,
    d) as torch tensors, locations that either sweep the image coherently
    with a small jitter (the sorted-queries regime) or scatter at random
    off every side, and softmaxed attention weights."""
    rng = np.random.RandomState(seed)
    value = torch.from_numpy(rng.randn(n, h, w, heads * c).astype(np.float32)).bfloat16()
    logits = rng.randn(n, h, w, d).astype(np.float32)
    dpt = torch.from_numpy(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).bfloat16()
    if coherent:
        t = np.arange(k, dtype=np.float32) / max(k - 1, 1)
        base = np.stack([(t * 7.0) % 1.0, t, t], -1)
        locs = base[None, :, None, None, :] + rng.uniform(-0.03, 0.03, (n, k, heads, p, 3))
    else:
        locs = rng.uniform(-0.15, 1.15, (n, k, heads, p, 3))
    a = rng.randn(n, k, heads, p).astype(np.float32)
    attn = np.exp(a) / np.exp(a).sum(-1, keepdims=True)
    return value, dpt, torch.from_numpy(locs.astype(np.float32)), torch.from_numpy(attn)


def graph_has(t, name):
    """True when the autograd graph behind tensor ``t`` holds a node of
    type ``name`` (e.g. the ``_DFA3DBackward`` of the port's Function)."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        if type(fn).__name__ == name:
            return True
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return False


# The contention cases of the backward kernels: tests/test_torch_backward_
# contention.py holds the plain versions against JAX on them (CPU), and
def sweep_edge_rig(n=2, h=7, w=9, c=128, seed=0):
    """(src, ref, src_proj, ref_proj, depth_values) as NumPy for a sweep
    whose H * W = 63 pixels no 32- or 64-pixel tile divides and whose D = 5
    planes no group of 2 or 4 planes divides.  ref_proj is the identity and
    each view's source camera passes through one plane (plane 1 in view 0,
    plane 3 in view 1): z = 0 on that whole plane, so its coordinates are
    inf, and 0 / 0 = NaN in x at column 2; the planes before it lie behind
    the camera and the ones after it in front, partly off the image."""
    rng = np.random.RandomState(seed)
    src = rng.randn(n, c, h, w).astype(np.float32)
    ref = rng.randn(n, c, h, w).astype(np.float32)
    dv = np.arange(0.4, 2.1, 0.4, dtype=np.float32)[:5]
    ref_proj = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    src_proj = ref_proj.copy()
    for view in range(n):
        through = dv[1 + 2 * (view % 2)]
        src_proj[view, 0, 3] = -2 * through  # x numerator 0 at column 2
        src_proj[view, 1, 3] = 0.3
        src_proj[view, 2, 3] = -through      # z = depth - through
    return src, ref, src_proj, ref_proj, dv


# tests/test_torch_cuda.py the kernels against the plain versions (card).
SWEEP_CONTENTION = ("tile_collapse", "image_collapse", "integer_grid", "plane_behind")
DFA3D_CONTENTION = ("one_corner", "counted")
DFA3D_S1_CONTENTION = ("s1_one_corner", "s1_counted", "s1_long_list")


def sweep_contention_case(name, n=2, h=13, w=21, c=128, d=4, seed=0):
    """(src, ref, x_eff, y_eff, g) as f32 NumPy for one contention case of
    the sweep backward, on a map that no 8 x 16 tile divides:

    * ``tile_collapse``: every 8 x 16 tile of reference pixels samples one
      fractional src point per plane, so the tile's pixels all add into the
      same four src rows (the last tile onto the last column);
    * ``image_collapse``: every pixel of a plane samples one point;
    * ``integer_grid``: integer coordinates from -1 to the size, the first
      and last row and column included (one corner of weight 1);
    * ``plane_behind``: the coordinates of a rig whose first plane lies
      behind the source camera (z < 0 at every pixel), by the homography of
      ``models/depth_net.py::_warp_grid``.
    """
    rng = np.random.RandomState(seed)
    src = rng.randn(n, h, w, c).astype(np.float32)
    ref = rng.randn(n, h, w, c).astype(np.float32)
    g = rng.randn(n, d, h * w).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    if name == "tile_collapse":
        tile = ((ys // 8) * -(-w // 16) + xs // 16).ravel()
        ntiles = int(tile.max()) + 1
        px = rng.uniform(-0.5, w - 0.5, (n, d, ntiles))
        py = rng.uniform(-0.5, h - 0.5, (n, d, ntiles))
        px[..., -1] = w - 1.0
        x, y = px[..., tile], py[..., tile]
    elif name == "image_collapse":
        x = np.broadcast_to(rng.uniform(0, w - 1, (n, d, 1)), (n, d, h * w))
        y = np.broadcast_to(rng.uniform(0, h - 1, (n, d, 1)), (n, d, h * w))
    elif name == "integer_grid":
        x = rng.randint(-1, w + 1, (n, d, h * w))
        y = rng.randint(-1, h + 1, (n, d, h * w))
        x[:, :, ::5], y[:, :, 1::5] = w - 1, h - 1
        x[:, :, 2::7], y[:, :, 3::7] = 0, 0
    elif name == "plane_behind":
        rot = np.eye(3) + rng.uniform(-1e-3, 1e-3, (n, 3, 3))
        trans = np.array([0.3, -0.2, -1.0])
        depths = np.array([0.5, 1.5, 2.5, 3.5])[:d]
        xyz = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)], 0)
        p = (np.einsum("nij,jk->nik", rot, xyz)[:, :, None] * depths[None, None, :, None]
             + trans[None, :, None, None])
        assert (p[:, 2, 0] < 0).all() and (p[:, 2, 1:] > 0).all()
        x = p[:, 0] / p[:, 2] * (w / (w - 1)) - 0.5
        y = p[:, 1] / p[:, 2] * (h / (h - 1)) - 0.5
    else:
        raise ValueError(name)
    return (src, ref, np.ascontiguousarray(x, np.float32),
            np.ascontiguousarray(y, np.float32), g)


def dfa3d_contention_case(name, n=3, h=8, w=16, d=8, k=20, heads=8, p=4, c=32,
                          seed=0):
    """(value, depth, locs, attn, g, valid_counts) as NumPy for one
    contention case of the DFA3D backward at c channels per head;
    valid_counts is None or (n,) int32.  h and w are powers of two, so a
    pixel centre's location times the size is exact in f32 and every
    implementation floors it alike (the location gradient jumps there):

    * ``one_corner``: all heads and points of a query sample one pixel
      centre (loc * size - 0.5 an integer: one corner of weight 1), and
      the queries share three pixels, the last row and column's among them;
    * ``counted``: ``dfa3d_inputs``' spread of locations, valid_counts 0 for
      the first view, k // 3 for the second and k for the rest;
    * ``long_list``: every counted query of a view on one pixel centre of
      its own (the last row and column's in the last view), at least 4096
      queries; valid_counts 0 for the first view, every query for the
      second, all but 7 for the rest, whose uncounted queries keep the
      spread of locations.

    The ``s1_`` cases (DFA3D_S1_CONTENTION) are the same at stage 1: one
    head and one point (heads and p are ignored).
    """
    stage1 = name.startswith("s1_")
    if stage1:
        name, heads, p = name[3:], 1, 1
    if name == "long_list":
        k = max(k, 4096)
    value, dpt, locs, attn = dfa3d_inputs(heads, p, c, n=n, h=h, w=w, d=d, k=k,
                                          seed=seed)
    rng = np.random.RandomState(seed + 1)
    g = rng.randn(n, k, heads * c).astype(np.float32)
    counts = None
    if name == "one_corner":
        pix = np.array([[0, 0], [h // 2, w // 3], [h - 1, w - 1]])[rng.randint(0, 3, (n, k))]
        locs[..., 0] = ((pix[..., 1] + 0.5) / w)[:, :, None, None]
        locs[..., 1] = ((pix[..., 0] + 0.5) / h)[:, :, None, None]
    elif name == "counted":
        counts = np.full(n, k, np.int32)
        counts[0], counts[1] = 0, k // 3
    elif name == "long_list":
        counts = np.full(n, k - 7, np.int32)
        counts[0], counts[1] = 0, k
        for view in range(n):
            y, x = ((h - 1, w - 1) if view == n - 1 and n > 2
                    else (1 + view % (h - 2), 2 + 3 * view % (w - 3)))
            locs[view, :counts[view], ..., 0] = (x + 0.5) / w
            locs[view, :counts[view], ..., 1] = (y + 0.5) / h
    else:
        raise ValueError(name)
    return value, dpt, locs, attn, g, counts


# ---------------------------------------------------------------------------
# the CLI's on-disk synthetic ScanNet set (tests/test_torch_cli.py,
# tests/test_torch_parallel.py)
# ---------------------------------------------------------------------------

# tiny-model overrides of tests/test_cli_end_to_end.py with ffn_dropout 0,
# and the data fields for write_scannet_set's small frames (90 x 128,
# resized to 45 x 64 and padded to 48 x 64)
CLI_OVERRIDES = [
    "model.n_voxels_list=((2,2,1),(4,4,2),(8,8,4))",
    "model.voxel_size_list=((1.28,1.28,1.6),(0.64,0.64,0.8),(0.32,0.32,0.4))",
    "model.topk_list=(32,256)",
    "model.embed_dims=16",
    "model.num_heads=2",
    "model.dbound=(0.2,5.0,0.8)",
    "model.limit=4",
    "model.centerness_topk=4",
    "model.test_cfg.nms_pre=64",
    "model.ffn_dropout=0.0",
    "data.img_scale=(64,48)",
    "data.pad_size=(48,64)",
    "data.img_shape=(45,64)",
    "data.ori_shape=(90,128)",
    "data.n_images_train=4",
    "data.n_images_test=4",
    "data.max_boxes=8",
    "data.repeat_times=1",
]

CLI_FRAME = (90, 128)


def write_scannet_set(root, n_train=2, n_val=2, n_views=5):
    """ScanNet-format infos pkls of ``n_train`` / ``n_val`` scenes under
    ``root`` (JPEG frames, uint16 PNG depth maps, 4x4 intrinsics and
    extrinsics, two aligned GT boxes a scene), cameras on a small loop
    looking outward, as in tests/test_cli_end_to_end.py at small frames."""
    import pickle
    from pathlib import Path

    import cv2

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)

    def cam_to_world(s, v):
        ang = 2 * np.pi * v / n_views + 0.3 * s
        c, si = np.cos(ang), np.sin(ang)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = np.array([[c, 0, si], [-si, 0, c], [0, -1, 0]], np.float32)
        m[:3, 3] = [0.4 * c, 0.4 * si, 1.2 + 0.1 * s]
        return m

    def scene(split, s):
        info = dict(img_paths=[], depth_paths=[], extrinsics=[])
        for v in range(n_views):
            ip, dp = f"{split}{s}_v{v}.jpg", f"{split}{s}_v{v}.png"
            cv2.imwrite(str(root / ip), rng.randint(0, 255, CLI_FRAME + (3,), np.uint8))
            cv2.imwrite(str(root / dp), rng.randint(0, 5000, (60, 80)).astype(np.uint16))
            info["img_paths"].append(ip)
            info["depth_paths"].append(dp)
            info["extrinsics"].append(cam_to_world(s, v))
        intr = np.eye(4, dtype=np.float32)
        intr[0, 0] = intr[1, 1] = 100.0
        intr[0, 2], intr[1, 2] = 64.0, 45.0
        info["intrinsics"] = intr
        boxes = np.array([[0.3, 0.2, 0.6, 0.8, 0.8, 0.6],
                          [-0.5, -0.4, 0.8, 0.6, 0.6, 0.5]], np.float32)
        info["annos"] = dict(axis_align_matrix=np.eye(4, dtype=np.float32), gt_num=2,
                             gt_boxes_upright_depth=boxes, **{"class": np.array([2, 7])})
        return info

    for split, n in (("train", n_train), ("val", n_val)):
        with open(root / f"scannet_infos_{split}.pkl", "wb") as f:
            pickle.dump([scene(split, s) for s in range(n)], f)
    return root


def ring_scene_pairs(mcfg):
    """The two ranks' scenes of the data-parallel tests, each pair from the
    ring-rig train scene of tests/test_torch_train.py (``a``):

    * ``"targets"``: ``a``, and ``a`` with other ground truth (the boxes
      turned by 180 degrees about z, the next labels);
    * ``"images"``: ``a``, and ``a`` with the images of RandomState(5).

    In the second pair the ranks' batch statistics differ, and the
    gradients are decided by rounding at these widths: a 1e-7 relative
    nudge of the images moves the JAX package's own mesh-step gradients of
    the depth net (its U-Nets at their 3 x 4 bottoms, the matching
    extractor) by up to 2 % of their scale, as much as they differ from the
    port's; the two packages' gradients differ by 1-24 % for each of the
    draws RandomState(20)-(35) tried in its place, and the port's sampling
    offsets' gradients move by 0.2 % with its thread count."""
    from sgcdet_tpu_torch.scene import example_scene, example_train_scene

    a = example_train_scene(IMG_SHAPE, PAD, N_VIEWS, mcfg.n_classes,
                            mcfg.downsample_factor, trajectory="ring")
    boxes = a["gt_boxes"].copy()
    boxes[:, :2] *= -1
    other = example_scene(IMG_SHAPE, PAD, N_VIEWS, rng=np.random.RandomState(5),
                          trajectory="ring")["imgs"]
    return {"targets": [a, dict(a, gt_boxes=boxes,
                                gt_labels=(a["gt_labels"] + 1) % mcfg.n_classes)],
            "images": [a, dict(a, imgs=other)]}


def state_digest(state):
    """{name: sha1 of the tensor's bytes} of a state dict."""
    import hashlib

    return {k: hashlib.sha1(v.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
            for k, v in state.items()}


def bn_sync_case():
    """Inputs of the synced-BatchNorm test: per rank an input (3, 6, 5, 4, 2)
    and an output gradient, and the BN's scale, bias and running
    statistics."""
    rng = np.random.RandomState(10)
    xs = [(rng.randn(3, 6, 5, 4, 2) * s + m).astype(np.float32) for s, m in ((2, 1), (1, -2))]
    gs = [rng.randn(3, 6, 5, 4, 2).astype(np.float32) for _ in xs]
    params = dict(scale=rng.uniform(0.5, 2, 6).astype(np.float32),
                  bias=rng.randn(6).astype(np.float32),
                  mean=(rng.randn(6) * 0.2).astype(np.float32),
                  var=rng.uniform(0.7, 1.2, 6).astype(np.float32))
    return xs, gs, params


def _dp_worker(out_dir, weights):
    """One rank of the data-parallel tests (gloo, from torchrun's
    environment): the synced BN of ``bn_sync_case`` and one DP train step
    of the tiny config from ``weights`` on its scene of
    each pair of ``ring_scene_pairs``, and the targets pair's with
    ``depth_remat``; writes ``rank<r>.pt``."""
    import dataclasses

    from sgcdet_tpu_torch import configs, parallel
    from sgcdet_tpu_torch.models import SGCDet, layers
    from sgcdet_tpu_torch.train import make_optimizer, make_train_step

    ctx = parallel.from_env("cpu")
    out = {}
    xs, gs, p = bn_sync_case()
    bn = layers.BatchNorm3d(6).train()
    with torch.no_grad():
        for name, key in (("weight", "scale"), ("bias", "bias"),
                          ("running_mean", "mean"), ("running_var", "var")):
            getattr(bn, name).copy_(torch.from_numpy(p[key]))
    x = torch.from_numpy(xs[ctx.rank]).requires_grad_()
    with layers.sync_batchnorm(ctx.group):
        y = bn(x)
    (y * torch.from_numpy(gs[ctx.rank])).sum().backward()
    grads = torch.cat([bn.weight.grad, bn.bias.grad])
    parallel.all_reduce_mean_(grads, ctx.group, "gradients")
    out["bn"] = dict(y=y.detach(), x_grad=x.grad, weight_grad=grads[:6],
                     bias_grad=grads[6:], running_mean=bn.running_mean.clone(),
                     running_var=bn.running_var.clone())
    with torch.no_grad():  # eval mode and frozen BNs do not communicate
        before = dict(parallel.COUNTS)
        bn.eval()(x)
        frozen = layers.BatchNorm3d(6, frozen=True).train()
        with layers.sync_batchnorm(ctx.group):
            frozen(x)
        out["bn_quiet"] = parallel.COUNTS == before

    base = configs.scannet()
    mcfg = dataclasses.replace(tiny_model_cfg(configs=configs), ffn_dropout=0.0)
    cfg = dataclasses.replace(base, model=mcfg, data=dataclasses.replace(
        base.data, img_shape=IMG_SHAPE, pad_size=PAD))
    for pair, scenes in ring_scene_pairs(mcfg).items():
        model = SGCDet(mcfg, IMG_SHAPE, device="cpu")
        model.load_state_dict(torch.load(weights, weights_only=True))
        optimizer = make_optimizer(model, cfg.train)
        step = make_train_step(model, cfg, optimizer, group=ctx.group)
        counts = dict(parallel.COUNTS)
        metrics = step(scenes[ctx.rank], torch.Generator().manual_seed(0))
        run = dict(counts={k: v - counts[k] for k, v in parallel.COUNTS.items()},
                   n_bn=sum(isinstance(m, layers._F32BatchNorm) and not m.frozen
                            for m in model.modules()),
                   metrics={k: v.detach() for k, v in metrics.items()},
                   digest=state_digest(model.state_dict()))
        if ctx.rank == 0:  # the ranks' states are compared by digest
            run["grads"] = {n: q.grad for n, q in model.named_parameters()}
            run["stats"] = {n: b for n, b in model.state_dict().items()
                            if n.endswith(("running_mean", "running_var"))}
        out[pair] = run
    # the targets pair's step again with depth_remat: the recomputation's
    # synced BNs all-reduce again (bn_sync_recompute) and move nothing
    rcfg = dataclasses.replace(mcfg, depth_remat=True)
    model = SGCDet(rcfg, IMG_SHAPE, device="cpu")
    model.load_state_dict(torch.load(weights, weights_only=True))
    step = make_train_step(model, dataclasses.replace(cfg, model=rcfg),
                           make_optimizer(model, cfg.train), group=ctx.group)
    counts = dict(parallel.COUNTS)
    metrics = step(ring_scene_pairs(mcfg)["targets"][ctx.rank], torch.Generator().manual_seed(0))
    out["targets_remat"] = dict(
        counts={k: v - counts[k] for k, v in parallel.COUNTS.items()},
        n_depth_bn=sum(isinstance(m, layers._F32BatchNorm) and not m.frozen
                       for m in model.depth_head.modules()),
        metrics={k: v.detach() for k, v in metrics.items()},
        digest=state_digest(model.state_dict()))
    torch.save(out, f"{out_dir}/rank{ctx.rank}.pt")
    parallel.shutdown(ctx)


# ---------------------------------------------------------------------------
# view sharding (tests/test_torch_view_parallel.py): the tiny config and
# 4-view ring scene of tests/test_multichip.py, with the depth loss on
# ---------------------------------------------------------------------------

VIEW_MODEL = dict(
    n_voxels_list=((4, 4, 2), (8, 8, 4), (16, 16, 8)), topk_list=(32, 128),
    embed_dims=32, n_classes=5, limit=4, centerness_topk=4, compute_dtype="float32",
    depth_loss=True,
)
VIEW_IMG, VIEW_PAD, VIEW_BOXES, VIEW_N = (60, 80), (64, 80), 8, 4


def view_config(configs=None, **model_kw):
    """tests/test_multichip.py's tiny config with the depth loss on and
    ``model_kw``, from ``configs`` (the JAX package's by default, or the
    port's)."""
    if configs is None:
        from sgcdet_tpu.configs import config as configs
    base = configs.scannet()
    return dataclasses.replace(
        base, model=dataclasses.replace(base.model, **dict(VIEW_MODEL, **model_kw)),
        data=dataclasses.replace(base.data, img_shape=VIEW_IMG, pad_size=VIEW_PAD,
                                 max_boxes=VIEW_BOXES))


def view_scene(downsample_factor):
    """tests/test_multichip.py's scene (the 4-view ring, its boxes from
    RandomState(0)) with metric depth maps of RandomState(1) for the depth
    loss, as NumPy."""
    from sgcdet_tpu_torch.scene import example_scene

    scene = example_scene(VIEW_IMG, VIEW_PAD, VIEW_N)
    rng = np.random.RandomState(0)
    dh, dw = VIEW_PAD[0] // 4 * downsample_factor, VIEW_PAD[1] // 4 * downsample_factor
    return dict(
        scene,
        gt_boxes=np.abs(rng.randn(VIEW_BOXES, 7)).astype(np.float32) * 0.5 + 0.2,
        gt_labels=np.zeros((VIEW_BOXES,), np.int32),
        gt_mask=np.arange(VIEW_BOXES) < 3,
        gt_depth=np.random.RandomState(1).uniform(0.5, 4.5, (VIEW_N, dh, dw)).astype(
            np.float32))


def view_module_case():
    """Inputs of the module-level view cases: a BatchNorm2d input over 4
    views (4, 6, 5, 4) with its output gradient and the BN's parameters,
    and the depth net's FPN features (4, 32, 16, 20) and output gradient."""
    rng = np.random.RandomState(11)
    bn = dict(x=(rng.randn(4, 6, 5, 4) * 2 + 1).astype(np.float32),
              g=rng.randn(4, 6, 5, 4).astype(np.float32),
              scale=rng.uniform(0.5, 2, 6).astype(np.float32),
              bias=rng.randn(6).astype(np.float32),
              mean=(rng.randn(6) * 0.2).astype(np.float32),
              var=rng.uniform(0.7, 1.2, 6).astype(np.float32))
    feats = rng.randn(VIEW_N, 32, VIEW_PAD[0] // 4, VIEW_PAD[1] // 4).astype(np.float32)
    return bn, feats


def _view_worker(out_dir, weights):
    """One process of the view-sharding tests (gloo, from torchrun's
    environment): with WORLD_SIZE 2 a rank of the view-sharded runs, with
    WORLD_SIZE 1 the single-process runs they are held to.  Each run is
    recorded with the collectives it made by kind: a BatchNorm2d and the
    depth net at module level in train mode (output, input and parameter
    gradients, running statistics), one train step of ``view_config`` from
    ``weights`` with ffn_dropout 0 (the JAX comparison) and 0.1 (each
    dropout call's mask recorded), the latter again with depth_remat, and
    the eval forward; writes ``view_rank<r>.pt`` or ``view_single.pt``."""
    from sgcdet_tpu_torch import configs, infer, parallel
    from sgcdet_tpu_torch.models import SGCDet, layers
    from sgcdet_tpu_torch.models.depth_net import DepthNetFusion
    from sgcdet_tpu_torch.train import (make_optimizer, make_train_step,
                                        make_view_sharded_eval_step,
                                        make_view_sharded_train_step)

    ctx = parallel.from_env("cpu")
    group = ctx.group
    views = slice(None) if group is None else slice(2 * ctx.rank, 2 * ctx.rank + 2)
    out = {}

    def counted(fn):
        before = dict(parallel.COUNTS)
        run = fn()
        run["counts"] = {k: v - before[k] for k, v in parallel.COUNTS.items() if v != before[k]}
        return run

    def sum_grads(module):
        grads = torch.cat([p.grad.reshape(-1) for p in module.parameters()])
        if group is not None:
            torch.distributed.all_reduce(grads, group=group)
        return grads

    bn_case, feats = view_module_case()

    def bn_run():
        bn = layers.BatchNorm2d(6).train()
        with torch.no_grad():
            for name, key in (("weight", "scale"), ("bias", "bias"),
                              ("running_mean", "mean"), ("running_var", "var")):
                getattr(bn, name).copy_(torch.from_numpy(bn_case[key]))
        x = torch.from_numpy(bn_case["x"][views]).requires_grad_()
        with parallel.view_sharding(group):
            y = bn(x)
        (y * torch.from_numpy(bn_case["g"][views])).sum().backward()
        return dict(y=y.detach(), x_grad=x.grad, param_grads=sum_grads(bn),
                    running_mean=bn.running_mean.clone(), running_var=bn.running_var.clone())

    cfg = view_config(configs, ffn_dropout=0.0)
    scene = view_scene(cfg.model.downsample_factor)

    def depth_run():
        net = DepthNetFusion(cfg.model.dbound, 2, mono_channels=32).train()
        layers.init_weights(net, torch.Generator().manual_seed(4))
        f = torch.from_numpy(feats[views]).requires_grad_()
        imgs = torch.from_numpy(scene["imgs"][views])
        proj = torch.from_numpy(scene["proj_feat4"][views])
        with parallel.view_sharding(group):
            dpt = net(f, imgs, proj)
        g = torch.from_numpy(np.random.RandomState(12).randn(*dpt.shape[1:]).astype(np.float32))
        (dpt * g).sum().backward()
        return dict(dpt=dpt.detach(), feats_grad=f.grad, param_grads=sum_grads(net),
                    stats={n: b.clone() for n, b in net.state_dict().items()
                           if n.endswith(("running_mean", "running_var"))})

    out["bn"] = counted(bn_run)
    out["depth_net"] = counted(depth_run)

    def model_of(mcfg):
        model = SGCDet(mcfg, VIEW_IMG, device="cpu")
        model.load_state_dict(torch.load(weights, weights_only=True))
        return model

    masks = []
    dropout = layers.dropout

    def recorded(x, rate, generator):
        y = dropout(x, rate, generator)
        if rate > 0:
            masks.append(state_digest({"mask": y == 0})["mask"])
        return y

    layers.dropout = recorded
    # the single process also takes the dropout-free view-sharded step in a
    # group of one process (its BNs' statistics the view mode's, E[x^2] -
    # E[x]^2 as the JAX package's, where F.batch_norm's differ in rounding)
    runs = [("step", dict(ffn_dropout=0.0), group), ("dropout_step", {}, group),
            ("remat_step", dict(depth_remat=True), group)]
    if group is None:
        torch.distributed.init_process_group("gloo", store=torch.distributed.HashStore(),
                                             rank=0, world_size=1)
        runs.append(("view1_step", dict(ffn_dropout=0.0), torch.distributed.group.WORLD))
    for name, kw, run_group in runs:
        run_cfg = view_config(configs, **kw)
        model = model_of(run_cfg.model)
        optimizer = make_optimizer(model, run_cfg.train)
        step = (make_train_step(model, run_cfg, optimizer) if run_group is None else
                make_view_sharded_train_step(model, run_cfg, optimizer, run_group))
        masks.clear()

        def step_run():
            metrics = step(scene, torch.Generator().manual_seed(0))
            return dict(metrics={k: v.detach() for k, v in metrics.items()},
                        digest=state_digest(model.state_dict()), masks=list(masks))

        run = counted(step_run)
        run["n_depth_bn"] = sum(isinstance(m, layers._F32BatchNorm) and not m.frozen
                                for m in model.depth_head.modules())
        if name in ("step", "view1_step") and ctx.rank == 0:  # the ranks' by digest
            run["state"] = model.state_dict()
            run["grads"] = {n: q.grad for n, q in model.named_parameters()}
        out[name] = run
    layers.dropout = dropout

    model = model_of(cfg.model)
    evaluate = (infer.forward_scene if group is None else
                make_view_sharded_eval_step(model, cfg, group))
    out["eval"] = counted(lambda: dict(evaluate(model, scene) if group is None
                                       else evaluate(scene)))
    suffix = "single" if group is None else f"rank{ctx.rank}"
    torch.save(out, f"{out_dir}/view_{suffix}.pt")
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def _view_collectives_worker(device):
    """One rank of the view collectives' check (gloo from torchrun's
    environment, tensors on ``device``): ``parallel.gather_views`` of f32,
    bf16 and bool slices against their concatenation, its backward (a
    reduce-scatter sum: each rank's slice gets the sum of every rank's
    gradient of it) and ``sum_over_ranks`` with its backward, at 2 views a
    rank."""
    import torch.distributed as dist

    from sgcdet_tpu_torch import parallel

    dist.init_process_group("gloo")
    group = dist.group.WORLD
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device(device)
    rows = [torch.arange(2 * 3 * 5, dtype=torch.float32).reshape(2, 3, 5) + 100 * r
            for r in range(world)]
    x = rows[rank].to(dev).requires_grad_()
    gathered = parallel.gather_views(x, group)
    assert torch.equal(gathered.detach().cpu(), torch.cat(rows))
    weight = torch.arange(gathered.numel(), dtype=torch.float32).reshape(gathered.shape)
    (gathered * weight.to(dev) * (rank + 1)).sum().backward()
    share = sum(range(1, world + 1))  # every rank's gradient of this rank's slice
    assert torch.equal(x.grad.cpu(), weight[2 * rank:2 * rank + 2] * share)
    for dtype in (torch.bfloat16, torch.bool):
        t = torch.cat(rows).to(dtype)
        got = parallel.gather_views(t[2 * rank:2 * rank + 2].to(dev), group)
        assert got.dtype == dtype and torch.equal(got.cpu(), t)
    y = torch.tensor([1.0, 2.0], device=dev, requires_grad=True)
    total = parallel.sum_over_ranks(y * (rank + 1), group, "view_depth_loss")
    assert torch.equal(total.detach().cpu(), torch.tensor([1.0, 2.0]) * share)
    (total * torch.tensor([3.0, 4.0], device=dev)).sum().backward()
    assert torch.equal(y.grad.cpu(), torch.tensor([3.0, 4.0]) * world * (rank + 1))
    print(f"view collectives ok on {device}")
    dist.destroy_process_group()


def launch_view_collectives(device, timeout=120):
    """2 gloo processes of ``_view_collectives_worker`` on ``device``;
    returns their outputs (each asserted to have passed)."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    repo = str(Path(__file__).resolve().parents[1])
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--view-collectives", device],
        env=dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1", MASTER_ADDR="localhost",
                 MASTER_PORT=port, RANK=str(rank), WORLD_SIZE="2"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            assert p.returncode == 0 and "view collectives ok" in out, out[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    return outs


# ``python tests/torch_port_tiny.py --cli <flags>`` runs the port's CLI (and
# ``--dp <out_dir> <weights>`` one rank of ``_dp_worker``, ``--view <out_dir>
# <weights>`` one process of ``_view_worker``, ``--view-collectives <device>``
# one rank of ``_view_collectives_worker``) in a subprocess
# of the tests, which then asserts that it imported none of jax, flax and
# the JAX package (tensorflow, which torch's tensorboard writer would import
# slowly, is blocked).  With SGCDET_TEST_DUMP set, the CLI's model is saved
# there as rank<r>.pt when it returns.
PORT_ONLY = "port only: jax, flax and sgcdet_tpu absent"

if __name__ == "__main__":
    import os
    import sys

    sys.modules["tensorflow"] = None
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "2")))
    if sys.argv[1] == "--cli":
        import sgcdet_tpu_torch.train as port_train
        from sgcdet_tpu_torch.cli import main

        built = []
        init_train_state = port_train.init_train_state
        port_train.init_train_state = lambda *a, **k: built.append(
            init_train_state(*a, **k)) or built[-1]
        main(sys.argv[2:])
        print(f"model sweep_band: {built[-1][0].depth_head.sweep_band}")
        if os.environ.get("SGCDET_TEST_DUMP"):
            torch.save(built[-1][0].state_dict(), os.path.join(
                os.environ["SGCDET_TEST_DUMP"], f"rank{os.environ.get('RANK', '0')}.pt"))
    elif sys.argv[1] == "--dp":
        _dp_worker(*sys.argv[2:4])
    elif sys.argv[1] == "--view":
        _view_worker(*sys.argv[2:4])
    elif sys.argv[1] == "--view-collectives":
        _view_collectives_worker(sys.argv[2])
    present = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "sgcdet_tpu")]
    assert not present, present
    print(PORT_ONLY)
