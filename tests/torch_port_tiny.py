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
