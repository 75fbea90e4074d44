"""Modules of the PyTorch port against the JAX package at float32, on the CPU.

Each case initializes the flax module, randomizes its BatchNorm statistics,
converts the parameters with ``sgcdet_tpu_torch.convert.state_dict_from_flax``
and runs both on the same seeded NumPy inputs:

* layers: f32 BatchNorm on bf16 input, nearest / linear interpolation;
* the 2D trunk (ResNet-50 -> FPN) and the depth net (matching extractor,
  plane sweep, U-Nets, softmax);
* the lifting (AdaptiveSparseVolume) with the visibility budget on;
* the 3D neck and the ScanNet head;
* top-k tie order and fully masked voxels in the lifting.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgcdet_tpu.models import layers as jlayers
from sgcdet_tpu.models.depth_net import DepthNetFusion as JDepthNet
from sgcdet_tpu.models.det_head import ImVoxelHead as JHead
from sgcdet_tpu.models.fpn import FPN as JFPN
from sgcdet_tpu.models.neck3d import FastIndoorImVoxelNeck as JNeck3D
from sgcdet_tpu.models.resnet import ResNet as JResNet
from sgcdet_tpu.models.sparse_head import AdaptiveSparseVolume as JSparse

from sgcdet_tpu_torch.convert import state_dict_from_flax
from sgcdet_tpu_torch.models import layers
from sgcdet_tpu_torch.models.depth_net import DepthNetFusion
from sgcdet_tpu_torch.models.det_head import ImVoxelHead
from sgcdet_tpu_torch.models.fpn import FPN
from sgcdet_tpu_torch.models.neck3d import FastIndoorImVoxelNeck
from sgcdet_tpu_torch.models.resnet import ResNet50
from sgcdet_tpu_torch.models.sparse_head import AdaptiveSparseVolume, top_k_indices
from sgcdet_tpu_torch.models.view_transformer import DeformCrossAttention
from sgcdet_tpu_torch.scene import example_scene

from torch_port_tiny import (  # noqa: F401 (keep_global_torch_rng is autouse)
    IMG_SHAPE,
    N_VIEWS,
    PAD,
    assert_close_scaled,
    keep_global_torch_rng,
    randomize_batch_stats,
    tiny_model_cfg,
)


def _load(module, params, stats, prefix):
    """Flax subtree -> port module (strict: every key on both sides)."""
    sd = state_dict_from_flax({prefix: params}, {prefix: stats} if stats else {})
    module.load_state_dict({k[len(prefix) + 1:]: v for k, v in sd.items()},
                           strict=True)
    return module.eval()


def test_batchnorm_computes_in_f32_and_keeps_bf16():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 5, 6).astype(np.float32) * 3
    jbn = jlayers.BatchNorm()
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    stats = randomize_batch_stats(v["batch_stats"])
    p = {"scale": rng.uniform(0.5, 2, 8).astype(np.float32),
         "bias": rng.randn(8).astype(np.float32)}
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    expected = jbn.apply({"params": p, "batch_stats": stats}, xb)
    bn = layers.BatchNorm2d(8).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
        got = bn(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    # both compute in f32 and round once to bf16: one bf16 ulp apart at most
    assert_close_scaled(got.float().numpy(), np.asarray(expected, np.float32),
                        2.0 ** -7, "bf16 batchnorm")


@pytest.mark.parametrize("size", [(15, 20), (6, 8), (3, 4)])
def test_interpolations_match_jax(size):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 8, 10).astype(np.float32)
    np.testing.assert_array_equal(
        layers.interpolate_nearest_size(torch.from_numpy(x), size).numpy(),
        np.asarray(jlayers.interpolate_nearest_size(jnp.asarray(x), size)))
    vol = rng.randn(1, 4, *size, 5).astype(np.float32)
    big = (2 * size[0], 2 * size[1], 10)
    assert_close_scaled(
        layers.interpolate_linear(torch.from_numpy(vol), big).numpy(),
        np.asarray(jlayers.interpolate_linear(jnp.asarray(vol), big)),
        1e-6, "trilinear")


def test_trunk_and_depth_net_match_jax():
    scene = example_scene(IMG_SHAPE, PAD, N_VIEWS, trajectory="indoor")
    imgs = jnp.asarray(scene["imgs"])
    dbound = (0.2, 5.0, 0.4)
    jb, jf = JResNet(depth=50), JFPN(out_channels=64)
    jd = JDepthNet(dbound=dbound, neighbor_img_num=2, mono_channels=64)

    @jax.jit
    def init_apply(key, imgs, proj):
        kb, kf, kd = jax.random.split(key, 3)
        vb = jb.init(kb, imgs)
        xs = jb.apply(vb, imgs)
        vf = jf.init(kf, xs)
        fe = jf.apply(vf, xs)
        vd = jd.init(kd, fe[0], imgs, proj)
        return vb, vf, vd

    proj = jnp.asarray(scene["proj_feat4"])
    vb, vf, vd = init_apply(jax.random.PRNGKey(0), imgs, proj)
    sb = randomize_batch_stats(vb["batch_stats"], seed=3)
    sd_stats = randomize_batch_stats(vd["batch_stats"], seed=4)

    @jax.jit
    def forward(imgs, proj):
        xs = jb.apply({"params": vb["params"], "batch_stats": sb}, imgs)
        fe = jf.apply(vf, xs)
        dpt = jd.apply({"params": vd["params"], "batch_stats": sd_stats}, fe[0],
                       imgs, proj)
        return fe, dpt

    j_feats, j_dpt = forward(imgs, proj)

    backbone = _load(ResNet50(), vb["params"], sb, "backbone")
    fpn = _load(FPN(out_channels=64), vf["params"], None, "neck")
    depth = _load(DepthNetFusion(dbound, 2, mono_channels=64), vd["params"],
                  sd_stats, "depth_head")
    with torch.no_grad():
        t_imgs = torch.from_numpy(scene["imgs"])
        feats = fpn(backbone(t_imgs))
        dpt = depth(feats[0], t_imgs, torch.from_numpy(scene["proj_feat4"]))
    for lvl in range(4):
        assert_close_scaled(feats[lvl].numpy(), j_feats[lvl], 2e-4, f"FPN {lvl}")
    assert dpt.dtype == torch.float32
    assert_close_scaled(dpt.numpy(), j_dpt, 5e-4, "depth distributions")


def test_lifting_with_budget_matches_jax():
    mcfg = tiny_model_cfg()
    rng = np.random.RandomState(5)
    scene = example_scene(IMG_SHAPE, PAD, N_VIEWS, trajectory="indoor")
    d_ch = mcfg.depth_channels
    h4, w4 = PAD[0] // 4, PAD[1] // 4
    feats, dpts = [], []
    for lvl in range(3):
        shape = (N_VIEWS, h4 // 2 ** lvl, w4 // 2 ** lvl)
        feats.append(rng.randn(shape[0], mcfg.embed_dims, *shape[1:]).astype(np.float32))
        logits = rng.randn(shape[0], d_ch, *shape[1:])
        dpts.append((np.exp(logits) / np.exp(logits).sum(1, keepdims=True))
                    .astype(np.float32))
    kw = dict(embed_dims=mcfg.embed_dims, voxel_size_list=mcfg.voxel_size_list,
              n_voxels_list=mcfg.n_voxels_list, topk_list=mcfg.topk_list,
              num_heads=mcfg.num_heads, num_points=mcfg.num_points,
              visibility_budget=mcfg.visibility_budget)
    jm = JSparse(query_chunk=None, **kw)
    args = ([jnp.asarray(f) for f in feats], [jnp.asarray(d) for d in dpts],
            jnp.asarray(scene["origin"]), jnp.asarray(scene["proj_img"]))
    v = jax.jit(lambda key: jm.init(key, *args, IMG_SHAPE, mcfg.dbound))(
        jax.random.PRNGKey(0))
    j_vol, j_valid, j_occ = jax.jit(
        lambda v: jm.apply(v, *args, IMG_SHAPE, mcfg.dbound))(v)

    model = _load(AdaptiveSparseVolume(**kw), v["params"], None, "voxel_head")
    with torch.no_grad():
        vol, valid, occ = model(
            [torch.from_numpy(f) for f in feats], [torch.from_numpy(d) for d in dpts],
            torch.from_numpy(scene["origin"]), torch.from_numpy(scene["proj_img"]),
            IMG_SHAPE, mcfg.dbound)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    assert_close_scaled(occ.numpy(), j_occ, 1e-5, "occupancy")
    assert_close_scaled(vol.numpy(), j_vol, 2e-4, "lifted volume")


def test_neck3d_and_head_match_jax():
    rng = np.random.RandomState(6)
    vol = rng.randn(1, 32, 12, 12, 8).astype(np.float32)
    jn = JNeck3D(out_channels=16, n_blocks=(1, 1, 1))
    jh = JHead(n_classes=5, n_reg_outs=6, n_scales=3, head_type="scannet")

    @jax.jit
    def init(key, x):
        vn = jn.init(key, x)
        return vn, jh.init(key, jn.apply(vn, x))

    vn, vh = init(jax.random.PRNGKey(0), jnp.asarray(vol))
    sn = randomize_batch_stats(vn["batch_stats"], seed=8)
    ph = jax.tree_util.tree_map(np.asarray, vh["params"])
    for i in range(3):
        ph[f"scale{i}"] = np.float32(0.8 + 0.2 * i)
    j_outs = jax.jit(lambda x: jh.apply({"params": ph}, jn.apply(
        {"params": vn["params"], "batch_stats": sn}, x)))(jnp.asarray(vol))

    neck = _load(FastIndoorImVoxelNeck(32, 16, (1, 1, 1)), vn["params"], sn, "neck_3d")
    head = _load(ImVoxelHead(16, 5, 6, 3), ph, None, "bbox_head")
    with torch.no_grad():
        outs = head(neck(torch.from_numpy(vol)))
    for lvl, (t_out, j_out) in enumerate(zip(outs, j_outs)):
        for name, a, b in zip(("centerness", "bbox", "cls"), t_out, j_out):
            assert_close_scaled(a.numpy(), b, 2e-4, f"{name} level {lvl}")


def test_top_k_keeps_jax_tie_order():
    """bf16 occupancy sigmoids tie often; the port's top-k must pick the
    same indices as jax.lax.top_k (lower index first among ties)."""
    rng = np.random.RandomState(9)
    scores = jax.nn.sigmoid(jnp.asarray(rng.randn(2000).astype(np.float32) * 0.05)
                            ).astype(jnp.bfloat16)
    assert len(np.unique(np.asarray(scores, np.float32))) < 100  # many ties
    expected = np.asarray(jax.lax.top_k(scores, 700)[1])
    got = top_k_indices(torch.from_numpy(np.asarray(scores, np.float32))
                        .bfloat16(), 700)
    np.testing.assert_array_equal(got.numpy(), expected)


def test_fully_masked_voxel_keeps_its_residual():
    """A voxel no camera sees: every MHA key is masked (softmax of -inf ->
    NaN), so the fusion must select zero with a where, leaving the input
    query as the output."""
    attn = DeformCrossAttention(embed_dims=32, num_heads=4, num_points=2)
    layers.init_weights(attn, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(10)
    n, k, h, w = 3, 6, 5, 7
    query = torch.from_numpy(rng.randn(k, 32).astype(np.float32))
    value = torch.from_numpy(rng.randn(n, h, w, 32).astype(np.float32))
    dpt = torch.softmax(torch.from_numpy(rng.randn(n, h, w, 8).astype(np.float32)), -1)
    ref_cam = torch.from_numpy(rng.uniform(0.1, 0.9, (n, k, 3)).astype(np.float32))
    mask = torch.ones((n, k), dtype=torch.bool)
    mask[:, 2] = False
    with torch.no_grad():
        out = attn(query, value, dpt, ref_cam, mask, ((h, w),))
    assert torch.isfinite(out).all()
    np.testing.assert_array_equal(out[2].numpy(), query[2].numpy())
    assert not torch.equal(out[0], query[0])
