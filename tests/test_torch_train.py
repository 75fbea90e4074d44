"""The train step of the PyTorch port against the JAX package, on the CPU.

* one tiny-config f32 train step (``train.make_train_step``, ffn_dropout 0)
  against ``jax.value_and_grad`` of the JAX package's scene loss, with the
  depth loss off and on: the loss dict, n_pos, every parameter's gradient
  after the clip, the gradient norm and the updated BatchNorm statistics.
  The scene is the ring rig (voxels seen by several views, so the view
  pooling trains).  The indoor rig is ill-conditioned at this size: there
  the JAX package's own train-mode gradients move by up to 10 % under 1e-6
  relative noise on its weights, so it cannot pin the port;
* the optimizer alone against optax's ``make_optimizer`` chain over 3
  steps, one with a gradient norm above the clip;
* ``param_label`` against the JAX package's labels, ``onecycle_schedule``;
* the repairs of the train path: frozen backbone BatchNorm, FFN dropout,
  BatchNorm's train-mode statistics, finite gradients with fully masked
  voxels.  (The kernels' autograd Functions: tests/test_torch_grads.py.)

The weights come from the port's seeded init, converted to flax with
``train/checkpoint.py::convert_torch_state_dict`` into templates from
``jax.eval_shape`` (no JAX init is compiled).
"""
import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from sgcdet_tpu.configs import config as jconfig
from sgcdet_tpu.models import SGCDet as JSGCDet
from sgcdet_tpu.models import layers as jlayers
from sgcdet_tpu.models.detector import compute_losses as jax_compute_losses
from sgcdet_tpu.train import optim as joptim
from sgcdet_tpu.train.checkpoint import convert_torch_state_dict

from sgcdet_tpu_torch import configs
from sgcdet_tpu_torch.convert import state_dict_from_flax
from sgcdet_tpu_torch.models import SGCDet, layers
from sgcdet_tpu_torch.models.resnet import ResNet50
from sgcdet_tpu_torch.models.view_transformer import DeformCrossAttention
from sgcdet_tpu_torch.scene import example_train_scene
from sgcdet_tpu_torch.train import (
    init_train_state,
    make_optimizer,
    make_train_step,
    onecycle_schedule,
    param_label,
)

from torch_port_tiny import (  # noqa: F401 (keep_global_torch_rng is autouse)
    IMG_SHAPE,
    N_VIEWS,
    PAD,
    assert_close_scaled,
    keep_global_torch_rng,
    randomize_batch_stats,
    tiny_model_cfg,
)

INPUTS = ("imgs", "proj_img", "proj_feat4", "origin")


@pytest.fixture(scope="module")
def templates():
    """Zero-filled flax (params, batch_stats) of the tiny SGCDet, from
    ``jax.eval_shape``."""
    jm = JSGCDet(cfg=tiny_model_cfg(), img_shape=IMG_SHAPE, query_chunk=None)
    args = [jnp.zeros((N_VIEWS, 3) + PAD), jnp.zeros((N_VIEWS, 3, 4)),
            jnp.zeros((N_VIEWS, 4, 4)), jnp.zeros(3)]
    shapes = jax.eval_shape(lambda key: jm.init({"params": key}, *args, train=False),
                            jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return zeros["params"], zeros["batch_stats"]


def _to_flax(model, templates):
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    unused = set()
    params, stats = convert_torch_state_dict(sd, *templates, unused_out=unused)
    assert unused == set()
    return (jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, stats))


def _port_config(mcfg):
    base = configs.scannet()
    return dataclasses.replace(
        base, model=mcfg,
        data=dataclasses.replace(base.data, img_shape=IMG_SHAPE, pad_size=PAD))


@pytest.mark.parametrize("depth_loss", [False, True], ids=["ring", "ring_depth_loss"])
def test_train_step_matches_jax(templates, depth_loss):
    kw = dict(ffn_dropout=0.0, depth_loss=depth_loss)
    cfg = _port_config(dataclasses.replace(tiny_model_cfg(configs=configs), **kw))
    j_mcfg = dataclasses.replace(tiny_model_cfg(), **kw)
    scene = example_train_scene(IMG_SHAPE, PAD, N_VIEWS, cfg.model.n_classes,
                                cfg.model.downsample_factor, trajectory="ring")

    model, optimizer = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    params, stats = _to_flax(model, templates)
    stats = randomize_batch_stats(stats, seed=3)
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    metrics = make_train_step(model, cfg, optimizer)(scene, torch.Generator())

    jm = JSGCDet(cfg=j_mcfg, img_shape=IMG_SHAPE, query_chunk=None)
    x = {k: jnp.asarray(v) for k, v in scene.items()}

    def loss_fn(p):
        out, mut = jm.apply({"params": p, "batch_stats": stats},
                            *(x[k] for k in INPUTS), train=True,
                            rngs={"dropout": jax.random.PRNGKey(1)},
                            mutable=["batch_stats"])
        losses, n_pos = jax_compute_losses(j_mcfg, out, x["origin"], x["gt_boxes"],
                                           x["gt_labels"], x["gt_mask"],
                                           gt_depth=x["gt_depth"])
        return sum(losses.values()), (losses, mut["batch_stats"], n_pos)

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (total, (losses, new_stats, n_pos)), grads = value_and_grad(params)

    assert set(metrics) == set(losses) | {"loss", "n_pos", "grad_norm"}
    assert float(metrics["n_pos"]) == float(n_pos) > 0
    for name in list(losses) + ["loss"]:
        want = float(total if name == "loss" else losses[name])
        np.testing.assert_allclose(float(metrics[name]), want, rtol=1e-4, err_msg=name)
    norm = float(optax.global_norm(grads))
    np.testing.assert_allclose(float(metrics["grad_norm"]), norm, rtol=1e-3)

    # gradients, after the clip (both sides scaled by the JAX norm's factor);
    # the step has already updated the parameters, not their .grad
    scale = 1.0 if norm < 35.0 else 35.0 / norm

    def port_named(tree):
        return state_dict_from_flax(
            jax.tree_util.tree_map(lambda g: np.asarray(g) * scale, tree), stats)

    g_sd = port_named(grads)
    named = dict(model.named_parameters())
    assert any(p.grad.abs().max() > 0 for n, p in named.items()
               if "attention_pooling" in n)
    # f32 on both sides: sums in other orders, amplified by the train-mode
    # BatchNorms of the depth U-Nets (48 samples per channel at their 3x4
    # bottom); the worst tensor measured at 3e-5 of its largest gradient
    for name, p in named.items():
        assert torch.isfinite(p.grad).all(), name
        assert_close_scaled(p.grad.numpy(), g_sd[name].numpy(), 1e-3, f"grad {name}")

    # BatchNorm running statistics after the train-mode forward
    s_sd = state_dict_from_flax(params, new_stats)
    before = state_dict_from_flax(params, stats)
    for name, buf in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            assert_close_scaled(buf.numpy(), s_sd[name].numpy(), 1e-4, name)
            if name.startswith("backbone."):
                np.testing.assert_array_equal(buf.numpy(), before[name].numpy())


def test_optimizer_matches_optax(templates):
    """Clip 35 over every gradient, frozen/backbone/other groups, OneCycle,
    AdamW: 3 steps from the same numpy gradients, the first with a norm
    above the clip."""
    tcfg = dict(lr=1e-3, training_steps=40)
    model = SGCDet(tiny_model_cfg(configs=configs), IMG_SHAPE, device="cpu",
                   generator=torch.Generator().manual_seed(2))
    params, stats = _to_flax(model, templates)
    rng = np.random.RandomState(22)
    steps = []
    for i in range(3):
        g = jax.tree_util.tree_map(
            lambda p: np.asarray(rng.randn(*p.shape) * (0.5 if i == 0 else 1e-3),
                                 np.float32),
            params)
        steps.append(g)
    assert float(optax.global_norm(steps[0])) > 35.0 > float(optax.global_norm(steps[1]))

    tx, _ = joptim.make_optimizer(params, jconfig.TrainConfig(**tcfg))

    @jax.jit
    def run(p, grads):
        state = tx.init(p)
        for g in grads:
            updates, state = tx.update(g, state, p)
            p = optax.apply_updates(p, updates)
        return p

    j_params = run(params, steps)

    opt = make_optimizer(model, configs.TrainConfig(**tcfg))
    named = dict(model.named_parameters())
    for g in steps:
        for name, t in state_dict_from_flax(g, stats).items():
            if name in named:
                named[name].grad = t.clone()
        opt.step()

    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, j_params), stats)
    before = state_dict_from_flax(params, stats)
    moved = 0
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)
        moved += not torch.equal(p.detach(), before[name])
        if param_label(name) == "frozen":
            assert torch.equal(p.detach(), before[name]), name
    assert moved > 0


def test_param_labels_match_jax(templates):
    """Every parameter gets the JAX package's label: leaves numbered in the
    flax tree, carried to the port's names by ``state_dict_from_flax``."""
    params, stats = templates
    leaves, treedef = jax.tree_util.tree_flatten(params)
    ids = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(x), i, np.float32) for i, x in enumerate(leaves)])
    j_labels = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map_with_path(lambda p, _: joptim.param_label(p), params))
    sd = state_dict_from_flax(ids, stats)
    model = SGCDet(tiny_model_cfg(configs=configs), IMG_SHAPE, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(leaves)
    got = {n: param_label(n) for n in names}
    want = {n: j_labels[int(sd[n].reshape(-1)[0])] for n in names}
    assert got == want
    assert set(got.values()) == {"frozen", "backbone", "other"}


def test_onecycle_matches_jax():
    ours = onecycle_schedule(2e-4, 200, 0.05, 25.0, 1e4)
    ref = joptim.onecycle_schedule(2e-4, 200, 0.05, 25.0, 1e4)
    steps = list(range(0, 200, 7)) + [0, 8, 9, 10, 199, 250]
    # the JAX schedule rounds in f32, the port's in f64
    np.testing.assert_allclose([ours(s) for s in steps],
                               [float(ref(s)) for s in steps], rtol=5e-5)
    assert ours(0) == pytest.approx(2e-4 / 25)


# ---------------------------------------------------------------------------
# repairs of the train path
# ---------------------------------------------------------------------------


def test_resnet50_batchnorm_is_frozen_in_train_mode():
    """Every backbone BN uses and keeps its running statistics, in train
    mode too (resnet.py:45-61,75)."""
    backbone = ResNet50()
    layers.init_weights(backbone, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in backbone.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(0.7, 1.2, generator=gen)
    x = torch.randn((2, 3, 64, 64), generator=gen)
    before = {k: v.clone() for k, v in backbone.state_dict().items()}
    with torch.no_grad():
        eval_outs = backbone.eval()(x)
        train_outs = backbone.train()(x)
    for a, b in zip(eval_outs, train_outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k, v in backbone.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_ffn_dropout_in_train_mode_only():
    ffn = layers.FFN(16, 32, dropout=0.1)
    layers.init_weights(ffn, torch.Generator().manual_seed(5))
    x = torch.randn((64, 16), generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        plain = x + ffn.layers[1](ffn.layers[0](x))
        torch.testing.assert_close(ffn.eval()(x), plain, rtol=0, atol=0)
        ffn.train()
        a = ffn(x, generator=torch.Generator().manual_seed(7))
        b = ffn(x, generator=torch.Generator().manual_seed(7))
        c = ffn(x, generator=torch.Generator().manual_seed(8))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c) and not torch.equal(a, plain)
    with pytest.raises(ValueError, match="Generator"):
        ffn(x)
    ones = torch.ones(200_000)
    y = layers.dropout(ones, 0.1, torch.Generator().manual_seed(9))
    dropped = float((y == 0).float().mean())
    assert abs(dropped - 0.1) < 0.005
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))


def test_batchnorm_train_statistics_match_jax():
    """Batch statistics in f32 over (N, spatial), the running variance
    moved by the unbiased estimate with momentum 0.1 (layers.py:211-232)."""
    rng = np.random.RandomState(10)
    x = (rng.randn(3, 6, 5, 4, 2) * 2 + 1).astype(np.float32)
    jbn = jlayers.BatchNorm()
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    stats = randomize_batch_stats(v["batch_stats"])
    p = {"scale": rng.uniform(0.5, 2, 6).astype(np.float32),
         "bias": rng.randn(6).astype(np.float32)}
    y, mut = jbn.apply({"params": p, "batch_stats": stats},
                       jnp.asarray(x).astype(jnp.bfloat16), train=True,
                       mutable=["batch_stats"])
    bn = layers.BatchNorm3d(6).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
        got = bn(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    assert_close_scaled(got.float().numpy(), np.asarray(y, np.float32), 2.0 ** -7,
                        "bn train output")
    assert_close_scaled(bn.running_mean.numpy(), mut["batch_stats"]["mean"], 1e-5,
                        "running mean")
    assert_close_scaled(bn.running_var.numpy(), mut["batch_stats"]["var"], 1e-5,
                        "running var")


def test_fully_masked_voxels_get_zero_not_nan_gradients():
    """The softmax of an all -inf row is NaN; the where that zeroes its
    attention and the masked fill's backward keep the NaN out of every
    gradient (layers.py:137-164)."""
    attn = DeformCrossAttention(embed_dims=32, num_heads=4, num_points=2)
    layers.init_weights(attn, torch.Generator().manual_seed(11))
    rng = np.random.RandomState(12)
    n, k, h, w = 3, 6, 5, 7
    query = torch.from_numpy(rng.randn(k, 32).astype(np.float32)).requires_grad_()
    value = torch.from_numpy(rng.randn(n, h, w, 32).astype(np.float32)).requires_grad_()
    dpt = torch.softmax(torch.from_numpy(rng.randn(n, h, w, 8).astype(np.float32)), -1)
    ref_cam = torch.from_numpy(rng.uniform(0.1, 0.9, (n, k, 3)).astype(np.float32))
    mask = torch.ones((n, k), dtype=torch.bool)
    mask[:, 2] = False
    out = attn(query, value, dpt, ref_cam, mask, ((h, w),))
    out.square().sum().backward()
    for name, t in [("query", query), ("value", value)] + list(attn.named_parameters()):
        assert torch.isfinite(t.grad).all(), name
    assert (query.grad[2] == 2 * query[2].detach()).all()  # residual only
