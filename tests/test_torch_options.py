"""The JAX package's last model options in the PyTorch port, against the JAX
package at float32 on the CPU.

* ``use_gt_dpt``: the forward's ``dpt_dist`` is the JAX package's one-hot
  of the GT depth (``detector.py:48-53``) and one train step (depth loss on, GT depth at
  the padded image's size, ``downsample_factor`` 4) matches JAX's: loss
  terms within 1e-4, n_pos, the gradient norm within 1e-3, every gradient
  within 1e-3 of its scale, the BN statistics within 1e-4.  The depth
  head, which then does not run, stays in the tree as in the JAX package's
  (its init sees no GT depth): its gradients are zeros, counted in the
  clip, and AdamW's weight decay alone moves its parameters.
* ``sweep_band`` (``ops/sweep_band.py``) against
  ``sgcdet_tpu/ops/sweep_band.py`` on the cases of tests/test_sweep_band.py:
  a covering band equals the gather path; a narrow band without
  violations is exact; the violation counter fires; gradients match;
  bf16 inputs are close; ``visibility.required_sweep_band`` is tight and
  equals the JAX package's; ``DepthNetFusion(sweep_band=...)`` routes its
  correlations to the banded path.
* ``depth_remat``: ``train_steps`` runs the port's step and JAX's
  ``value_and_grad`` of the scene loss from the same weights, which
  tests/test_torch_slice.py's remat step uses.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgcdet_tpu.configs import scannet as jscannet
from sgcdet_tpu.models import SGCDet as JSGCDet
from sgcdet_tpu.models.depth_net import downsample_gt_depth as j_downsample_gt_depth
from sgcdet_tpu.models.detector import compute_losses as jax_compute_losses
from sgcdet_tpu.ops import sweep_band as jband
from sgcdet_tpu.train.checkpoint import convert_torch_state_dict
from sgcdet_tpu.utils.visibility import required_sweep_band as j_required_sweep_band

from sgcdet_tpu_torch import configs
from sgcdet_tpu_torch.convert import state_dict_from_flax
from sgcdet_tpu_torch.infer import forward_scene
from sgcdet_tpu_torch.models import SGCDet
from sgcdet_tpu_torch.models import depth_net
from sgcdet_tpu_torch.models.depth_net import DepthNetFusion, get_closest_frame_ids
from sgcdet_tpu_torch.ops import sweep_band
from sgcdet_tpu_torch.ops.sweep import plane_sweep_correlation_plain
from sgcdet_tpu_torch.scene import example_train_scene
from sgcdet_tpu_torch.train import init_train_state, make_train_step
from sgcdet_tpu_torch.visibility import required_sweep_band

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


# ---------------------------------------------------------------------------
# one train step of the port and of JAX from the same weights
# ---------------------------------------------------------------------------

def zero_templates():
    """Zero-filled flax (params, batch_stats) of the tiny SGCDet, from
    ``jax.eval_shape``."""
    jm = JSGCDet(cfg=tiny_model_cfg(), img_shape=IMG_SHAPE, query_chunk=None)
    args = [jnp.zeros((N_VIEWS, 3) + PAD), jnp.zeros((N_VIEWS, 3, 4)),
            jnp.zeros((N_VIEWS, 4, 4)), jnp.zeros(3)]
    shapes = jax.eval_shape(lambda key: jm.init({"params": key}, *args, train=False),
                            jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return zeros["params"], zeros["batch_stats"]


@pytest.fixture(scope="module")
def templates():
    return zero_templates()


def port_config(train=None, **kw):
    """The port's tiny config (f32, ffn_dropout 0) with the model fields
    ``kw`` and the train fields ``train``."""
    mcfg = dataclasses.replace(tiny_model_cfg(configs=configs), ffn_dropout=0.0, **kw)
    base = configs.scannet()
    return dataclasses.replace(
        base, model=mcfg, train=dataclasses.replace(base.train, **(train or {})),
        data=dataclasses.replace(base.data, img_shape=IMG_SHAPE, pad_size=PAD))


def train_steps(templates, scene, jax_step=True, train=None, **kw):
    """One port train step of the tiny config with ``kw`` (and the train
    fields ``train``) from its seeded
    weights (random BN statistics), and JAX's ``value_and_grad`` of the
    scene loss from the same weights (``jax_step``).  Returns a dict: the
    port's model (after the step), metrics, the parameters before the step
    and the AdamW learning rate of its step; JAX's total, losses, new BN
    statistics, n_pos and gradients; the flax params and stats."""
    cfg = port_config(train, **kw)
    model, optimizer = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    unused = set()
    params, stats = convert_torch_state_dict(sd, *templates, unused_out=unused)
    assert unused == set()  # the tree holds every port parameter, and only those
    params = jax.tree_util.tree_map(np.asarray, params)
    stats = randomize_batch_stats(jax.tree_util.tree_map(np.asarray, stats), seed=3)
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = make_train_step(model, cfg, optimizer)(scene, torch.Generator())
    out = dict(model=model, metrics=metrics, before=before, params=params, stats=stats,
               lr={g["label"]: g["lr"] for g in optimizer.adamw.param_groups},
               weight_decay=cfg.train.weight_decay)
    if not jax_step:
        return out
    j_mcfg = dataclasses.replace(tiny_model_cfg(), ffn_dropout=0.0, **kw)
    jm = JSGCDet(cfg=j_mcfg, img_shape=IMG_SHAPE, query_chunk=None)
    x = {k: jnp.asarray(v) for k, v in scene.items()}

    def loss_fn(p):
        o, mut = jm.apply({"params": p, "batch_stats": stats}, *(x[k] for k in INPUTS),
                          gt_depth=x.get("gt_depth"), train=True,
                          rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
        losses, n_pos = jax_compute_losses(j_mcfg, o, x["origin"], x["gt_boxes"],
                                           x["gt_labels"], x["gt_mask"],
                                           gt_depth=x.get("gt_depth"))
        return sum(losses.values()), (losses, mut["batch_stats"], n_pos)

    (total, (losses, new_stats, n_pos)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    out.update(total=total, losses=losses, new_stats=new_stats, n_pos=n_pos, grads=grads)
    return out


def assert_step_matches_jax(run, grad_rel=1e-3):
    """The port's step of ``train_steps`` against JAX's: loss terms within
    1e-4, n_pos, the gradient norm within 1e-3, every gradient (after the
    clip) within ``grad_rel`` of its scale, the BN running statistics within
    1e-4 (tests/test_torch_train.py's tolerances)."""
    metrics, losses = run["metrics"], run["losses"]
    assert set(metrics) == set(losses) | {"loss", "n_pos", "grad_norm"}
    assert float(metrics["n_pos"]) == float(run["n_pos"])
    for name in list(losses) + ["loss"]:
        want = float(run["total"] if name == "loss" else losses[name])
        np.testing.assert_allclose(float(metrics[name]), want, rtol=1e-4, err_msg=name)
    # optax.global_norm's eager ops compile once per leaf shape (~14 s here)
    norm = float(np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                             for g in jax.tree_util.tree_leaves(run["grads"]))))
    np.testing.assert_allclose(float(metrics["grad_norm"]), norm, rtol=1e-3)
    scale = 1.0 if norm < 35.0 else 35.0 / norm
    g_sd = state_dict_from_flax(
        jax.tree_util.tree_map(lambda g: np.asarray(g) * scale, run["grads"]), run["stats"])
    for name, p in run["model"].named_parameters():
        assert torch.isfinite(p.grad).all(), name
        assert_close_scaled(p.grad.numpy(), g_sd[name].numpy(), grad_rel, f"grad {name}")
    s_sd = state_dict_from_flax(run["params"], run["new_stats"])
    for name, buf in run["model"].state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            assert_close_scaled(buf.numpy(), s_sd[name].numpy(), 1e-4, name)


# ---------------------------------------------------------------------------
# use_gt_dpt
# ---------------------------------------------------------------------------

def _gt_depth_scene(n_classes):
    """The ring train scene with its GT depth at the padded image's size
    (downsample_factor 4), where use_gt_dpt reads it."""
    return example_train_scene(IMG_SHAPE, PAD, N_VIEWS, n_classes, 4, trajectory="ring")


def test_use_gt_dpt_forward_gives_the_jax_one_hot():
    """The eval forward's ``dpt_dist`` with a GT depth is JAX's: the JAX
    package's ``downsample_gt_depth`` one-hot, reshaped to (N, h4, w4, D)
    and transposed (JAX ``detector.py:48-53``), bit for bit; without a GT
    depth the depth net runs.  (The rest of the model is the default
    path's, held against JAX in tests/test_torch_slice.py.)"""
    cfg = port_config(use_gt_dpt=True, downsample_factor=4)
    m = cfg.model
    scene = _gt_depth_scene(m.n_classes)
    model = SGCDet(m, IMG_SHAPE, device="cpu")
    with torch.no_grad():
        out = model(*(torch.from_numpy(np.asarray(scene[k])) for k in INPUTS),
                    gt_depth=torch.from_numpy(scene["gt_depth"]))
    h4, w4 = PAD[0] // 4, PAD[1] // 4
    want = np.asarray(j_downsample_gt_depth(jnp.asarray(scene["gt_depth"]), 4, m.dbound,
                                            m.depth_channels, m.depth_max_tol))
    want = want.reshape(N_VIEWS, h4, w4, m.depth_channels).transpose(0, 3, 1, 2)
    d = out["dpt_dist"].numpy()
    np.testing.assert_array_equal(d, want)
    sums = d.sum(1)
    assert ((sums == 1.0) | (sums == 0.0)).all() and (sums == 1.0).any()
    for scale in out["head_outs"]:
        assert all(torch.isfinite(t).all() for t in scale)
    no_gt = forward_scene(model, {k: scene[k] for k in INPUTS})
    assert not np.array_equal(no_gt["dpt_dist"].numpy(), d)


def test_use_gt_dpt_train_step_matches_jax(templates):
    """The step passes the scene's GT depth to the model (JAX loop.py:67),
    and the depth head's unused parameters: zero gradients that count in
    the clip (the step's norm is JAX's), moved by weight decay alone.
    Gradients within 1e-2 of their scale: on the one-hot depth this step's
    gradients are not smooth at rounding scale (under seeded relative noise
    of 1e-5 on the port's weights its own gradients move by up to 2.2e-3 of
    scale, under 1e-4 by 16 % in the 3D neck; both forwards agree within
    1e-5 of scale in train mode), and the port's sit within 2.9e-3 of
    JAX's."""
    kw = dict(use_gt_dpt=True, depth_loss=True, downsample_factor=4)
    # a weight decay that moves a parameter visibly in the first step
    # (the optimizer alone is held against optax in test_torch_train.py)
    run = train_steps(templates, _gt_depth_scene(tiny_model_cfg().n_classes),
                      train=dict(lr=0.1, weight_decay=0.5), **kw)
    assert_step_matches_jax(run, grad_rel=1e-2)
    head = [(n, p) for n, p in run["model"].named_parameters() if n.startswith("depth_head.")]
    assert len(head) > 50
    lr, wd = run["lr"]["other"], run["weight_decay"]
    assert lr > 0 and wd > 0
    for name, p in head:
        assert (p.grad == 0).all(), name
        before = run["before"][name]
        np.testing.assert_array_equal(p.detach().numpy(), (before * (1 - lr * wd)).numpy(),
                                      err_msg=name)
    assert any(not torch.equal(p, run["before"][n]) for n, p in head)
    # the depth head's BNs did not run: their statistics are the loaded ones
    loaded = state_dict_from_flax(run["params"], run["stats"])
    for name, buf in run["model"].state_dict().items():
        if name.startswith("depth_head.") and name.endswith(("running_mean", "running_var")):
            np.testing.assert_array_equal(buf.numpy(), loaded[name].numpy(), err_msg=name)


# ---------------------------------------------------------------------------
# sweep_band
# ---------------------------------------------------------------------------

def _band_case(seed=0, n=3, c=32, h=12, w=16, d=5):
    """tests/test_sweep_pallas.py's sweep case in numpy: features, a rig of
    cameras turning and moving along a line, each view's neighbour the one
    before it, 5 depth planes."""
    rng = np.random.RandomState(seed)
    src = rng.randn(n, c, h, w).astype(np.float32)
    ref = rng.randn(n, c, h, w).astype(np.float32)
    projs = []
    for i in range(n):
        e = np.eye(4, dtype=np.float32)
        ca, sa = np.cos(0.12 * i), np.sin(0.12 * i)
        e[:3, :3] = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]], np.float32)
        e[:3, 3] = [0.15 * i, 0.02 * i, 0.0]
        k = np.eye(4, dtype=np.float32)
        k[0, 0] = k[1, 1] = 14.0
        k[0, 2], k[1, 2] = w / 2, h / 2
        projs.append(k @ e)
    nei = np.roll(np.arange(n), 1)
    return src, ref, np.stack(projs), nei, np.linspace(0.5, 3.0, d).astype(np.float32)


def _banded_both(case, band, rows_per_step=4, dtype=torch.float32):
    src, ref, proj, nei, dv = case
    t = [torch.from_numpy(a) for a in (src[nei], ref, proj[nei], proj, dv)]
    t[0], t[1] = t[0].to(dtype), t[1].to(dtype)
    got = sweep_band.plane_sweep_correlation_banded(*t, band, rows_per_step)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jband.plane_sweep_correlation_banded(
        jnp.asarray(src[nei]).astype(jdt), jnp.asarray(ref).astype(jdt), proj[nei], proj,
        dv, band, rows_per_step)
    return got, np.asarray(want.astype(jnp.float32)), t


def _violations(case, band):
    src, ref, proj, nei, dv = case
    h, w = src.shape[2:]
    got = sweep_band.plane_sweep_band_violations(
        torch.from_numpy(proj[nei]), torch.from_numpy(proj), torch.from_numpy(dv), h, w, band)
    assert got == int(jband.plane_sweep_band_violations(proj[nei], proj, dv, h, w, band))
    return got


def test_banded_sweep_matches_gather_path_when_band_covers():
    case = _band_case()
    h = case[0].shape[2]
    assert _violations(case, h) == 0
    got, want, t = _banded_both(case, h)
    gather = plane_sweep_correlation_plain(*t)
    assert_close_scaled(got.numpy(), want, 2e-5, "banded vs JAX banded")
    assert_close_scaled(got.numpy(), gather.numpy(), 2e-5, "banded vs gather path")


def test_banded_sweep_narrow_band_exact_without_violations():
    case = _band_case(seed=1)
    assert _violations(case, 6) == 0
    got, want, t = _banded_both(case, 6, rows_per_step=3)
    assert_close_scaled(got.numpy(), want, 2e-5, "band 6 vs JAX")
    assert_close_scaled(got.numpy(), plane_sweep_correlation_plain(*t).numpy(), 2e-5,
                        "band 6 vs gather path")


def test_banded_sweep_violation_counter_fires():
    assert _violations(_band_case(seed=2), 1) > 0


def test_banded_sweep_gradients_match_jax():
    src, ref, proj, nei, dv = _band_case(seed=2)
    cos_w = np.cos(np.arange(3 * 5 * 12 * 16, dtype=np.float32)).reshape(3, 5, 12, 16)

    def j_loss(s, r):
        return jnp.sum(jband.plane_sweep_correlation_banded(s[nei], r, proj[nei], proj, dv,
                                                            band=6) * cos_w)

    j_grads = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(src), jnp.asarray(ref))
    s, r = (torch.from_numpy(a).requires_grad_() for a in (src, ref))
    out = sweep_band.plane_sweep_correlation_banded(
        s[torch.from_numpy(nei)], r, torch.from_numpy(proj[nei]), torch.from_numpy(proj),
        torch.from_numpy(dv), 6)
    (out * torch.from_numpy(cos_w)).sum().backward()
    for name, a, b in (("d_src", s.grad, j_grads[0]), ("d_ref", r.grad, j_grads[1])):
        assert_close_scaled(a.numpy(), np.asarray(b), 1e-5, name)


def test_banded_sweep_bf16_inputs_close():
    got, want, _ = _banded_both(_band_case(seed=3), 8, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # both sides sum bf16 products in f32 and round the result to bf16
    assert_close_scaled(got.float().numpy(), want, 2 ** -7, "bf16 banded vs JAX")


def test_required_sweep_band_is_tight_and_matches_jax():
    src, ref, proj, nei, dv = _band_case(seed=5, n=4)  # 4 views: two neighbours each
    n, _, h, w = src.shape
    step = float(dv[1] - dv[0])
    db = (float(dv[0]) - step / 2, float(dv[-1]) + step / 2, step)
    mcfg = dataclasses.replace(configs.scannet().model, dbound=db, neighbor_img_num=2)
    band = required_sweep_band(proj, n, mcfg, (h, w))
    j_mcfg = dataclasses.replace(jscannet().model, dbound=db, neighbor_img_num=2)
    assert band == j_required_sweep_band(proj, n, j_mcfg, (h, w))
    assert 1 < band <= h
    nb = get_closest_frame_ids(n, 2)
    t = torch.from_numpy
    dvals = t(np.arange(db[0], db[1], step, dtype=np.float32) + step / 2)

    def total(b):
        return sum(sweep_band.plane_sweep_band_violations(t(proj[nb[:, j]]), t(proj), dvals,
                                                          h, w, b) for j in range(2))

    assert total(band) == 0 and total(band - 1) > 0


def test_depth_net_routes_the_banded_sweep(monkeypatch):
    """``DepthNetFusion(sweep_band=b)`` computes each neighbour's correlation
    with the banded sweep at band b, and with a covering band gives the
    sweep path's distributions."""
    rng = np.random.RandomState(0)
    feats = torch.from_numpy(rng.randn(N_VIEWS, 32, 12, 16).astype(np.float32))
    imgs = torch.from_numpy(rng.randn(N_VIEWS, 3, *PAD).astype(np.float32))
    proj = torch.from_numpy(_band_case(n=N_VIEWS)[2])
    calls, banded = [], sweep_band.plane_sweep_correlation_banded

    def spy(*args):
        calls.append(args[-1])
        return banded(*args)

    monkeypatch.setattr(depth_net, "plane_sweep_correlation_banded", spy)
    nets = [DepthNetFusion((0.2, 3.4, 0.4), 2, mono_channels=32, sweep_band=b).eval()
            for b in (None, 12)]
    nets[1].load_state_dict(nets[0].state_dict())
    with torch.no_grad():
        plain, band = (net(feats, imgs, proj) for net in nets)
    assert calls == [12, 12]
    assert_close_scaled(band.numpy(), plain.numpy(), 1e-5, "dpt_dist banded vs sweep")
