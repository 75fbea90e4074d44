"""The 2D MSDA lifting path of the PyTorch port (``use_depth=False``) against
the JAX package at float32, on the CPU.

* ``msda_2d_attend`` (plain) vs ``dfa3d_fast.msda_2d_fast`` and the flat
  oracle ``msda.msda_2d``;
* ``dfa3d_attend`` with bf16 value and bf16 depth: the plain version equals
  the f32 oracle on bf16-rounded inputs (the packed-quad kernels' contract,
  tests/test_dfa3d_pallas3.py, which needs a TPU); f32 value with bf16
  depth raises; no depth gradient is computed where autograd asks for none;
* ``DeformCrossAttention(use_depth=False)`` with a visibility budget vs the
  JAX module, weights through ``convert.py``: no budget compaction on the 2D
  path, and stage 2 added to stage 1 (a residual), each pinned by a case
  that fails if reversed;
* three tiny ``ViewTransformer(use_depth=False)`` levels vs JAX, eval
  forward, and the gradients of one level vs ``jax.value_and_grad``;
* the entry points default to the card and raise without one;
* ``MSDeformableAttention2D`` with 2 and 3 levels (the plain
  ``ops/dfa3d.py::msda_2d``) vs the JAX module, forward and gradients.

Tolerances: f32 on both sides, so only summation order differs: 2e-4 of
each output's largest magnitude for the modules (MHA, LayerNorm and the
sampling sum in other orders), 1e-5 for the ops.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgcdet_tpu.models.view_transformer import (
    DeformCrossAttention as JDeformCrossAttention,
    MSDeformableAttention2D as JMSDeformableAttention2D,
    ViewTransformer as JViewTransformer,
    VoxFormerLayer as JVoxFormerLayer,
)
from sgcdet_tpu.ops.dfa3d_fast import msda_2d_fast
from sgcdet_tpu.ops.msda import dfa3d_attention as jax_oracle
from sgcdet_tpu.ops.msda import msda_2d as jax_msda_2d

from sgcdet_tpu_torch import configs
from sgcdet_tpu_torch.convert import view_transformer_state_dict_from_flax
from sgcdet_tpu_torch.models import SGCDet
from sgcdet_tpu_torch.models.view_transformer import (
    MSDeformableAttention2D,
    ViewTransformer,
    VoxFormerLayer,
)
from sgcdet_tpu_torch.ops import dfa3d as dfa3d_ops
from sgcdet_tpu_torch.ops import dfa3d_attend, msda_2d_attend
from sgcdet_tpu_torch.scene import example_scene
from sgcdet_tpu_torch.train import init_train_state
from sgcdet_tpu_torch.voxel_grid import voxel_centers_zero_origin

from torch_port_tiny import (  # noqa: F401 (keep_global_torch_rng is autouse)
    IMG_SHAPE,
    N_VIEWS,
    PAD,
    assert_close_scaled,
    dfa3d_inputs,
    keep_global_torch_rng,
    tiny_model_cfg,
    to_numpy_tree,
)

EMBED, HEADS, POINTS = 32, 4, 2
REL = 2e-4


def _msda_inputs(heads, p, c, n=3, h=6, w=9, k=40, seed=0):
    """One level: value (n, h, w, heads*c), locations (n, k, heads, 1, p, 2)
    spilling off the image on both axes, attention (n, k, heads, 1, p)."""
    rng = np.random.RandomState(seed)
    value = rng.randn(n, h, w, heads * c).astype(np.float32)
    locs = rng.uniform(-0.2, 1.2, (n, k, heads, 1, p, 2)).astype(np.float32)
    attn = rng.uniform(0.0, 1.0, (n, k, heads, 1, p)).astype(np.float32)
    return value, locs, attn


@pytest.mark.parametrize("heads,p,c", [pytest.param(1, 1, 64, id="stage1"),
                                       pytest.param(4, 2, 8, id="stage2")])
def test_msda_2d_attend_matches_jax(heads, p, c):
    value, locs, attn = _msda_inputs(heads, p, c)
    got = msda_2d_attend([torch.from_numpy(value)], torch.from_numpy(locs),
                         torch.from_numpy(attn), heads).numpy()
    fast = msda_2d_fast([jnp.asarray(value)], jnp.asarray(locs), jnp.asarray(attn),
                        heads)
    assert_close_scaled(got, np.asarray(fast), 1e-5, "msda_2d_attend vs msda_2d_fast")
    n, h, w, _ = value.shape
    flat = jax_msda_2d(jnp.asarray(value.reshape(n, h * w, heads, c)), ((h, w),),
                       jnp.asarray(locs), jnp.asarray(attn))
    assert_close_scaled(got, np.asarray(flat), 1e-5, "msda_2d_attend vs msda_2d")


@pytest.mark.parametrize("heads,p,c", [pytest.param(1, 1, 64, id="stage1"),
                                       pytest.param(4, 2, 8, id="stage2")])
def test_bf16_value_and_depth_match_oracle_on_rounded_inputs(heads, p, c):
    """bf16 value and bf16 depth are read as they are and summed in f32: the
    result is the f32 oracle on the bf16-rounded inputs, rounded once."""
    value, dpt, locs, attn = dfa3d_inputs(heads, p, c, seed=3)
    vb = torch.from_numpy(value).bfloat16()
    db = torch.from_numpy(dpt).bfloat16()
    got = dfa3d_attend(vb, db, torch.from_numpy(locs), torch.from_numpy(attn), heads)
    assert got.dtype == torch.bfloat16
    n, h, w, _ = value.shape
    expected, _ = jax_oracle(
        jnp.asarray(vb.float().numpy().reshape(n, h * w, heads, c)),
        jnp.asarray(db.float().numpy().reshape(n, h * w, -1)), ((h, w),),
        jnp.asarray(locs[:, :, :, None]), jnp.asarray(attn[:, :, :, None]))
    # one rounding to bf16 of an f32 sum: half an ulp, 2^-8 of the element
    diff = np.abs(got.float().numpy() - np.asarray(expected))
    assert (diff <= 2.0 ** -8 * np.abs(np.asarray(expected)) + 1e-6).all()
    with pytest.raises(TypeError, match="bf16 depth"):
        dfa3d_attend(torch.from_numpy(value), db, torch.from_numpy(locs),
                     torch.from_numpy(attn), heads)


def test_dfa3d_backward_skips_the_depth_gradient_when_not_asked(monkeypatch):
    """The 2D path's uniform depth is a constant: the Function asks its
    backward for no depth gradient, and the other gradients are those of
    the full backward."""
    value, dpt, locs, attn = dfa3d_inputs(4, 2, 8, seed=4)
    g = torch.from_numpy(np.random.RandomState(14).randn(
        *locs.shape[:2], 32).astype(np.float32))
    args = [torch.from_numpy(a) for a in (value, dpt, locs, attn)]
    full = dfa3d_ops.dfa3d_bwd_plain(*args, g, 4)
    part = dfa3d_ops.dfa3d_bwd_plain(*args, g, 4, depth_grad=False)
    assert part[1] is None
    for a, b in zip(full[::2] + full[3:], part[::2] + part[3:]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    calls, bwd_plain = [], dfa3d_ops.dfa3d_bwd_plain

    def spy(*a, **kw):
        calls.append(kw)
        return bwd_plain(*a, **kw)

    monkeypatch.setattr(dfa3d_ops, "dfa3d_bwd_plain", spy)
    for a in (args[0], args[2], args[3]):
        a.requires_grad_()
    grads = torch.autograd.grad(dfa3d_attend(*args, 4), [args[0], args[2], args[3]], g)
    assert calls == [dict(sample_grads=True, depth_grad=False)]
    for a, b in zip(grads, (full[0], full[2], full[3])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_msda_2d_module_refuses_levels_it_cannot_run():
    """``MSDeformableAttention2D`` with more than one level (which it
    refused until the port had ``msda_2d``) against the JAX module, whose
    multi-level branch is the flat ``msda.msda_2d``, at 2 and 3 levels."""
    for levels in (2, 3):
        _check_multilevel_module(levels)


def _check_multilevel_module(levels):
    """Seeded weights (offsets and attention weights too), value over the
    levels of one flat map, locations spilling off every level: output and
    the gradients of sum(out * g) for query, value and every parameter
    within 2e-4 of their scale."""
    shapes = ((6, 8), (3, 4), (2, 2))[:levels]
    n, k = 2, 30
    rng = np.random.RandomState(levels)
    query = rng.randn(n, k, EMBED).astype(np.float32)
    value = rng.randn(n, sum(h * w for h, w in shapes), EMBED).astype(np.float32)
    ref = rng.uniform(-0.1, 1.1, (n, k, 1, 2)).astype(np.float32)
    g = rng.randn(n, k, EMBED).astype(np.float32)
    jm = JMSDeformableAttention2D(embed_dims=EMBED, num_heads=HEADS, num_levels=levels,
                                  num_points=POINTS)
    # only the tree's shapes are used: eval_shape traces init without running it
    params = jax.eval_shape(lambda key: jm.init(key, jnp.asarray(query), jnp.asarray(value),
                                                jnp.asarray(ref), shapes),
                            jax.random.PRNGKey(0))["params"]
    params = {name: {"kernel": rng.randn(*np.shape(lin["kernel"])).astype(np.float32) * 0.2,
                     "bias": rng.randn(*np.shape(lin["bias"])).astype(np.float32) * 0.2}
              for name, lin in params.items()}
    model = MSDeformableAttention2D(EMBED, HEADS, POINTS, num_levels=levels)
    model.load_state_dict({f"{name}.{key}": torch.from_numpy(
        np.ascontiguousarray(lin["kernel"].T) if key == "weight" else lin["bias"])
        for name, lin in params.items() for key in ("weight", "bias")}, strict=True)

    def loss(prm, q, v):
        out = jm.apply({"params": prm}, q, v, jnp.asarray(ref), shapes)
        return jnp.sum(out * g), out

    (_, j_out), (j_dp, j_dq, j_dv) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        params, jnp.asarray(query), jnp.asarray(value))
    q, v = (torch.from_numpy(a).requires_grad_() for a in (query, value))
    out = model(q, v, torch.from_numpy(ref), shapes)
    (out * torch.from_numpy(g)).sum().backward()
    assert_close_scaled(out.detach().numpy(), np.asarray(j_out), REL, f"{levels} levels out")
    assert_close_scaled(q.grad.numpy(), np.asarray(j_dq), REL, "d query")
    assert_close_scaled(v.grad.numpy(), np.asarray(j_dv), REL, "d value")
    for name, p in model.named_parameters():
        lin, key = name.split(".")
        want = np.asarray(j_dp[lin]["kernel"]).T if key == "weight" else j_dp[lin]["bias"]
        assert_close_scaled(p.grad.numpy(), np.asarray(want), REL, f"d {name}")


def _perturb(tree, seed):
    """The flax init plus seeded noise on every parameter, so zero-initialized
    offsets and attention weights are exercised."""
    rng = np.random.RandomState(seed)

    def walk(node):
        if hasattr(node, "items"):
            return {k: walk(v) for k, v in node.items()}
        x = np.asarray(node, np.float32)
        scale = 0.3 / np.sqrt(x.shape[0]) if x.ndim == 2 else 0.05
        return (x + scale * rng.randn(*x.shape)).astype(np.float32)

    return walk(to_numpy_tree(tree))


def _layer_inputs(seed, n=3, k=300, h=6, w=8, visible=0.7):
    rng = np.random.RandomState(seed)
    query = rng.randn(k, EMBED).astype(np.float32)
    value = rng.randn(n, h, w, EMBED).astype(np.float32)
    dpt = np.exp(rng.randn(n, h, w, 5)).astype(np.float32)
    ref_cam = rng.uniform(0.05, 0.95, (n, k, 3)).astype(np.float32)
    mask = rng.rand(n, k) < visible
    mask[:, 7] = False  # one voxel no camera sees
    return query, value, dpt, ref_cam, mask, ((h, w),)


def _layer_pair(inputs, budget, seed, edit=None):
    """A JAX VoxFormerLayer(use_depth=False) with perturbed weights (``edit``
    may change them) and the port's layer loaded from it through convert.py
    (strict)."""
    jm = JVoxFormerLayer(embed_dims=EMBED, num_heads=HEADS, num_points=POINTS,
                         query_chunk=None, use_depth=False, visibility_budget=budget)
    params = _perturb(jm.init(jax.random.PRNGKey(seed), *map(jnp.asarray, inputs[:5]),
                              inputs[5])["params"], seed)
    if edit is not None:
        edit(params)
    prefix = "cross_transformer.encoder.layers.0."
    sd = view_transformer_state_dict_from_flax({"layer0": params})
    layer = VoxFormerLayer(EMBED, HEADS, POINTS, visibility_budget=budget,
                           use_depth=False)
    layer.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    return jm, params, layer.eval()


def _run_both(jm, params, layer, inputs):
    """Cross attention alone and the whole layer, JAX and port."""
    j_cross = JDeformCrossAttention(
        embed_dims=EMBED, num_heads=HEADS, num_points=POINTS, query_chunk=None,
        use_depth=False, visibility_budget=jm.visibility_budget)
    jin = [jnp.asarray(x) for x in inputs[:5]]
    j_attn = j_cross.apply({"params": params["cross_attn"]}, *jin, inputs[5])
    j_out = jm.apply({"params": params}, *jin, inputs[5])
    tin = [torch.from_numpy(x) for x in inputs[:5]]
    with torch.no_grad():
        t_attn = layer.attentions[0](*tin, inputs[5])
        t_out = layer(*tin, inputs[5])
    return (t_attn.numpy(), np.asarray(j_attn)), (t_out.numpy(), np.asarray(j_out))


def test_2d_cross_attention_ignores_the_budget_and_matches_jax():
    """B = 128 of K = 300 queries per camera with ~210 visible: compaction
    would drop visible voxels, so a port that compacted on the 2D path would
    differ from JAX and from the budget-free layer."""
    inputs = _layer_inputs(seed=0)
    assert (inputs[4].sum(1) > 128).all()
    jm, params, layer = _layer_pair(inputs, 0.2, seed=0)
    (t_attn, j_attn), (t_out, j_out) = _run_both(jm, params, layer, inputs)
    assert_close_scaled(t_attn, j_attn, REL, "2D cross attention")
    assert_close_scaled(t_out, j_out, REL, "2D VoxFormerLayer")
    np.testing.assert_array_equal(t_attn[7], inputs[0][7])  # no camera sees it
    # the same weights without a budget: identical, bit for bit
    free = VoxFormerLayer(EMBED, HEADS, POINTS, use_depth=False).eval()
    free.load_state_dict(layer.state_dict(), strict=True)
    with torch.no_grad():
        t_free = free.attentions[0](*map(torch.from_numpy, inputs[:5]), inputs[5])
    np.testing.assert_array_equal(t_attn, t_free.numpy())


def test_2d_stage2_is_a_residual_on_stage1():
    """With stage 2's value projection zeroed its output is zero, so the
    cross attention sees the stage-1 samples only if stage 2 is added to
    them; replacing them (the DFA3D path's rule) would leave every voxel
    the same fused constant."""
    inputs = _layer_inputs(seed=1)

    def zero_stage2(params):
        vp = params["cross_attn"]["deformable_attention"]["value_proj"]
        vp["kernel"][:] = 0.0
        vp["bias"][:] = 0.0

    jm, params, layer = _layer_pair(inputs, None, seed=1, edit=zero_stage2)
    (t_attn, j_attn), _ = _run_both(jm, params, layer, inputs)
    assert_close_scaled(t_attn, j_attn, REL, "2D cross attention, stage 2 zero")
    seen = inputs[4].any(0)
    fused = t_attn[seen] - inputs[0][seen]
    assert np.abs(fused - fused[:1]).max() > 0.1 * np.abs(fused).max()


def _level_setup(level, seed):
    """Inputs of one tiny lifting level: voxel centres (all at level 0, a
    sorted seeded subset above), the indoor rig's projections, features of
    the level's shape."""
    mcfg = tiny_model_cfg()
    scene = example_scene(IMG_SHAPE, PAD, N_VIEWS, trajectory="indoor")
    ref = voxel_centers_zero_origin(mcfg.n_voxels_list[level],
                                    mcfg.voxel_size_list[level])
    rng = np.random.RandomState(seed)
    if level:
        ref = ref[np.sort(rng.permutation(len(ref))[:mcfg.topk_list[level - 1]])]
    ds = 4 * 2 ** (2 - level)
    h, w = IMG_SHAPE[0] // ds, IMG_SHAPE[1] // ds
    feat = rng.randn(N_VIEWS, EMBED, h, w).astype(np.float32)
    dpt = rng.uniform(0.1, 1.0, (N_VIEWS, mcfg.depth_channels, h, w)).astype(np.float32)
    return (ref, scene["origin"], scene["proj_img"], feat, dpt, mcfg.dbound,
            mcfg.visibility_budget[level])


def _transformer_pair(setup, seed):
    ref, origin, proj, feat, dpt, dbound, budget = setup
    budget = None if budget >= 1.0 else budget
    jm = JViewTransformer(embed_dims=EMBED, num_heads=HEADS, num_points=POINTS,
                          query_chunk=None, use_depth=False, visibility_budget=budget)
    jargs = (jnp.asarray(ref), jnp.asarray(origin), jnp.asarray(proj),
             [jnp.asarray(feat)], [jnp.asarray(dpt)])
    params = _perturb(jm.init(jax.random.PRNGKey(seed), *jargs, IMG_SHAPE,
                              dbound)["params"], seed)
    model = ViewTransformer(EMBED, HEADS, POINTS, visibility_budget=budget,
                            use_depth=False)
    model.load_state_dict(view_transformer_state_dict_from_flax(params), strict=True)
    return jm, params, jargs, model.eval()


@pytest.mark.parametrize("level", [0, 1, 2])
def test_2d_view_transformer_levels_match_jax(level):
    setup = _level_setup(level, seed=10 + level)
    jm, params, jargs, model = _transformer_pair(setup, seed=level)
    j_out = jm.apply({"params": params}, *jargs, IMG_SHAPE, setup[5])
    ref, origin, proj, feat, dpt = map(torch.from_numpy, setup[:5])
    with torch.no_grad():
        out = model(ref, origin, proj, feat, dpt, IMG_SHAPE, setup[5])
    assert out.shape == (len(setup[0]), EMBED)
    assert_close_scaled(out.numpy(), np.asarray(j_out), REL, f"2D lifting level {level}")


def test_2d_view_transformer_grads_match_jax():
    """d sum(out * g) / d (every parameter, the features) at the finest tiny
    level, eval mode.  The 2D path has no top-k and no BatchNorm, so the
    gradients are well conditioned: f32 on both sides, 2e-4 of each
    tensor's scale (summation order only)."""
    setup = _level_setup(2, seed=12)
    jm, params, jargs, model = _transformer_pair(setup, seed=2)
    g = np.random.RandomState(13).randn(len(setup[0]), EMBED).astype(np.float32)
    dbound = setup[5]

    def loss(p, feat):
        out = jm.apply({"params": p}, *jargs[:3], [feat], jargs[4], IMG_SHAPE, dbound)
        return jnp.sum(out * g)

    j_loss, (j_dp, j_dfeat) = jax.value_and_grad(loss, argnums=(0, 1))(
        params, jargs[3][0])
    ref, origin, proj, feat, dpt = map(torch.from_numpy, setup[:5])
    feat.requires_grad_()
    t_loss = (model(ref, origin, proj, feat, dpt, IMG_SHAPE, dbound)
              * torch.from_numpy(g)).sum()
    t_loss.backward()
    assert_close_scaled(t_loss.item(), float(j_loss), REL, "loss")
    assert_close_scaled(feat.grad.numpy(), np.asarray(j_dfeat), REL, "d features")
    j_grads = view_transformer_state_dict_from_flax(to_numpy_tree(j_dp))
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(j_grads)
    for name, p in model.named_parameters():
        assert_close_scaled(p.grad.numpy(), j_grads[name].numpy(), REL, f"d {name}")


def test_entry_points_default_to_the_card(monkeypatch):
    """SGCDet and init_train_state build on the card unless asked for the
    CPU, and raise where there is none instead of staying on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mcfg = tiny_model_cfg(configs=configs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SGCDet(mcfg, IMG_SHAPE)
    cfg = dataclasses.replace(configs.scannet(), model=mcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(cfg, torch.Generator().manual_seed(0))
    model = SGCDet(mcfg, IMG_SHAPE, device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
