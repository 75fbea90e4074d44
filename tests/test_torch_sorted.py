"""The ``sort_queries`` path of the PyTorch port against the JAX package at
float32, on the CPU, and the plain versions of its windowed kernels and of
the row gather/scatter probes.

* ``compact_queries(..., sort_queries=True)``: the ``sel_idx`` of
  ``lax.top_k`` over JAX's own f32 score, and the same ``valid_counts``,
  with no budget (B = K) and with 0.3;
* a sorted ``ViewTransformer`` vs JAX's (weights through convert.py), with
  and without a budget: outputs within 1e-4 of their scale, the gradients
  of value, depth and every parameter within 1e-3;
* the tiny ``SGCDet(sort_queries=True)`` vs JAX's (identical ``valid``, head
  outputs within 5e-4 as in test_torch_slice.py), and vs the port's
  unsorted model (the permutation is exact: 1e-5); the JAX tree loads
  strictly;
* ``plan_windows`` invariants, in the coherent and random regimes of
  tests/test_dfa3d_windowed.py: a chunk's window is the union of its
  heads' windows, and ``window_length`` the kernels' reservation;
* ``dfa3d_windowed_plain`` vs ``dfa3d_attention_plain`` (1e-6) and vs the
  JAX oracle on bf16-rounded inputs at test_dfa3d_windowed.py's shapes and
  tolerances (8e-3 forward, 2e-2 gradients), counted and not;
* the probes' plain versions vs their JAX references.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgcdet_tpu.models import SGCDet as JSGCDet
from sgcdet_tpu.models.view_transformer import ViewTransformer as JViewTransformer
from sgcdet_tpu.ops.msda import dfa3d_attention as jax_oracle

from sgcdet_tpu_torch.convert import (
    state_dict_from_flax,
    view_transformer_state_dict_from_flax,
)
from sgcdet_tpu_torch.experiments import probes
from sgcdet_tpu_torch.infer import forward_scene
from sgcdet_tpu_torch.models import SGCDet
from sgcdet_tpu_torch.models.view_transformer import (
    ViewTransformer,
    compact_queries,
    point_sampling,
)
from sgcdet_tpu_torch.ops import dfa3d_attention_plain, dfa3d_windowed
from sgcdet_tpu_torch.ops.dfa3d import dfa3d_bwd_plain
from sgcdet_tpu_torch.ops.dfa3d_windowed import (
    dfa3d_attention_windowed,
    dfa3d_windowed_bwd_plain,
    dfa3d_windowed_plain,
    plan_windows,
    window_bytes,
    window_length,
)
from sgcdet_tpu_torch.scene import example_scene
from sgcdet_tpu_torch.voxel_grid import voxel_centers_zero_origin

from torch_port_tiny import (  # noqa: F401 (keep_global_torch_rng is autouse)
    IMG_SHAPE,
    N_VIEWS,
    PAD,
    assert_close_scaled,
    keep_global_torch_rng,
    randomize_batch_stats,
    tiny_model_cfg,
    to_numpy_tree,
    windowed_inputs,
)

EMBED, HEADS, POINTS = 32, 4, 2
SCENE_KEYS = ("imgs", "proj_img", "proj_feat4", "origin")


def _level(level, seed):
    """Inputs of one tiny lifting level: voxel centres (all at level 0, a
    sorted seeded subset above), the indoor rig, features and a depth
    distribution of the level's shape."""
    mcfg = tiny_model_cfg()
    scene = example_scene(IMG_SHAPE, PAD, N_VIEWS, trajectory="indoor")
    ref = voxel_centers_zero_origin(mcfg.n_voxels_list[level], mcfg.voxel_size_list[level])
    rng = np.random.RandomState(seed)
    if level:
        ref = ref[np.sort(rng.permutation(len(ref))[:mcfg.topk_list[level - 1]])]
    ds = 4 * 2 ** (2 - level)
    h, w = IMG_SHAPE[0] // ds, IMG_SHAPE[1] // ds
    feat = rng.randn(N_VIEWS, EMBED, h, w).astype(np.float32)
    logits = rng.randn(N_VIEWS, mcfg.depth_channels, h, w).astype(np.float32)
    dpt = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return ref, scene["origin"], scene["proj_img"], feat, dpt, mcfg.dbound


@pytest.mark.parametrize("budget", [None, 0.3], ids=["no_budget", "budget_0.3"])
def test_sort_order_matches_jax_top_k(budget):
    ref, origin, proj, feat, _, dbound = _level(2, seed=0)
    ref_cam, mask = point_sampling(*map(torch.from_numpy, (ref, origin, proj)),
                                   IMG_SHAPE, dbound)
    h0, w0 = feat.shape[2:]
    k = mask.shape[1]
    sel, counts = compact_queries(mask, budget, True, ref_cam, ((h0, w0),))
    b = k if budget is None else min(k, max(128, -(-int(k * budget) // 128) * 128))
    assert sel.shape == (N_VIEWS, b)
    # JAX's score and lax.top_k (view_transformer.py:293-309)
    rc, mk = jnp.asarray(ref_cam.numpy()), jnp.asarray(mask.numpy())
    u_pix = jnp.clip(jnp.floor(rc[..., 0] * w0 - 0.5), -1.0, w0 - 1.0) + 1.0
    v_pix = jnp.clip(jnp.floor(rc[..., 1] * h0 - 0.5), -1.0, h0 - 1.0) + 1.0
    row_norm = (v_pix * (w0 + 1) + u_pix) / float((h0 + 1) * (w0 + 1) + 1)
    scores = mk.astype(jnp.float32) * 2.0 - row_norm.astype(jnp.float32)
    _, j_sel = jax.lax.top_k(scores, b)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(j_sel))
    np.testing.assert_array_equal(counts.numpy(),
                                  np.minimum(np.asarray(mk.sum(1)), b).astype(np.int32))
    # visible first, and row-major among the visible
    vis = torch.gather(mask, 1, sel)
    for cam in range(N_VIEWS):
        c = int(counts[cam])
        assert vis[cam, :c].all() and not vis[cam, c:].any()
        u = (ref_cam[cam, sel[cam, :c], 0] * w0 - 0.5).floor().clamp(-1, w0 - 1) + 1
        v = (ref_cam[cam, sel[cam, :c], 1] * h0 - 0.5).floor().clamp(-1, h0 - 1) + 1
        assert (torch.diff(v * (w0 + 1) + u) >= 0).all()


def _perturb(tree, seed):
    """The flax init plus seeded noise on every parameter, so the
    zero-initialized offsets and attention weights are exercised."""
    rng = np.random.RandomState(seed)

    def walk(node):
        if hasattr(node, "items"):
            return {k: walk(v) for k, v in node.items()}
        x = np.asarray(node, np.float32)
        scale = 0.3 / np.sqrt(x.shape[0]) if x.ndim == 2 else 0.05
        return (x + scale * rng.randn(*x.shape)).astype(np.float32)

    return walk(to_numpy_tree(tree))


@pytest.mark.parametrize("budget", [None, 0.3], ids=["no_budget", "budget_0.3"])
def test_sorted_view_transformer_matches_jax(budget):
    """Output and the gradients of sum(out * g) for the features, the depth
    and every parameter, eval mode, f32 on both sides."""
    ref, origin, proj, feat, dpt, dbound = _level(2, seed=3)
    jm = JViewTransformer(embed_dims=EMBED, num_heads=HEADS, num_points=POINTS,
                          query_chunk=None, visibility_budget=budget, sort_queries=True)
    jargs = tuple(map(jnp.asarray, (ref, origin, proj)))
    params = _perturb(jm.init(jax.random.PRNGKey(1), *jargs, [jnp.asarray(feat)],
                              [jnp.asarray(dpt)], IMG_SHAPE, dbound)["params"], seed=1)
    model = ViewTransformer(EMBED, HEADS, POINTS, visibility_budget=budget,
                            sort_queries=True)
    model.load_state_dict(view_transformer_state_dict_from_flax(params), strict=True)
    model.eval()
    g = np.random.RandomState(4).randn(len(ref), EMBED).astype(np.float32)

    def loss(p, f, d):
        out = jm.apply({"params": p}, *jargs, [f], [d], IMG_SHAPE, dbound)
        return jnp.sum(out * g), out

    (j_loss, j_out), (j_dp, j_df, j_dd) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(params, jnp.asarray(feat), jnp.asarray(dpt))
    t_ref, t_origin, t_proj = map(torch.from_numpy, (ref, origin, proj))
    t_feat = torch.from_numpy(feat).requires_grad_()
    t_dpt = torch.from_numpy(dpt).requires_grad_()
    out = model(t_ref, t_origin, t_proj, t_feat, t_dpt, IMG_SHAPE, dbound)
    (out * torch.from_numpy(g)).sum().backward()
    assert_close_scaled(out.detach().numpy(), np.asarray(j_out), 1e-4, "sorted output")
    assert_close_scaled(t_feat.grad.numpy(), np.asarray(j_df), 1e-3, "d features")
    assert_close_scaled(t_dpt.grad.numpy(), np.asarray(j_dd), 1e-3, "d depth")
    j_grads = view_transformer_state_dict_from_flax(to_numpy_tree(j_dp))
    assert sorted(n for n, _ in model.named_parameters()) == sorted(j_grads)
    for name, p in model.named_parameters():
        assert_close_scaled(p.grad.numpy(), j_grads[name].numpy(), 1e-3, f"d {name}")


@pytest.fixture(scope="module")
def sorted_model_setup():
    """The tiny model with ``sort_queries`` and no budget (every level then
    compacts at B = K, an exact budget) in JAX, and the port's model
    loaded from its tree."""
    mcfg = dataclasses.replace(tiny_model_cfg(), visibility_budget=None,
                               sort_queries=True)
    scene = example_scene(IMG_SHAPE, PAD, N_VIEWS, trajectory="indoor")
    jm = JSGCDet(cfg=mcfg, img_shape=IMG_SHAPE, query_chunk=None)
    args = [jnp.asarray(scene[k]) for k in SCENE_KEYS]
    variables = jax.jit(lambda key, *a: jm.init({"params": key}, *a, train=False))(
        jax.random.PRNGKey(0), *args)
    params = _perturb(variables["params"], seed=5)
    stats = randomize_batch_stats(variables["batch_stats"])
    j_out = jax.jit(lambda p, s, *a: jm.apply(
        {"params": p, "batch_stats": s}, *a, train=False))(params, stats, *args)
    model = SGCDet(mcfg, IMG_SHAPE, device="cpu")
    sd = state_dict_from_flax(params, stats)
    return dict(mcfg=mcfg, scene=scene, sd=sd, model=model,
                j_out=jax.tree_util.tree_map(np.asarray, j_out))


def test_sorted_tree_loads_strictly(sorted_model_setup):
    """``sort_queries`` adds no parameter: the JAX tree of the sorted model
    is the port's state dict, key for key."""
    s = sorted_model_setup
    assert set(s["sd"]) == set(s["model"].state_dict())
    s["model"].load_state_dict(s["sd"], strict=True)


def test_sgcdet_still_refuses_sweep_band_and_use_gt_dpt():
    for field, value in (("sweep_band", 2), ("use_gt_dpt", True)):
        mcfg = dataclasses.replace(tiny_model_cfg(), **{field: value})
        with pytest.raises(NotImplementedError, match="sweep_band and use_gt_dpt"):
            SGCDet(mcfg, IMG_SHAPE, device="cpu")


def test_sorted_model_matches_jax_and_the_unsorted_model(sorted_model_setup):
    s = sorted_model_setup
    s["model"].load_state_dict(s["sd"], strict=True)
    out = forward_scene(s["model"], s["scene"])
    np.testing.assert_array_equal(out["valid"].numpy(), s["j_out"]["valid"])
    unsorted = SGCDet(dataclasses.replace(s["mcfg"], sort_queries=False), IMG_SHAPE,
                      device="cpu")
    unsorted.load_state_dict(s["sd"], strict=True)
    u_out = forward_scene(unsorted, s["scene"])
    np.testing.assert_array_equal(out["valid"].numpy(), u_out["valid"].numpy())
    for lvl, (a, b, c) in enumerate(zip(out["head_outs"], s["j_out"]["head_outs"],
                                        u_out["head_outs"])):
        for name, x, y, z in zip(("centerness", "bbox", "cls"), a, b, c):
            assert_close_scaled(x.numpy(), y, 5e-4, f"{name} level {lvl} vs JAX")
            assert_close_scaled(x.numpy(), z.numpy(), 1e-5, f"{name} level {lvl} vs unsorted")


def _live_corners(locs, counts, h, w):
    """(view, query, head, flat pixel) of every in-image corner of a counted
    query, as the kernels compute the pixel."""
    x = torch.floor((locs[..., 0] * w - 0.5).clamp(-4, w + 4)).long()
    y = torch.floor((locs[..., 1] * h - 0.5).clamp(-4, h + 4)).long()
    n, k, heads = locs.shape[:3]
    idx = torch.meshgrid(torch.arange(n), torch.arange(k), torch.arange(heads),
                         indexing="ij")
    out = []
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x + dx, y + dy
            ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            if counts is not None:
                ok &= (torch.arange(k)[None, :, None] < counts[:, None, None])[..., None]
            for pt in range(locs.shape[3]):
                sel = ok[..., pt]
                out.append(torch.stack([t[sel] for t in idx] + [(yi * w + xi)[..., pt][sel]], 1))
    return torch.cat(out)


@pytest.mark.parametrize("coherent", [True, False], ids=["coherent", "random"])
@pytest.mark.parametrize("wwin", [24, 64])
def test_plan_windows_invariants(coherent, wwin):
    n, h, w, k, heads = 2, 10, 12, 512, 4
    _, _, locs, _ = windowed_inputs(n, h, w, k, heads, 32, 2, 6, coherent)
    counts = torch.tensor([300, 512], dtype=torch.int32)
    plan = plan_windows(locs, counts, h, w, wwin, qc=32)
    assert plan.base.shape == plan.ok.shape == (n, 16)
    assert ((plan.base >= 0) & (plan.base < h * w)).all()
    assert ((plan.span >= 0) & (plan.span <= h * w)).all()
    assert torch.equal(plan.ok, plan.span <= wwin)
    # every live corner of every head lies in its chunk's window
    live = _live_corners(locs, counts, h, w)
    cam, q, _, pix = live.unbind(1)
    base = plan.base[cam, q // 32]
    span = plan.span[cam, q // 32]
    assert ((pix >= base) & (pix < base + span)).all()
    # the window is tight: its ends are live corners
    cell = cam * 16 + q // 32
    lo = torch.full((plan.base.numel(),), h * w).scatter_reduce(0, cell, pix, "amin")
    hi = torch.full((plan.base.numel(),), -1).scatter_reduce(0, cell, pix, "amax")
    full = plan.span.view(-1) > 0
    assert torch.equal(lo[full], plan.base.view(-1)[full].long())
    assert torch.equal(hi[full] - lo[full] + 1, plan.span.view(-1)[full].long())
    assert (hi[~full] < 0).all()
    # counted-out queries and dead samples (every corner off the image) do
    # not move the plan
    moved = locs.clone()
    moved[0, 300:, ..., :2] = torch.rand(moved[0, 300:, ..., :2].shape)
    moved[:, ::5, :, 0, 0] = -0.6
    moved2 = locs.clone()
    moved2[:, ::5, :, 0, 0] = -0.6
    plan2 = plan_windows(moved, counts, h, w, wwin, qc=32)
    plan3 = plan_windows(moved2, counts, h, w, wwin, qc=32)
    assert all(torch.equal(a, b) for a, b in zip(plan2[:3], plan3[:3]))


@pytest.mark.parametrize("coherent", [True, False], ids=["coherent", "random"])
@pytest.mark.parametrize("counted", [False, True], ids=["uncounted", "counted"])
def test_union_window_is_the_envelope_of_head_windows(coherent, counted):
    """A block takes every head of its chunk: its window runs from the
    lowest base of its heads' own windows to the highest end."""
    n, h, w, k, heads = 2, 10, 12, 512, 4
    _, _, locs, _ = windowed_inputs(n, h, w, k, heads, 32, 2, 6, coherent)
    counts = torch.tensor([300, 0], dtype=torch.int32) if counted else None
    union = plan_windows(locs, counts, h, w, 64, qc=32)
    per_head = [plan_windows(locs[:, :, i:i + 1], counts, h, w, 64, qc=32)
                for i in range(heads)]
    live = torch.stack([p.span > 0 for p in per_head])
    lo = torch.stack([p.base for p in per_head]).masked_fill(~live, h * w).amin(0)
    hi = torch.stack([p.base + p.span - 1 for p in per_head]).masked_fill(~live, -1).amax(0)
    assert torch.equal(union.span > 0, live.any(0))
    assert torch.equal(union.base[live.any(0)], lo[live.any(0)])
    assert torch.equal((union.base + union.span - 1)[live.any(0)], hi[live.any(0)])
    assert (union.span[~live.any(0)] == 0).all()
    if counted:  # a view counted to 0 has no window
        assert (union.span[1] == 0).all()


@pytest.mark.parametrize("vdtype,ddtype", [(torch.bfloat16, torch.float32),
                                           (torch.float32, torch.float32),
                                           (torch.bfloat16, torch.bfloat16)],
                         ids=["bf16_f32", "f32_f32", "bf16_bf16"])
@pytest.mark.parametrize("dsize", [12, 5])
def test_window_length_is_the_kernels_reservation(vdtype, ddtype, dsize):
    """window_length is the longest window whose reservation (window_bytes,
    the kernels' shared-memory formula) fits the kernel's budget, at most
    the cap and the map; the windowed kernels hold f32 per bin whatever
    the types."""
    value = torch.zeros((1, 59, 80, 256), dtype=vdtype)
    depth = torch.zeros((1, 59, 80, dsize), dtype=ddtype)
    for backward in (False, True):
        wwin = window_length(value, depth, backward)
        size = window_bytes(wwin, value, depth, backward)
        assert 1 <= wwin <= dfa3d_windowed.WIN_CAP and size <= dfa3d_windowed.SMEM_MH
        assert (wwin == dfa3d_windowed.WIN_CAP
                or window_bytes(wwin + 1, value, depth, backward) > dfa3d_windowed.SMEM_MH)
        assert size == 4 * wwin * dsize
    # a backward without d_depth has nothing to hold
    assert window_length(value, depth, backward=True, depth_grad=False) == 0
    assert window_bytes(1152, value, depth, backward=True, depth_grad=False) == 0
    # the main path's pair at 12 bins: the cap, 54 KB a block
    if (vdtype, ddtype, dsize) == (torch.bfloat16, torch.float32, 12):
        assert window_length(value, depth) == dfa3d_windowed.WIN_CAP == 1152
        assert window_bytes(1152, value, depth) == 55296
        assert window_bytes(1152, value, depth, backward=True) == 55296
    # a map smaller than the cap is held whole
    small = value[:, :14, :20]
    assert window_length(small, depth[:, :14, :20], backward=True) == 280


def test_plan_windows_sees_both_regimes():
    """Coherent locations keep 32-query chunks in a 64-pixel window (some
    in 24) where random ones keep none; both regimes give window and
    fallback chunks at some chunk and window length."""
    def share(coherent, qc, wwin):
        _, _, locs, _ = windowed_inputs(2, 10, 12, 512, 4, 32, 2, 6, coherent)
        return float(plan_windows(locs, None, 10, 12, wwin, qc=qc).ok.float().mean())

    assert 0 < share(True, 32, 24) < 1 and share(True, 32, 64) == 1
    assert share(False, 32, 64) == 0 and 0 < share(False, 2, 96) < 1


# (chunk, window) where each regime has window and fallback chunks
_REGIME_PLAN = {True: (32, 24), False: (2, 96)}


@pytest.mark.parametrize("coherent", [True, False], ids=["coherent", "random"])
@pytest.mark.parametrize("counted", [False, True], ids=["uncounted", "counted"])
def test_windowed_plain_matches_plain_and_jax_oracle(coherent, counted):
    n, h, w, k, heads, c, p, d = 2, 10, 12, 512, 4, 32, 2, 6
    value, dpt, locs, attn = windowed_inputs(n, h, w, k, heads, c, p, d, coherent)
    counts = torch.tensor([300, 512], dtype=torch.int32) if counted else None
    qc, wwin = _REGIME_PLAN[coherent]
    plan = plan_windows(locs, counts, h, w, wwin, qc=qc)
    assert plan.ok.any() and not plan.ok.all()
    got = dfa3d_windowed_plain(value, dpt, locs, attn, heads, counts, plan=plan)
    plain = dfa3d_attention_plain(value.float(), dpt.float(), locs, attn, heads, counts)
    assert_close_scaled(got.float().numpy(), plain.numpy(), 2.0 ** -8, "vs plain")
    f32 = dfa3d_windowed_plain(value.float(), dpt.float(), locs, attn, heads, counts,
                               plan=plan)
    assert_close_scaled(f32.numpy(), plain.numpy(), 1e-6, "f32 windowed vs plain")
    # a plan whose windows are off by one pixel gives a wrong number
    broken = plan._replace(base=plan.base + 1)
    bad = dfa3d_windowed_plain(value.float(), dpt.float(), locs, attn, heads, counts,
                               plan=broken)
    assert (bad - plain).abs().max() > 1e-3 * plain.abs().max()
    # the backward's plain version with the same plan: the VJP of the plain
    # version, whatever the plan, where the plan is right
    g = torch.from_numpy(np.random.RandomState(3).randn(n, k, heads * c).astype(np.float32))
    f32_ins = (value.float(), dpt.float(), locs, attn)
    for got_g, want_g in zip(dfa3d_windowed_bwd_plain(*f32_ins, g, heads, counts, plan=plan),
                             dfa3d_bwd_plain(*f32_ins, g, heads, counts)):
        assert_close_scaled(got_g.numpy(), want_g.numpy(), 1e-6, "windowed bwd vs plain")
    # the JAX oracle on the bf16-rounded inputs
    keep = (np.arange(k)[None, :] < (counts.numpy()[:, None] if counted else k))
    keep = jnp.asarray(keep[..., None].astype(np.float32))

    def oracle(v, dp, lo, at):
        out, _ = jax_oracle(v.reshape(n, h * w, heads, c), dp.reshape(n, h * w, d),
                            ((h, w),), lo[:, :, :, None], at[:, :, :, None])
        return out * keep

    jin = [jnp.asarray(t.float().numpy()) for t in (value, dpt, locs, attn)]
    ref = oracle(*jin)
    scale = max(float(jnp.abs(ref).max()), 1.0)
    assert float(np.abs(got.float().numpy() - np.asarray(ref)).max()) < 8e-3 * scale
    j_grads = jax.grad(lambda *a: jnp.sum(oracle(*a) ** 2), argnums=(0, 1, 2, 3))(*jin)
    ins = [t.clone().requires_grad_() for t in (value, dpt, locs, attn)]
    out = dfa3d_attention_windowed(*ins, heads, counts)
    (out.float() ** 2).sum().backward()
    for t, jg in zip(ins, j_grads):
        jg = np.asarray(jg)
        scale = max(float(np.abs(jg).max()), 1.0)
        assert float(np.abs(t.grad.float().numpy() - jg).max()) < 2e-2 * scale


def test_probe_plain_versions_match_jax_references():
    rng = np.random.RandomState(0)
    r, l, m = 300, 72, 4096
    imgf = rng.randn(r, l).astype(np.float32)
    imgb = jnp.asarray(imgf).astype(jnp.bfloat16)
    rows = np.sort(rng.randint(0, r, m)).astype(np.int32)
    t_img = torch.from_numpy(np.array(imgb.astype(jnp.float32))).bfloat16()
    ref = np.asarray(imgb[jnp.asarray(rows)].astype(jnp.float32))
    for window in (None, 16):
        got = probes.row_gather(t_img, torch.from_numpy(rows), window, chunk=128)
        np.testing.assert_array_equal(got.float().numpy(), ref)  # probe_window_lowering.py:137
    u = rng.randn(m, l).astype(np.float32)
    seg = np.asarray(jax.ops.segment_sum(jnp.asarray(u), jnp.asarray(rows), num_segments=r))
    for window in (None, 16):
        got = probes.row_scatter_add(torch.from_numpy(u), torch.from_numpy(rows), r, window,
                                     chunk=128).numpy()
        assert np.abs(got - seg).max() <= 1e-6 * np.abs(seg).max()  # :151
    assert probes.plan_rows(torch.from_numpy(rows)[None], 128, 16)[2].all()
    # p4+epi: probe_gather_batch.py:104-126 in jnp
    width, p, qb = 176, 4, 512
    img = rng.randn(r, width).astype(np.float32)
    rows4 = rng.randint(0, r, (p, qb)).astype(np.int32)
    winfo = rng.rand(p, qb, 8).astype(np.float32)
    winfo[..., 6:8] = np.floor(winfo[..., 6:8] * 12)
    c, d = probes.quad_widths(width)
    acc = None
    for pt in range(p):
        wi = jnp.asarray(winfo[pt])
        iota = jax.lax.broadcasted_iota(jnp.int32, (qb, d), 1).astype(jnp.float32)
        dvec = (jnp.where(iota == wi[:, 6:7], wi[:, 4:5], 0.0)
                + jnp.where(iota == wi[:, 7:8], wi[:, 5:6], 0.0))
        s = jnp.asarray(img)[jnp.asarray(rows4[pt])]
        contrib = None
        for jc in range(4):
            dsj = jnp.sum(s[:, 4 * c + jc * d:4 * c + (jc + 1) * d] * dvec, axis=1, keepdims=True)
            term = (wi[:, jc:jc + 1] * dsj) * s[:, jc * c:(jc + 1) * c]
            contrib = term if contrib is None else contrib + term
        acc = contrib if acc is None else acc + contrib
    want = np.zeros((qb, width), np.float32)
    want[:, :c] = np.asarray(acc)
    for window in (None, 512):
        got = probes.gather_epilogue(torch.from_numpy(img), torch.from_numpy(rows4),
                                     torch.from_numpy(winfo), window, chunk=64).numpy()
        assert_close_scaled(got, want, 1e-6, "p4+epi")
