"""Gradients and losses of the PyTorch port against the JAX package, on the CPU.

* plane sweep: gradients through the port's ``torch.autograd.Function``
  (its plain backward on the CPU) against ``jax.grad`` of
  ``depth_net.plane_sweep_correlation``'s XLA path, on a rig whose planes
  fall behind the neighbour camera;
* DFA3D: gradients of value, depth, locations and attention through the
  Function against ``jax.grad`` of the oracle ``msda.dfa3d_attention``, at
  stage-1 (heads = P = 1) and multi-head shapes, and the counted case;
* the Functions carry their own ``grad_fn`` and agree with plain autograd;
* every loss of the train step against its JAX function, values and
  gradients.

Tolerances: f32 on both sides, so only the summation order differs: 1e-5
of each output's largest magnitude for the ops and losses.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgcdet_tpu.geometry.boxes import axis_aligned_overlaps_3d as jax_overlaps
from sgcdet_tpu.models import depth_net as jdepth
from sgcdet_tpu.models import det_head as jhead
from sgcdet_tpu.models import losses as jlosses
from sgcdet_tpu.models.sparse_head import occ_loss as jax_occ_loss
from sgcdet_tpu.ops.msda import dfa3d_attention as jax_oracle

from sgcdet_tpu_torch.models import depth_net, det_head, losses
from sgcdet_tpu_torch.models.sparse_head import occ_loss
from sgcdet_tpu_torch.ops import dfa3d_attend
from sgcdet_tpu_torch.ops.dfa3d import dfa3d_attention_plain
from sgcdet_tpu_torch.ops.sweep import plane_sweep_correlation, sweep_fwd_plain

from torch_port_tiny import (  # noqa: F401 (keep_global_torch_rng is autouse)
    assert_close_scaled,
    dfa3d_inputs,
    graph_has,
    keep_global_torch_rng,
    sweep_inputs,
)

REL = 1e-5


def _torch_grads(fn, arrays, g, wrt):
    ts = [torch.from_numpy(a).requires_grad_(i in wrt) for i, a in enumerate(arrays)]
    out = fn(*ts)
    grads = torch.autograd.grad(out, [ts[i] for i in wrt], torch.from_numpy(g))
    return out, [x.numpy() for x in grads]


def test_sweep_grads_match_jax_with_behind_camera_planes():
    src, ref, src_proj, ref_proj, dv = sweep_inputs()
    g = np.random.RandomState(11).randn(src.shape[0], len(dv),
                                       *src.shape[2:]).astype(np.float32)
    out, (d_src, d_ref) = _torch_grads(plane_sweep_correlation,
                                       (src, ref, src_proj, ref_proj, dv), g, (0, 1))
    assert graph_has(out, "_SweepBackward")

    def loss(s, r):
        return jnp.sum(jdepth.plane_sweep_correlation(
            s, r, jnp.asarray(src_proj), jnp.asarray(ref_proj), jnp.asarray(dv)) * g)

    j_src, j_ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(src), jnp.asarray(ref))
    assert np.isfinite(d_src).all() and np.isfinite(d_ref).all()
    assert_close_scaled(d_src, np.asarray(j_src), REL, "sweep d_src")
    assert_close_scaled(d_ref, np.asarray(j_ref), REL, "sweep d_ref")


def test_sweep_function_matches_plain_autograd():
    """The Function's plain backward is the VJP of the plain forward."""
    rng = np.random.RandomState(12)
    n, h, w, c, d = 2, 5, 7, 8, 3
    arrays = (rng.randn(n, h, w, c).astype(np.float32),
              rng.randn(n, h, w, c).astype(np.float32),
              rng.uniform(-2, w + 1, (n, d, h * w)).astype(np.float32),
              rng.uniform(-2, h + 1, (n, d, h * w)).astype(np.float32))
    g = rng.randn(n, d, h * w).astype(np.float32)
    from sgcdet_tpu_torch.ops.sweep import sweep_fwd

    _, got = _torch_grads(sweep_fwd, arrays, g, (0, 1))
    _, want = _torch_grads(sweep_fwd_plain, arrays, g, (0, 1))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def _oracle_grads(value, dpt, locs, attn, heads, g):
    n, h, w, cfull = value.shape

    def loss(v, d, lo, at):
        out, _ = jax_oracle(v.reshape(n, h * w, heads, cfull // heads),
                            d.reshape(n, h * w, -1), ((h, w),),
                            lo[:, :, :, None], at[:, :, :, None])
        return jnp.sum(out * g)

    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (value, dpt, locs, attn)))
    return [np.asarray(x) for x in grads]


DFA3D_CASES = [pytest.param(1, 1, 64, id="stage1_h1_p1"),
               pytest.param(4, 2, 8, id="stage2_h4_p2"),
               pytest.param(8, 4, 4, id="multihead_h8_p4")]
GRAD_NAMES = ("d_value", "d_dpt", "d_locs", "d_attn")


@pytest.mark.parametrize("heads,p,c", DFA3D_CASES)
def test_dfa3d_grads_match_oracle(heads, p, c):
    value, dpt, locs, attn = dfa3d_inputs(heads, p, c, seed=4)
    g = np.random.RandomState(13).randn(value.shape[0], locs.shape[1],
                                       heads * c).astype(np.float32)
    out, got = _torch_grads(lambda *a: dfa3d_attend(*a, heads),
                            (value, dpt, locs, attn), g, (0, 1, 2, 3))
    assert graph_has(out, "_DFA3DBackward")
    want = _oracle_grads(value, dpt, locs, attn, heads, g)
    for name, a, b in zip(GRAD_NAMES, got, want):
        assert_close_scaled(a, b, REL, f"dfa3d {name}")
    # ... and the Function's plain backward is plain autograd's
    _, plain = _torch_grads(lambda *a: dfa3d_attention_plain(*a, heads),
                            (value, dpt, locs, attn), g, (0, 1, 2, 3))
    for name, a, b in zip(GRAD_NAMES, got, plain):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("heads,p,c", DFA3D_CASES[:2])
def test_dfa3d_counted_grads(heads, p, c):
    """Queries past valid_counts get zero location/attention gradients and
    scatter nothing: the oracle's gradients with those rows' incoming
    gradient zeroed."""
    value, dpt, locs, attn = dfa3d_inputs(heads, p, c, seed=5)
    n, k = locs.shape[:2]
    counts = np.array([0, 17, k], np.int32)
    locs[1, 30:] = np.nan  # must not leak from the counted-out region
    g = np.random.RandomState(14).randn(n, k, heads * c).astype(np.float32)
    _, got = _torch_grads(
        lambda *a: dfa3d_attend(*a, heads, valid_counts=torch.from_numpy(counts)),
        (value, dpt, locs, attn), g, (0, 1, 2, 3))
    live = np.arange(k)[None, :] < counts[:, None]
    want = _oracle_grads(value, dpt, np.where(np.isnan(locs), -1.0, locs), attn,
                         heads, g * live[..., None])
    for name, a, b in zip(GRAD_NAMES, got, want):
        assert np.isfinite(a).all(), name
        assert_close_scaled(a, b, REL, f"counted {name}")
    for cam, cnt in enumerate(counts):
        assert (got[2][cam, cnt:] == 0).all() and (got[3][cam, cnt:] == 0).all()


def test_dfa3d_stage1_skips_location_grads():
    """Stage 1 in the model: fixed locations and attention, so the backward
    returns value and depth gradients only."""
    value, dpt, locs, attn = dfa3d_inputs(1, 1, 64, seed=6)
    g = np.random.RandomState(15).randn(*value.shape[:1], locs.shape[1],
                                        64).astype(np.float32)
    _, (d_value, d_dpt) = _torch_grads(lambda *a: dfa3d_attend(*a, 1),
                                       (value, dpt, locs, attn), g, (0, 1))
    want = _oracle_grads(value, dpt, locs, attn, 1, g)
    assert_close_scaled(d_value, want[0], REL, "stage1 d_value")
    assert_close_scaled(d_dpt, want[1], REL, "stage1 d_dpt")


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _loss_and_grad(fn, x, *args):
    t = torch.from_numpy(x).requires_grad_()
    val = fn(t, *args)
    (g,) = torch.autograd.grad(val, t)
    return float(val.detach()), g.numpy()


def _check_loss(t_fn, j_fn, x, t_args, j_args, name):
    val, grad = _loss_and_grad(t_fn, x, *t_args)
    j_val, j_grad = jax.value_and_grad(j_fn)(jnp.asarray(x), *j_args)
    np.testing.assert_allclose(val, float(j_val), rtol=REL, err_msg=name)
    assert_close_scaled(grad, np.asarray(j_grad), REL, f"{name} grad")


def test_focal_and_bce_losses_match_jax():
    rng = np.random.RandomState(16)
    p, nc = 300, 5
    logits = (rng.randn(p, nc) * 3).astype(np.float32)
    labels = rng.randint(-1, nc, p).astype(np.int32)  # -1: background
    assert (labels == -1).any()
    mask = rng.rand(p) > 0.3
    avg = np.float32(37.0)
    _check_loss(losses.sigmoid_focal_loss, jlosses.sigmoid_focal_loss, logits,
                (torch.from_numpy(labels), nc, torch.from_numpy(mask),
                 torch.tensor(avg)),
                (jnp.asarray(labels), nc, jnp.asarray(mask), avg), "focal")
    targets = rng.rand(p).astype(np.float32)
    _check_loss(losses.bce_with_logits, jlosses.bce_with_logits, logits[:, 0],
                (torch.from_numpy(targets), torch.from_numpy(mask), torch.tensor(avg)),
                (jnp.asarray(targets), jnp.asarray(mask), avg), "bce")


def _random_corner_boxes(rng, m):
    lo = rng.uniform(-1, 1, (m, 3))
    return np.concatenate([lo, lo + rng.uniform(0.1, 1.0, (m, 3))], 1).astype(np.float32)


def test_iou_loss_and_overlaps_match_jax():
    rng = np.random.RandomState(17)
    pred, target = _random_corner_boxes(rng, 200), _random_corner_boxes(rng, 200)
    target[:20] = pred[:20] + 5.0  # disjoint pairs: IoU 0
    np.testing.assert_allclose(
        losses.axis_aligned_overlaps_3d(torch.from_numpy(pred), torch.from_numpy(target)).numpy(),
        np.asarray(jax_overlaps(jnp.asarray(pred), jnp.asarray(target), is_aligned=True)),
        rtol=1e-6, atol=1e-7)
    weight = rng.rand(200).astype(np.float32)
    _check_loss(losses.axis_aligned_iou_loss, jlosses.axis_aligned_iou_loss, pred,
                (torch.from_numpy(target), torch.from_numpy(weight),
                 torch.tensor(weight.sum())),
                (jnp.asarray(target), jnp.asarray(weight), weight.sum()), "iou")


def test_occ_loss_matches_jax():
    rng = np.random.RandomState(18)
    occ = rng.uniform(0, 1, 500).astype(np.float32)
    occ[:5] = [0.0, 1.0, 1e-9, 1 - 1e-9, 0.5]  # clipped ends
    geo = rng.rand(700) > 0.6
    _check_loss(occ_loss, jax_occ_loss, occ, (torch.from_numpy(geo),),
                (jnp.asarray(geo),), "occ")


@pytest.mark.parametrize("max_tol", [0, 1])
def test_depth_loss_matches_jax(max_tol):
    rng = np.random.RandomState(19 + max_tol)
    dbound, ds = (0.2, 5.0, 0.4), 4
    gt = rng.uniform(0.0, 6.0, (2, 24, 32)).astype(np.float32)
    gt[gt < 0.8] = 0.0  # invalid pixels
    gt[0, :ds, :ds] = 0.0  # a cell with no valid pixel
    d_ch = 12
    logits = rng.randn(2, d_ch, 24 // ds, 32 // ds).astype(np.float32)
    preds = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    np.testing.assert_array_equal(
        depth_net.downsample_gt_depth(torch.from_numpy(gt), ds, dbound, d_ch,
                                      max_tol).numpy(),
        np.asarray(jdepth.downsample_gt_depth(jnp.asarray(gt), ds, dbound, d_ch,
                                              max_tol)))
    _check_loss(lambda p: depth_net.depth_loss(torch.from_numpy(gt), p, ds, dbound,
                                               0.5, max_tol),
                lambda p: jdepth.depth_loss(jnp.asarray(gt), p, ds, dbound, 0.5,
                                            max_tol),
                preds.astype(np.float32), (), (), f"depth tol {max_tol}")


def _head_case(rng):
    sizes = [(8, 8, 4), (4, 4, 2), (2, 2, 1)]
    nc, vs = 3, (0.4, 0.4, 0.5)
    origin = np.array([0.0, 0.0, 0.5], np.float32)
    head_outs = [tuple((rng.randn(ch, *fs) * s).astype(np.float32)
                       for ch, s in ((1, 1.0), (6, 0.3), (nc, 1.0)))
                 for fs in sizes]
    head_outs = [(c, np.exp(b), k) for c, b, k in head_outs]
    boxes = np.zeros((8, 7), np.float32)
    boxes[:, :3] = rng.uniform(-1.2, 1.2, (8, 3))
    boxes[:, 2] += 0.5
    boxes[:, 3:6] = rng.uniform(0.4, 1.6, (8, 3))
    labels = rng.randint(0, nc, 8).astype(np.int32)
    mask = np.arange(8) < 6
    valids = rng.rand(sum(int(np.prod(s)) for s in sizes)) > 0.2
    return sizes, nc, vs, origin, head_outs, boxes, labels, mask, valids


def test_head_loss_matches_jax():
    """FCOS assignment (best scale, centerness top-k, min-volume box) and the
    three head losses on random head outputs, with gradients."""
    sizes, nc, vs, origin, head_outs, boxes, labels, mask, valids = _head_case(
        np.random.RandomState(21))
    cfg = type("Cfg", (), dict(n_classes=nc, n_scales=3, limit=4,
                               centerness_topk=5, head_type="scannet"))()
    t_outs = [tuple(torch.from_numpy(x).requires_grad_() for x in s) for s in head_outs]
    pts, scales, level_sizes = det_head.head_points(sizes, vs, torch.from_numpy(origin))
    j_pts, j_scales, _ = jhead.head_points(sizes, vs, jnp.asarray(origin))
    np.testing.assert_array_equal(pts.numpy(), np.asarray(j_pts))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(j_scales))
    got = det_head.head_loss_single(
        t_outs, torch.from_numpy(valids), pts, scales, level_sizes,
        torch.from_numpy(boxes), torch.from_numpy(labels), torch.from_numpy(mask), cfg)

    def j_loss(outs):
        return jhead.head_loss_single(
            outs, jnp.asarray(valids), j_pts, j_scales, level_sizes,
            jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask), cfg)

    want = j_loss([tuple(map(jnp.asarray, s)) for s in head_outs])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))  # labels
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))  # geo_occ
    assert float(got[5]) == float(want[5]) > 0  # n_pos
    for i, name in enumerate(("centerness", "bbox", "cls")):
        np.testing.assert_allclose(float(got[i].detach()), float(want[i]), rtol=REL,
                                   err_msg=name)
    total = sum(got[:3])
    t_grads = torch.autograd.grad(total, [x for s in t_outs for x in s])
    j_grads = jax.grad(lambda o: sum(j_loss(o)[:3]))(
        [tuple(map(jnp.asarray, s)) for s in head_outs])
    for a, b in zip(t_grads, jax.tree_util.tree_leaves(j_grads)):
        assert_close_scaled(a.numpy(), np.asarray(b), REL, "head loss grad")
