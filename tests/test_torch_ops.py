"""Ops of the PyTorch port against the JAX reference, on the CPU.

* plane sweep: the port's plain version vs ``depth_net.plane_sweep_correlation``
  (the XLA path the JAX package runs off-TPU), on a rig whose sweep planes
  fall behind the neighbour camera, and on a 7 x 9 map with 5 planes, one
  through the source camera, plus NaN / inf coordinates;
* DFA3D: the port's plain version vs the oracle ``msda.dfa3d_attention`` at
  stage-1 (heads = P = 1) and stage-2 (heads 4, P 2; c = 32 with 1, 2, 6
  heads x 4 points and 8 heads x 3 points) shapes and at the -L configs'
  widths (stage 1 at c = 128, 8 heads x 4 points at 16), with
  out-of-range locations, counted-out queries and NaN locations; at the -L
  widths its VJP against ``jax.vjp`` of the oracle too;
* the depth dtype rule: depth is read in f32 even with bf16 values;
* host NMS vs the JAX package's copy.

The CUDA kernels are held against these plain versions in
tests/test_torch_cuda.py, on a card.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgcdet_tpu.models.depth_net import plane_sweep_correlation as jax_sweep
from sgcdet_tpu.ops.dfa3d_fast import dfa3d_attention_fast
from sgcdet_tpu.ops.msda import dfa3d_attention as jax_oracle
from sgcdet_tpu.ops.nms import aligned_3d_nms as jax_nms

from sgcdet_tpu_torch.ops import aligned_3d_nms, dfa3d_attend
from sgcdet_tpu_torch.ops.dfa3d import dfa3d_attention_plain, dfa3d_bwd_plain
from sgcdet_tpu_torch.ops.sweep import (
    plane_sweep_correlation,
    plane_sweep_correlation_plain,
    sweep_fwd_plain,
)

from torch_port_tiny import (  # noqa: F401 (keep_global_torch_rng is autouse)
    assert_close_scaled,
    dfa3d_inputs,
    keep_global_torch_rng,
    sweep_edge_rig,
    sweep_inputs,
)


def _behind_camera_fraction(src_proj, ref_proj, dv, h, w):
    proj = src_proj @ np.linalg.inv(ref_proj)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    xyz = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)])
    z = (proj[:, 2:3, :3] @ xyz)[:, :, None, :] * dv[None, None, :, None] \
        + proj[:, 2:3, 3:4, None]
    return float((z <= 0).mean())


def test_plain_sweep_matches_jax_with_behind_camera_planes():
    src, ref, src_proj, ref_proj, dv = sweep_inputs()
    h, w = ref.shape[2:]
    assert _behind_camera_fraction(src_proj, ref_proj, dv, h, w) > 0.1
    expected = np.asarray(jax_sweep(*map(jnp.asarray, (src, ref, src_proj,
                                                       ref_proj, dv))))
    got = plane_sweep_correlation_plain(*map(torch.from_numpy, (
        src, ref, src_proj, ref_proj, dv)))
    assert got.dtype == torch.float32
    # f32 on both sides; only the summation order differs
    assert_close_scaled(got.numpy(), expected, 1e-5, "sweep f32")
    # the CPU dispatch takes the plain version
    disp = plane_sweep_correlation(*map(torch.from_numpy, (
        src, ref, src_proj, ref_proj, dv)))
    np.testing.assert_array_equal(disp.numpy(), got.numpy())


def test_plain_sweep_bf16_inputs_compute_in_f32():
    """bf16 features: f32 math, one rounding of the result to bf16
    (sweep_pallas.py:596) — equal to the f32 sweep of the bf16-rounded
    features, cast to bf16, within one bf16 ulp."""
    src, ref, src_proj, ref_proj, dv = sweep_inputs()
    src_b = torch.from_numpy(src).bfloat16()
    ref_b = torch.from_numpy(ref).bfloat16()
    got = plane_sweep_correlation_plain(src_b, ref_b, torch.from_numpy(src_proj),
                                        torch.from_numpy(ref_proj),
                                        torch.from_numpy(dv))
    assert got.dtype == torch.bfloat16
    expected = np.asarray(jax_sweep(
        jnp.asarray(src_b.float().numpy()), jnp.asarray(ref_b.float().numpy()),
        jnp.asarray(src_proj), jnp.asarray(ref_proj), jnp.asarray(dv)))
    assert_close_scaled(got.float().numpy(), expected, 2.0 ** -8, "sweep bf16")


def test_plain_sweep_non_finite_coordinates_contribute_zero():
    rng = np.random.RandomState(1)
    n, h, w, c, d = 2, 5, 7, 8, 3
    src = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32))
    ref = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-2, w + 1, (n, d, h * w)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-2, h + 1, (n, d, h * w)).astype(np.float32))
    bad = torch.zeros_like(x, dtype=torch.bool)
    bad.view(-1)[::5] = True
    for value in (float("nan"), float("inf"), -float("inf"), 1e30):
        xb = torch.where(bad, value, x)
        out = sweep_fwd_plain(src, ref, xb, y)
        assert torch.isfinite(out).all()
        assert (out[bad] == 0).all()
        np.testing.assert_array_equal(out[~bad].numpy(),
                                      sweep_fwd_plain(src, ref, x, y)[~bad].numpy())


def test_plain_sweep_matches_jax_on_ragged_tiles_and_a_plane_through_the_camera():
    """H * W = 63 and D = 5, the shape of K1's ragged-edge card cases: the
    plain version agrees with the JAX package wherever the coordinates are
    finite (in and off the image, behind and in front of the camera), and
    where the source camera's own plane gives inf and NaN coordinates it
    gives exact zeros, as the TPU kernel clips them (the JAX XLA path has
    no clip there and returns NaN)."""
    from sgcdet_tpu_torch.models.depth_net import _warp_grid

    rig = sweep_edge_rig()
    src, ref, src_proj, ref_proj, dv = rig
    n, c, h, w = src.shape
    expected = np.asarray(jax_sweep(*map(jnp.asarray, rig)))
    got = plane_sweep_correlation_plain(*map(torch.from_numpy, rig))
    assert got.shape == (n, len(dv), h, w) and torch.isfinite(got).all()
    x, y = _warp_grid(*map(torch.from_numpy, (src_proj, ref_proj, dv)), h, w)
    finite = (torch.isfinite(x) & torch.isfinite(y)).reshape(got.shape).numpy()
    assert 0 < finite.sum() < finite.size and np.isnan(x.numpy()).any()
    assert (got.numpy()[~finite] == 0).all()
    assert_close_scaled(got.numpy()[finite], expected[finite], 1e-5, "sweep 7x9 D=5")
    np.testing.assert_array_equal(
        sweep_fwd_plain(torch.from_numpy(src).permute(0, 2, 3, 1),
                        torch.from_numpy(ref).permute(0, 2, 3, 1), x, y).numpy(),
        got.reshape(n, len(dv), h * w).numpy())


def _oracle(value, dpt, locs, attn, heads):
    n, h, w, cfull = value.shape
    out, _ = jax_oracle(
        jnp.asarray(value.reshape(n, h * w, heads, cfull // heads)),
        jnp.asarray(dpt.reshape(n, h * w, -1)), ((h, w),),
        jnp.asarray(locs[:, :, :, None]), jnp.asarray(attn[:, :, :, None]))
    return np.asarray(out)


# stage 1, stage 2, and stage 2 at c = 32 with head groups that do not
# fill the kernels' warps (8 heads of 4 lanes): 1, 2 and 6 heads, and 8
# heads x 3 points (24 samples of a warp's 32 lanes); 8 heads x 1 point,
# a multi-head call that the card runs through K3
STAGES = [pytest.param(1, 1, 64, id="stage1_h1_p1"),
          pytest.param(4, 2, 8, id="stage2_h4_p2"),
          pytest.param(1, 4, 32, id="stage2_h1_p4"),
          pytest.param(2, 4, 32, id="stage2_h2_p4"),
          pytest.param(6, 4, 32, id="stage2_h6_p4"),
          pytest.param(8, 3, 32, id="stage2_h8_p3"),
          pytest.param(8, 1, 32, id="stage2_h8_p1"),
          # the -L configs' widths: stage 1 at c = 128, 8 heads x 4 points at 16
          pytest.param(1, 1, 128, id="stage1_h1_p1_c128"),
          pytest.param(8, 4, 16, id="stage2_h8_p4_c16")]


@pytest.mark.parametrize("heads,p,c", STAGES)
def test_plain_dfa3d_matches_oracle(heads, p, c):
    value, dpt, locs, attn = dfa3d_inputs(heads, p, c)
    expected = _oracle(value, dpt, locs, attn, heads)
    got = dfa3d_attention_plain(*map(torch.from_numpy, (value, dpt, locs, attn)),
                                heads)
    assert_close_scaled(got.numpy(), expected, 1e-5, "dfa3d plain vs oracle")
    # ... and vs the XLA patch-gather path the JAX package runs off-TPU
    fast = np.asarray(dfa3d_attention_fast(*map(jnp.asarray, (value, dpt, locs,
                                                              attn)), heads))
    assert_close_scaled(got.numpy(), fast, 1e-5, "dfa3d plain vs dfa3d_fast")
    # the CPU dispatch takes the plain version
    disp = dfa3d_attend(*map(torch.from_numpy, (value, dpt, locs, attn)), heads)
    np.testing.assert_array_equal(disp.numpy(), got.numpy())


@pytest.mark.parametrize("heads,p,c", STAGES[-2:])
def test_plain_dfa3d_vjp_matches_jax_vjp(heads, p, c):
    """The plain version's VJP (``dfa3d_bwd_plain``, the card backward's
    reference) at the -L widths against ``jax.vjp`` of the oracle: value,
    depth, location and attention gradients, a view counted to 0 and one
    in part."""
    value, dpt, locs, attn = dfa3d_inputs(heads, p, c, seed=7)
    n, k = locs.shape[:2]
    counts = np.array([0, 17, k], np.int32)
    g = np.random.RandomState(8).randn(n, k, heads * c).astype(np.float32)
    got = dfa3d_bwd_plain(*map(torch.from_numpy, (value, dpt, locs, attn, g)), heads,
                          valid_counts=torch.from_numpy(counts))
    h, w = value.shape[1:3]

    def oracle(v, d, lo, at):
        out, _ = jax_oracle(v.reshape(n, h * w, heads, c), d.reshape(n, h * w, -1),
                            ((h, w),), lo[:, :, :, None], at[:, :, :, None])
        return out

    live = (np.arange(k)[None, :] < counts[:, None])[..., None]
    _, vjp = jax.vjp(oracle, *map(jnp.asarray, (value, dpt, locs, attn)))
    want = vjp(jnp.asarray(g * live))
    for name, a, b in zip(("d_value", "d_dpt", "d_locs", "d_attn"), got, want):
        assert_close_scaled(a.numpy(), np.asarray(b), 1e-5, f"vjp {name}")
    for cam, cnt in enumerate(counts):
        assert (got[2][cam, cnt:] == 0).all() and (got[3][cam, cnt:] == 0).all()


@pytest.mark.parametrize("heads,p,c", STAGES)
def test_plain_dfa3d_counted_queries_are_exact_zeros(heads, p, c):
    value, dpt, locs, attn = dfa3d_inputs(heads, p, c, seed=1)
    k = locs.shape[1]
    counts = np.array([0, 17, k], np.int32)
    # NaN in the counted-out region must not leak either
    locs[1, 30:] = np.nan
    got = dfa3d_attention_plain(*map(torch.from_numpy, (value, dpt, locs, attn)),
                                heads, valid_counts=torch.from_numpy(counts))
    expected = _oracle(value, dpt, np.nan_to_num(locs, nan=-1.0), attn, heads)
    for cam, cnt in enumerate(counts):
        assert (got[cam, cnt:] == 0).all()
        if cnt:
            assert_close_scaled(got[cam, :cnt].numpy(), expected[cam, :cnt],
                                1e-5, f"counted cam {cam}")


def test_plain_dfa3d_nan_locations_contribute_zero():
    value, dpt, locs, attn = dfa3d_inputs(4, 2, 8, seed=2)
    far = locs.copy()
    nan = locs.copy()
    nan[:, ::3, :, :, 0] = np.nan
    far[:, ::3, :, :, 0] = -1.0  # every corner off the image
    a = dfa3d_attention_plain(*map(torch.from_numpy, (value, dpt, nan, attn)), 4)
    b = dfa3d_attention_plain(*map(torch.from_numpy, (value, dpt, far, attn)), 4)
    assert torch.isfinite(a).all()
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("heads,p,c", STAGES)
def test_plain_dfa3d_reads_depth_in_f32_with_bf16_values(heads, p, c):
    """The port follows the TPU kernels (dfa3d_pallas.py:77-78): bf16 value,
    f32 depth, f32 math, bf16 output — not the JAX CPU path, which casts
    depth to the value dtype (dfa3d_fast.py:257)."""
    value, dpt, locs, attn = dfa3d_inputs(heads, p, c, seed=3)
    value_b = torch.from_numpy(value).bfloat16()
    got = dfa3d_attention_plain(value_b, torch.from_numpy(dpt),
                                torch.from_numpy(locs), torch.from_numpy(attn),
                                heads)
    assert got.dtype == torch.bfloat16
    expected = _oracle(value_b.float().numpy(), dpt, locs, attn, heads)
    # one rounding of the f32 result to bf16
    assert_close_scaled(got.float().numpy(), expected, 2.0 ** -8, "bf16/f32")


def test_aligned_nms_matches_jax_copy():
    rng = np.random.RandomState(0)
    lo = rng.uniform(0, 4, (200, 3)).astype(np.float32)
    boxes = np.concatenate([lo, lo + rng.uniform(0.2, 1.5, (200, 3))], 1)
    scores = rng.uniform(0, 1, 200).astype(np.float32)
    labels = rng.randint(0, 4, 200)
    keep = aligned_3d_nms(boxes, scores, labels, 0.25)
    np.testing.assert_array_equal(keep, jax_nms(boxes, scores, labels, 0.25))
    assert 0 < len(keep) < 200
