"""The contention cases of the port's scatter-bound backward kernels, on the
CPU: the plain versions of the sweep backward (K4's) and of the DFA3D
backward at c = 32 per head, stage 2 (K5's) and stage 1 (K6's), against
``jax.vjp`` of the JAX package, at f32, on inputs made with numpy
(``tests/torch_port_tiny.py``, whose same cases ``tests/test_torch_cuda.py``
runs through the kernels on a card):

* sweeps whose coordinates pile many reference pixels onto one src pixel
  (a tile's, a whole image's, and a homography that collapses the image),
  on a 13 x 21 map that no tile divides; integer coordinates on the first
  and last row and column; a plane behind the source camera;
* a DFA3D stage 2 whose heads and points all sample one pixel centre per
  query; counted queries with a view of count 0; the same at stage 1, and
  every counted query of a view (4096 of them) on one pixel centre, the
  long lists of K6's pixel pass; the stage-2 cases through
  the plain version of the windowed backward of the sorted path (K5's
  warp with the chunk's depth in a window), with the kernel's own window
  plan and with a narrow one that leaves some chunks out of their window.

The plain versions are what the kernels are held to, so a case that the
JAX package and the plain version agree on pins the kernels' contract too.
Tolerance: f32 on both sides, so only the summation order differs: 1e-5 of
each gradient's largest magnitude.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgcdet_tpu.models import depth_net as jdepth
from sgcdet_tpu.ops.dfa3d_fast import bilinear_sample_patch
from sgcdet_tpu.ops.msda import dfa3d_attention as jax_oracle

from sgcdet_tpu_torch.ops import dfa3d_attend
from sgcdet_tpu_torch.ops._cuda import check_cuda_input
from sgcdet_tpu_torch.ops.dfa3d import S1_MAX_VIEWS, check_bwd_sizes, dfa3d_bwd_cuda
from sgcdet_tpu_torch.ops.dfa3d_windowed import (dfa3d_windowed_bwd_plain, kernel_plan,
                                                 plan_windows)
from sgcdet_tpu_torch.ops.sweep import plane_sweep_correlation, sweep_fwd

from torch_port_tiny import (  # noqa: F401 (keep_global_torch_rng is autouse)
    DFA3D_CONTENTION,
    DFA3D_S1_CONTENTION,
    SWEEP_CONTENTION,
    assert_close_scaled,
    dfa3d_contention_case,
    graph_has,
    keep_global_torch_rng,
    sweep_contention_case,
)

REL = 1e-5
GRAD_NAMES = ("d_value", "d_dpt", "d_locs", "d_attn")


def _jax_sweep(src, ref, x_eff, y_eff):
    """The JAX package's plane sweep off the TPU (``depth_net.
    plane_sweep_correlation``'s XLA path: one ``bilinear_sample_patch`` per
    plane, dot with the reference row, / sqrt(C)) at given sample
    coordinates.  (N, D, H*W)."""
    n, h, w, c = src.shape
    ref_flat = ref.reshape(n, h * w, c)
    planes = []
    for d in range(x_eff.shape[1]):
        warped = jax.vmap(bilinear_sample_patch)(src, x_eff[:, d], y_eff[:, d])
        planes.append((warped * ref_flat).sum(-1) / jnp.sqrt(jnp.float32(c)))
    return jnp.stack(planes, 1)


def _torch_grads(fn, arrays, g, wrt):
    ts = [torch.from_numpy(a).requires_grad_(i in wrt) for i, a in enumerate(arrays)]
    out = fn(*ts)
    grads = torch.autograd.grad(out, [ts[i] for i in wrt], torch.from_numpy(g))
    return out, [x.numpy() for x in grads]


@pytest.mark.parametrize("case", SWEEP_CONTENTION)
def test_sweep_backward_contention_matches_jax(case):
    src, ref, x_eff, y_eff, g = sweep_contention_case(case)
    out, (d_src, d_ref) = _torch_grads(sweep_fwd, (src, ref, x_eff, y_eff), g, (0, 1))
    assert graph_has(out, "_SweepBackward")
    _, vjp = jax.vjp(lambda s, r: _jax_sweep(s, r, jnp.asarray(x_eff), jnp.asarray(y_eff)),
                     jnp.asarray(src), jnp.asarray(ref))
    j_src, j_ref = vjp(jnp.asarray(g))
    assert np.abs(d_src).max() > 0
    assert_close_scaled(d_src, np.asarray(j_src), REL, f"{case} d_src")
    assert_close_scaled(d_ref, np.asarray(j_ref), REL, f"{case} d_ref")


def test_sweep_backward_homography_collapse_matches_jax():
    """A homography that sends every reference pixel of a plane to one src
    point (no rotation, the source ray fixed by the translation alone):
    through both packages' plane_sweep_correlation, projections in."""
    rng = np.random.RandomState(3)
    n, c, h, w = 2, 128, 13, 21
    src = rng.randn(n, c, h, w).astype(np.float32)
    ref = rng.randn(n, c, h, w).astype(np.float32)
    ref_proj = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    src_proj = np.tile(np.array([[0, 0, 0, 7.3], [0, 0, 0, 4.1], [0, 0, 1, 0],
                                 [0, 0, 0, 1]], np.float32), (n, 1, 1))
    dv = np.array([1.0, 1.7, 2.9, 4.1], np.float32)
    g = rng.randn(n, len(dv), h, w).astype(np.float32)
    out, (d_src, d_ref) = _torch_grads(plane_sweep_correlation,
                                       (src, ref, src_proj, ref_proj, dv), g, (0, 1))
    assert graph_has(out, "_SweepBackward")

    def corr(s, r):
        return jdepth.plane_sweep_correlation(s, r, jnp.asarray(src_proj),
                                              jnp.asarray(ref_proj), jnp.asarray(dv))

    _, vjp = jax.vjp(corr, jnp.asarray(src), jnp.asarray(ref))
    j_src, j_ref = vjp(jnp.asarray(g))
    # every plane's updates land on the four src pixels around one point
    assert (np.abs(d_src).sum(1) > 0).sum() <= 4 * len(dv) * n
    assert_close_scaled(d_src, np.asarray(j_src), REL, "collapse d_src")
    assert_close_scaled(d_ref, np.asarray(j_ref), REL, "collapse d_ref")


def _oracle_grads(value, dpt, locs, attn, heads, g):
    n, h, w, cfull = value.shape

    def attend(v, d, lo, at):
        out, _ = jax_oracle(v.reshape(n, h * w, heads, cfull // heads),
                            d.reshape(n, h * w, -1), ((h, w),),
                            lo[:, :, :, None], at[:, :, :, None])
        return out

    _, vjp = jax.vjp(attend, *map(jnp.asarray, (value, dpt, locs, attn)))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("case", DFA3D_CONTENTION + DFA3D_S1_CONTENTION)
def test_dfa3d_stage2_backward_contention_matches_jax(case):
    """Stage 2's cases, and stage 1's (``s1_``: one head, one point)."""
    value, dpt, locs, attn, g, counts = dfa3d_contention_case(case)
    heads = locs.shape[2]
    vc = None if counts is None else torch.from_numpy(counts)
    out, got = _torch_grads(lambda *a: dfa3d_attend(*a, heads, valid_counts=vc),
                            (value, dpt, locs, attn), g, (0, 1, 2, 3))
    assert graph_has(out, "_DFA3DBackward")
    g_live = g
    if counts is not None:  # counted-out queries pass no gradient
        g_live = g * (np.arange(g.shape[1])[None, :] < counts[:, None])[..., None]
    want = _oracle_grads(value, dpt, locs, attn, heads, g_live)
    for name, a, b in zip(GRAD_NAMES, got, want):
        assert np.isfinite(a).all(), name
        assert_close_scaled(a, b, REL, f"{case} {name}")
    touched = (np.abs(got[0]).sum(-1) > 0).sum((1, 2))  # value rows a view
    if case.endswith("one_corner"):  # three value rows per view take every update
        assert (touched <= 3).all()
    if case.endswith("long_list"):  # the four corners of one pixel centre
        assert touched[0] == 0 and (touched[1:] <= 4).all() and (touched[1:] > 0).all()
    if counts is not None:
        for cam, cnt in enumerate(counts):
            assert (got[2][cam, cnt:] == 0).all() and (got[3][cam, cnt:] == 0).all()


# (chunk, window) that leave some of a case's chunks out of their window
_NARROW_PLAN = {"one_corner": (4, 40), "counted": (1, 124)}


@pytest.mark.parametrize("plan_kind", ["kernel", "narrow"])
@pytest.mark.parametrize("case", DFA3D_CONTENTION)
def test_dfa3d_windowed_backward_contention_matches_jax(case, plan_kind):
    """The windowed backward's plain version (what dfa3d_win_bwd_mh is
    held to) on the contention cases: with the kernel's plan every chunk is
    served from its window (the map is smaller than the window); with a
    narrow plan some chunks are and some are not."""
    value, dpt, locs, attn, g, counts = dfa3d_contention_case(case)
    heads = locs.shape[2]
    ins = [torch.from_numpy(a) for a in (value, dpt, locs, attn)]
    vc = None if counts is None else torch.from_numpy(counts)
    if plan_kind == "kernel":
        plan = kernel_plan(*ins[:3], vc, backward=True)
        assert plan.ok.all()
    else:
        qc, wwin = _NARROW_PLAN[case]
        plan = plan_windows(ins[2], vc, value.shape[1], value.shape[2], wwin, qc=qc)
        live = plan.span > 0
        assert (plan.ok & live).any() and (~plan.ok & live).any()
    got = dfa3d_windowed_bwd_plain(*ins, torch.from_numpy(g), heads, vc, plan=plan)
    g_live = g
    if counts is not None:  # counted-out queries pass no gradient
        g_live = g * (np.arange(g.shape[1])[None, :] < counts[:, None])[..., None]
    want = _oracle_grads(value, dpt, locs, attn, heads, g_live)
    for name, a, b in zip(GRAD_NAMES, got, want):
        assert np.isfinite(a.numpy()).all(), name
        assert_close_scaled(a.numpy(), b, REL, f"{case} {plan_kind} {name}")
    if counts is not None:
        for cam, cnt in enumerate(counts):
            assert (got[2][cam, cnt:] == 0).all() and (got[3][cam, cnt:] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_operands_are_copied_to_16_byte_alignment(dtype):
    """The kernels read 16 bytes a lane: a contiguous view at an element
    offset that breaks 16-byte alignment reaches them as an aligned copy
    with the same values (the check the wrappers run before every launch,
    here on the CPU device)."""
    base = torch.arange(2 * 3 * 128 + 8, dtype=torch.float32).to(dtype)
    assert base.data_ptr() % 16 == 0
    view = base[1:1 + 768].view(2, 3, 128)
    assert view.is_contiguous() and view.data_ptr() % 16
    got = check_cuda_input(view, "src_img", (dtype,), 3, view.device)
    assert got.data_ptr() % 16 == 0
    assert torch.equal(got, view)
    step = 16 // base.element_size()  # an aligned view is passed as it is
    aligned = base[step:step + 768].view(2, 3, 128)
    assert check_cuda_input(aligned, "src_img", (dtype,), 3,
                            view.device).data_ptr() == aligned.data_ptr()


# (views, map, heads, points, c, bins, queries) past one limit each of the
# backward kernels, and the message the wrapper raises with
BWD_LIMITS = [
    pytest.param((2, (2, 2), 2, 4, 256, 12, 8), "c = 32 per head", id="multi_head_c256"),
    pytest.param((1025, (1, 1), 1, 1, 256, 12, 8), "at most 1024 views", id="s1_views"),
    pytest.param((1, (240, 240), 1, 1, 32, 2, 8), "at most 57344 pixels", id="s1_map"),
    pytest.param((1, (2, 2), 1, 1, 32, 214, 4096), "long pass needs", id="s1_long_pass"),
]


@pytest.mark.parametrize("sizes,match", BWD_LIMITS)
def test_backward_refuses_sizes_its_kernels_do_not_take(sizes, match):
    """The backward wrapper checks the sizes its kernels take before the
    launch and names the limit (here on the CPU device, where the checks
    run before any kernel is built): K5 is built for c = 32 per head; K6's
    list build counts a view's pixels in shared memory, its long pass the
    views' long lists and a bitmap of a list's queries beside its warps'
    rows and depth sums.  The largest sizes pass the check."""
    n, (h, w), heads, p, c, d, k = sizes
    value = torch.zeros((n, h, w, heads * c))
    args = (value, torch.zeros((n, h, w, d)), torch.full((n, k, heads, p, 3), 0.5),
            torch.ones((n, k, heads, p)), torch.zeros((n, k, heads * c)), heads)
    with pytest.raises(ValueError, match=match):
        dfa3d_bwd_cuda(*args)
    check_bwd_sizes(True, S1_MAX_VIEWS, 224, 256, 256, 12, 759264)
    check_bwd_sizes(True, 1, 1, 1, 32, 213, 4096)
    with pytest.raises(ValueError, match="long pass needs"):
        check_bwd_sizes(True, 1, 1, 1, 256, 12, 759265)
