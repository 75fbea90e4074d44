"""The port's CUDA kernels against their plain PyTorch versions, on a card:
the forward kernels K1-K3 (and K2'/K3' at bf16 depth), and the backward
kernels K4-K6 (K6'/K5') through autograd (the ops' ``torch.autograd.
Function``s) against the plain versions' VJPs, the DFA3D ones counted and
uncounted, also with head groups that fill only part of a warp, and K1 on a
map and plane count that no tile or plane group divides; K2's warps of
four rounds of queries at every built stage-1 width (counts and K that end
inside a warp and inside a round, views counted to 0, locations past the
map and depth bins past the range, the sorted query order); the 2D lifting
path
(``ViewTransformer(use_depth=False)``) through the kernels against its plain
run; the DFA3D kernels also at the -L configs' widths (K2 and K6 at c =
128, K3 and K5 at 16 a head, two queries a warp), the windowed kernels at
16 a head (two queries a warp, an odd K, a count that splits a pair) and
refusing 128 at stage 2; the backward kernels K4 and K5 on the contention cases of
``torch_port_tiny`` (many samples on one row, untiled sizes, integer and
edge coordinates, a plane behind the camera, counted views of count 0) and
on operands that are views at an offset breaking 16-byte alignment; the
windowed kernels of the ``sort_queries`` path against their plain versions
and the template kernels, in the coherent and random regimes, with partial
head groups, a chunk's window at the launch's window length and one pixel
past it, every sample of a chunk on one pixel, misaligned views, and their
shared memory against the plan's reservation; the sorted
``ViewTransformer`` through them; the row gather/scatter probe
kernels against their plain versions (int32 and int64 indices, ragged last
chunks, chunks exceeding the window, the windows of probe_window_matmul.py;
the gather epilogue at 1-8 points, on rows that fit its window or not, and
its refusal of more points),
a permutation moved bit for bit, the scatter equal from run to run and
within f32 summation error at probe_f32_onehot.py's shape, and the device
work of a probe call counted by torch.profiler; and the view sharding's
collectives (``parallel.gather_views``, ``sum_over_ranks``) with their
transposes on CUDA tensors in two gloo processes on the card; and
ResNet-50's frozen BN epilogue (``ops/frozen_bn.py``) forward and backward
against their plain versions at the serving shapes, bit-identical from run
to run, 53 launches each way a ResNet-50 in channels-last memory, and its
refusals of NCHW operands, other dtypes and widths.

Every test here is marked ``cuda`` and skips where torch sees no CUDA
device: the hand-written kernels have no CPU mode.  The module imports no
JAX, so it also runs on a GPU host without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sgcdet_tpu_torch.experiments import probes
from sgcdet_tpu_torch.models.depth_net import _warp_grid
from sgcdet_tpu_torch.models.layers import init_weights, set_compute_dtype
from sgcdet_tpu_torch.models.view_transformer import ViewTransformer
from sgcdet_tpu_torch.ops import KERNELS, dfa3d_attend, plain_ops
from sgcdet_tpu_torch.ops.dfa3d import (counter_name, dfa3d_attention_plain,
                                        dfa3d_bwd_cuda, dfa3d_bwd_plain, dfa3d_fwd_cuda)
from sgcdet_tpu_torch.ops.dfa3d_windowed import (QC_BWD, QC_FWD, WIN_CAP,
                                                 dfa3d_attention_windowed,
                                                 dfa3d_win_bwd_cuda, dfa3d_win_fwd_cuda,
                                                 kernel_resources, plan_windows,
                                                 win_counter, window_bytes,
                                                 window_length)
from sgcdet_tpu_torch.ops.frozen_bn import (frozen_bn, frozen_bn_bwd_cuda,
                                            frozen_bn_bwd_plain, frozen_bn_fwd_cuda,
                                            frozen_bn_plain)
from sgcdet_tpu_torch.ops.sweep import (plane_sweep_correlation, sweep_bwd_cuda,
                                        sweep_bwd_plain, sweep_fwd, sweep_fwd_cuda,
                                        sweep_fwd_plain)

from torch_port_tiny import (  # noqa: F401 (keep_global_torch_rng is autouse)
    DFA3D_CONTENTION,
    DFA3D_S1_CONTENTION,
    SWEEP_CONTENTION,
    assert_close_scaled,
    dfa3d_contention_case,
    dfa3d_inputs,
    graph_has,
    keep_global_torch_rng,
    launch_view_collectives,
    sweep_contention_case,
    sweep_edge_rig,
    sweep_inputs,
    windowed_inputs,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _rel(dtype):
    """Kernel and plain version both sum in f32 and round once to the output
    dtype, in different orders: one bf16 ulp, or f32 rounding noise."""
    return 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5


# (value, depth) type pairs of the DFA3D kernels
DFA3D_TYPES = [pytest.param(torch.bfloat16, torch.float32, id="bf16_f32"),
               pytest.param(torch.float32, torch.float32, id="f32_f32"),
               pytest.param(torch.bfloat16, torch.bfloat16, id="bf16_bf16")]


def _dfa3d_kernel_name(direction, heads, p, c, ddtype):
    """The launch counter of a DFA3D call: its instance's
    (ops/dfa3d.py::counter_name)."""
    return counter_name(direction == "bwd", heads == p == 1, c, ddtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sweep_kernel_matches_plain(cuda_device, dtype):
    src, ref, src_proj, ref_proj, dv = sweep_inputs(c=128)
    args = [torch.from_numpy(a).to(cuda_device) for a in (src, ref, src_proj,
                                                          ref_proj, dv)]
    args[0], args[1] = args[0].to(dtype), args[1].to(dtype)
    before = KERNELS["sweep_fwd"].launches
    got = plane_sweep_correlation(*args)
    assert KERNELS["sweep_fwd"].launches == before + 1
    with plain_ops():
        expected = plane_sweep_correlation(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert_close_scaled(got.float().cpu().numpy(), expected.float().cpu().numpy(),
                        _rel(dtype), "sweep kernel")


def test_sweep_kernel_non_finite_coordinates_contribute_zero(cuda_device):
    rng = np.random.RandomState(1)
    n, h, w, c, d = 2, 5, 7, 128, 3
    src, ref = (torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32))
                .to(cuda_device) for _ in range(2))
    x = torch.from_numpy(rng.uniform(-2, w + 1, (n, d, h * w)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-2, h + 1, (n, d, h * w)).astype(np.float32))
    x, y = x.to(cuda_device), y.to(cuda_device)
    bad = torch.zeros_like(x, dtype=torch.bool)
    bad.view(-1)[::5] = True
    clean = sweep_fwd(src, ref, x, y)
    for value in (float("nan"), float("inf"), -float("inf"), 1e30):
        out = sweep_fwd(src, ref, torch.where(bad, value, x), y)
        assert torch.isfinite(out).all()
        assert (out[bad] == 0).all()
        assert torch.equal(out[~bad], clean[~bad])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sweep_kernel_ragged_tile_and_plane_group(cuda_device, dtype):
    """K1 where H * W = 63 fills no tile of reference pixels and D = 5 no
    group of planes loaded together, on a rig with planes behind, through
    (inf and NaN coordinates) and in front of the source camera, and with
    more NaN / inf / far-off coordinates injected."""
    src, ref, src_proj, ref_proj, dv = (torch.from_numpy(a).to(cuda_device)
                                        for a in sweep_edge_rig())
    n, c, h, w = src.shape
    x, y = _warp_grid(src_proj, ref_proj, dv, h, w)
    x.view(-1)[::11] = float("nan")
    y.view(-1)[5::13] = -float("inf")
    x.view(-1)[7::17] = 1e30
    src, ref = (t.permute(0, 2, 3, 1).to(dtype) for t in (src, ref))
    before = KERNELS["sweep_fwd"].launches
    got = sweep_fwd_cuda(src, ref, x, y)
    assert KERNELS["sweep_fwd"].launches == before + 1
    want = sweep_fwd_plain(src, ref, x, y)
    torch.cuda.synchronize()
    assert got.shape == (n, len(dv), h * w) and torch.isfinite(got).all()
    off = ~(torch.isfinite(x) & torch.isfinite(y))
    assert off.any() and (got[off] == 0).all()
    assert_close_scaled(got.cpu().numpy(), want.cpu().numpy(), 1e-5, "sweep 7x9 D=5")


# (heads, points, channels per head): stage 1, stage 2, and stage 2 with
# head groups that do not fill a warp of eight 4-lane heads (1, 2, 6 heads;
# 8 heads x 3 points, 24 samples for 32 lanes); then the -L configs'
# widths: stage 1 at c = 128, stage 2 at 16 a head (a warp of 16 2-lane
# rows: two queries of 8 heads, 16 of 1 head, and with 6 heads two
# queries on 12 of its rows); and stage 1 at c = 32, built though no
# config reaches it
DFA3D_SHAPES = [pytest.param(1, 1, 256, id="stage1"), pytest.param(8, 4, 32, id="stage2"),
                pytest.param(1, 4, 32, id="stage2_h1"), pytest.param(2, 4, 32, id="stage2_h2"),
                pytest.param(6, 4, 32, id="stage2_h6"), pytest.param(8, 3, 32, id="stage2_p3"),
                pytest.param(1, 1, 128, id="stage1_c128"),
                pytest.param(8, 4, 16, id="stage2_c16"),
                pytest.param(1, 4, 16, id="stage2_c16_h1"),
                pytest.param(6, 4, 16, id="stage2_c16_h6"),
                pytest.param(1, 1, 32, id="stage1_c32")]
# the forward also takes multi-head c = 128 (16 lanes a head, two heads a
# warp), which the backward does not, and a multi-head call with one
# point, which goes to K3 and is counted as such
DFA3D_FWD_SHAPES = DFA3D_SHAPES + [pytest.param(2, 4, 128, id="stage2_c128_h2"),
                                   pytest.param(8, 1, 32, id="stage2_h8_p1")]


def _counts(counted, device):
    return (torch.tensor([0, 100, 299, 300], dtype=torch.int32, device=device)
            if counted else None)


@pytest.mark.parametrize("heads,p,c", DFA3D_FWD_SHAPES)
@pytest.mark.parametrize("vdtype,ddtype", DFA3D_TYPES)
@pytest.mark.parametrize("counted", [True, False], ids=["counted", "uncounted"])
def test_dfa3d_kernel_matches_plain(cuda_device, heads, p, c, vdtype, ddtype, counted):
    value, dpt, locs, attn = dfa3d_inputs(heads, p, c, n=4, h=14, w=20, d=12,
                                          k=300)
    counts = _counts(counted, cuda_device)
    args = [torch.from_numpy(a).to(cuda_device) for a in (value, dpt, locs, attn)]
    args[0], args[1] = args[0].to(vdtype), args[1].to(ddtype)
    name = _dfa3d_kernel_name("fwd", heads, p, c, ddtype)
    before = KERNELS[name].launches
    got = dfa3d_attend(*args, heads, valid_counts=counts)
    assert KERNELS[name].launches == before + 1
    with plain_ops():
        expected = dfa3d_attend(*args, heads, valid_counts=counts)
    torch.cuda.synchronize()
    assert got.dtype == vdtype
    assert_close_scaled(got.float().cpu().numpy(), expected.float().cpu().numpy(),
                        _rel(vdtype), "dfa3d kernel")
    for cam, cnt in enumerate(counts.tolist() if counted else []):
        assert (got[cam, cnt:] == 0).all()


def _pixel_order(locs, h, w):
    """Each view's queries of ``locs`` (N, K, 1, 1, 3) reordered by the
    pixel their location falls on, as the sorted path orders them."""
    pix = (torch.floor(locs[:, :, 0, 0, 1] * h) * w + torch.floor(locs[:, :, 0, 0, 0] * w))
    order = torch.argsort(pix, dim=1, stable=True)
    return torch.gather(locs, 1, order[:, :, None, None, None].expand_as(locs))


@pytest.mark.parametrize("order", ["index", "sorted"])
@pytest.mark.parametrize("c", [32, 128, 256])
@pytest.mark.parametrize("vdtype,ddtype", DFA3D_TYPES)
def test_stage1_kernel_warp_and_round_edges(cuda_device, vdtype, ddtype, c, order):
    """K2 takes four rounds of queries of a view a warp, a round 32 / (c /
    8) queries at bf16 (eight at c = 32, two at 128, one at 256) and 32 /
    (c / 4) at f32, at most 32 a warp: K = 75 leaves a ragged last warp at
    every width; the counts end at a view's start (0), one query into a
    warp (33), inside a round of two and of eight (45), inside the ragged
    last warp at c = 32 (70) and at K; locations past the map and depth
    bins past either end (with NaN ones), in index order and sorted by
    pixel."""
    n, h, w, d, k = 5, 14, 20, 12, 75
    value, dpt, locs, attn = dfa3d_inputs(1, 1, c, n=n, h=h, w=w, d=d, k=k, seed=11)
    locs[:, ::9, ..., 0] = np.nan
    locs[:, 4::13, ..., 2] = -0.4  # both depth bins below the range
    locs[:, 5::13, ..., 2] = 1.4   # and above it
    args = [torch.from_numpy(a).to(cuda_device) for a in (value, dpt, locs, attn)]
    args[0], args[1] = args[0].to(vdtype), args[1].to(ddtype)
    if order == "sorted":
        args[2] = _pixel_order(args[2], h, w)
    counts = torch.tensor([0, 33, 45, 70, k], dtype=torch.int32, device=cuda_device)
    name = counter_name(False, True, c, ddtype)
    before = KERNELS[name].launches
    got = dfa3d_fwd_cuda(*args, 1, counts)
    assert KERNELS[name].launches == before + 1
    want = dfa3d_attention_plain(*args, 1, counts)
    torch.cuda.synchronize()
    assert got.dtype == vdtype and torch.isfinite(got.float()).all()
    assert_close_scaled(got.float().cpu().numpy(), want.float().cpu().numpy(),
                        _rel(vdtype), f"stage 1 c={c} {order}")
    for cam, cnt in enumerate(counts.tolist()):
        assert (got[cam, cnt:] == 0).all()
    uncounted = dfa3d_fwd_cuda(*args, 1)
    assert_close_scaled(uncounted.float().cpu().numpy(),
                        dfa3d_attention_plain(*args, 1).float().cpu().numpy(),
                        _rel(vdtype), f"stage 1 c={c} {order} uncounted")


def test_dfa3d_kernel_rejects_cpu_operands_on_the_card_path(cuda_device):
    """A CUDA value tensor goes to the kernel, which refuses operands left on
    the CPU instead of falling back to the plain version."""
    value, dpt, locs, attn = dfa3d_inputs(8, 4, 32, k=8)
    with pytest.raises(ValueError, match="expected cuda"):
        dfa3d_attend(torch.from_numpy(value).to(cuda_device), torch.from_numpy(dpt),
                     torch.from_numpy(locs), torch.from_numpy(attn), 8)


def _grads(out, inputs, g):
    return torch.autograd.grad(out, [t for t in inputs if t.requires_grad], g)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sweep_backward_kernel_matches_plain(cuda_device, dtype):
    src, ref, src_proj, ref_proj, dv = sweep_inputs(c=128)
    args = [torch.from_numpy(a).to(cuda_device) for a in (src, ref, src_proj,
                                                          ref_proj, dv)]
    args[0], args[1] = (a.to(dtype).requires_grad_() for a in args[:2])
    g = torch.randn((src.shape[0], len(dv)) + src.shape[2:], device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(0)).to(dtype)
    out = plane_sweep_correlation(*args)
    assert graph_has(out, "_SweepBackward")
    before = KERNELS["sweep_bwd"].launches
    got = _grads(out, args[:2], g)
    assert KERNELS["sweep_bwd"].launches == before + 1
    with plain_ops():
        expected = _grads(plane_sweep_correlation(*args), args[:2], g)
    torch.cuda.synchronize()
    for name, a, b in zip(("d_src", "d_ref"), got, expected):
        assert a.dtype == dtype
        assert_close_scaled(a.float().cpu().numpy(), b.float().cpu().numpy(),
                            _rel(dtype), f"sweep {name}")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", SWEEP_CONTENTION)
def test_sweep_backward_kernel_contention(cuda_device, case, dtype):
    """K4's vector reductions where many samples add into one src row."""
    src, ref, x, y, g = (torch.from_numpy(a).to(cuda_device)
                         for a in sweep_contention_case(case))
    src, ref = src.to(dtype), ref.to(dtype)
    before = KERNELS["sweep_bwd"].launches
    got = sweep_bwd_cuda(src, ref, x, y, g)
    assert KERNELS["sweep_bwd"].launches == before + 1
    want = sweep_bwd_plain(src, ref, x, y, g)
    torch.cuda.synchronize()
    for name, a, b in zip(("d_src", "d_ref"), got, want):
        assert a.dtype == dtype
        assert_close_scaled(a.float().cpu().numpy(), b.float().cpu().numpy(),
                            _rel(dtype), f"{case} {name}")


def _contention_case(case, device, vdtype, ddtype, c=None):
    """A DFA3D contention case on the card at c channels a head (by default
    the ScanNet widths: stage 1's 256, stage 2's 32): (value, depth, locs,
    attn, g, counts)."""
    if c is None:
        c = 256 if case.startswith("s1_") else 32
    value, dpt, locs, attn, g, counts = (
        None if a is None else torch.from_numpy(a).to(device)
        for a in dfa3d_contention_case(case, c=c))
    return value.to(vdtype), dpt.to(ddtype), locs, attn, g.to(vdtype), counts


# the contention cases at the ScanNet widths, and at the -L configs': K6's
# long lists at c = 128, K5's cases at 16 a head (two queries a warp); and
# K6's long lists at c = 32, built though no config reaches it
CONTENTION_WIDTHS = ([pytest.param(case, None, id=case)
                      for case in DFA3D_CONTENTION + DFA3D_S1_CONTENTION]
                     + [pytest.param("s1_long_list", 128, id="s1_long_list_c128"),
                        pytest.param("s1_long_list", 32, id="s1_long_list_c32")]
                     + [pytest.param(case, 16, id=f"{case}_c16") for case in DFA3D_CONTENTION])


@pytest.mark.parametrize("vdtype,ddtype", DFA3D_TYPES)
@pytest.mark.parametrize("case,c", CONTENTION_WIDTHS)
def test_dfa3d_stage2_backward_kernel_contention(cuda_device, case, c, vdtype, ddtype):
    """K5 (K5' at bf16 depth): a query's eight heads on one warp, all on one
    pixel; counted views of count 0.  K6 (K6') on stage 1's cases at c =
    256: one pixel for many queries, and lists of 4096 entries (the long
    pass); the long lists at c = 128 too, and K5's cases at 16 a head."""
    value, dpt, locs, attn, g, counts = _contention_case(case, cuda_device, vdtype,
                                                         ddtype, c)
    heads = locs.shape[2]
    name = _dfa3d_kernel_name("bwd", heads, locs.shape[3], value.shape[-1] // heads,
                              ddtype)
    before = KERNELS[name].launches
    got = dfa3d_bwd_cuda(value, dpt, locs, attn, g, heads, counts)
    assert KERNELS[name].launches == before + 1
    want = dfa3d_bwd_plain(value, dpt, locs, attn, g, heads, counts)
    torch.cuda.synchronize()
    for gname, a, b in zip(("d_value", "d_dpt", "d_locs", "d_attn"), got, want):
        assert_close_scaled(a.float().cpu().numpy(), b.float().cpu().numpy(),
                            _rel(a.dtype), f"{case} {gname}")
    if counts is not None:
        for cam, cnt in enumerate(counts.tolist()):
            assert (got[2][cam, cnt:] == 0).all() and (got[3][cam, cnt:] == 0).all()


def _misaligned(t):
    """A contiguous copy of ``t`` that starts one element past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_take_misaligned_views(cuda_device, dtype):
    """The 16-byte loads never see a misaligned operand: the wrappers copy
    a view that breaks the alignment, so the sweep and the DFA3D stage 2,
    forward and backward, give the plain versions' results on it."""
    src, ref, x, y, g = (torch.from_numpy(a).to(cuda_device)
                         for a in sweep_contention_case("tile_collapse"))
    src, ref = _misaligned(src.to(dtype)), _misaligned(ref.to(dtype))
    pairs = [(sweep_fwd_cuda(src, ref, x, y), sweep_fwd_plain(src, ref, x, y))]
    pairs += zip(sweep_bwd_cuda(src, ref, x, y, g), sweep_bwd_plain(src, ref, x, y, g))
    value, dpt, locs, attn, g2, _ = (None if a is None else torch.from_numpy(a).to(cuda_device)
                                     for a in dfa3d_contention_case("counted"))
    value, g2 = _misaligned(value.to(dtype)), _misaligned(g2.to(dtype))
    pairs.append((dfa3d_fwd_cuda(value, dpt, locs, attn, 8),
                  dfa3d_attention_plain(value, dpt, locs, attn, 8)))
    pairs += zip(dfa3d_bwd_cuda(value, dpt, locs, attn, g2, 8),
                 dfa3d_bwd_plain(value, dpt, locs, attn, g2, 8))
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(pairs):
        assert_close_scaled(a.float().cpu().numpy(), b.float().cpu().numpy(),
                            _rel(a.dtype), f"misaligned output {i}")


@pytest.mark.parametrize("heads,p,c", DFA3D_SHAPES)
@pytest.mark.parametrize("vdtype,ddtype", DFA3D_TYPES)
@pytest.mark.parametrize("sample_grads,depth_grad",
                         [(True, True), (False, True), (True, False), (False, False)],
                         ids=["all", "value_depth", "no_depth", "value_only"])
@pytest.mark.parametrize("counted", [True, False], ids=["counted", "uncounted"])
def test_dfa3d_backward_kernel_matches_plain(cuda_device, heads, p, c, vdtype,
                                             ddtype, sample_grads, depth_grad, counted):
    value, dpt, locs, attn = dfa3d_inputs(heads, p, c, n=4, h=14, w=20, d=12,
                                          k=300)
    counts = _counts(counted, cuda_device)
    args = [torch.from_numpy(a).to(cuda_device) for a in (value, dpt, locs, attn)]
    args[0], args[1] = args[0].to(vdtype), args[1].to(ddtype)
    for a, want in zip(args, (True, depth_grad, sample_grads, sample_grads)):
        a.requires_grad_(want)
    g = torch.randn((4, 300, heads * c), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(0)).to(vdtype)
    out = dfa3d_attend(*args, heads, valid_counts=counts)
    assert graph_has(out, "_DFA3DBackward")
    name = _dfa3d_kernel_name("bwd", heads, p, c, ddtype)
    before = KERNELS[name].launches
    got = _grads(out, args, g)
    assert KERNELS[name].launches == before + 1
    with plain_ops():
        expected = _grads(dfa3d_attend(*args, heads, valid_counts=counts), args, g)
    torch.cuda.synchronize()
    names = [n for n, a in zip(("d_value", "d_dpt", "d_locs", "d_attn"), args)
             if a.requires_grad]
    for gname, a, b, inp in zip(names, got, expected,
                                [a for a in args if a.requires_grad]):
        assert a.dtype == inp.dtype
        # f32 gradients sum in another order (atomics): 1e-5 of the scale
        rel = _rel(a.dtype)
        assert_close_scaled(a.float().cpu().numpy(), b.float().cpu().numpy(),
                            rel, f"dfa3d {gname}")
    if sample_grads and counted:
        by_name = dict(zip(names, got))
        for cam, cnt in enumerate(counts.tolist()):
            assert (by_name["d_locs"][cam, cnt:] == 0).all()
            assert (by_name["d_attn"][cam, cnt:] == 0).all()


def test_dfa3d_kernel_refuses_f32_value_with_bf16_depth(cuda_device):
    value, dpt, locs, attn = (torch.from_numpy(a).to(cuda_device)
                              for a in dfa3d_inputs(8, 4, 32, k=8))
    with pytest.raises(TypeError, match="bf16 depth"):
        dfa3d_attend(value, dpt.bfloat16(), locs, attn, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_2d_lifting_kernels_match_plain(cuda_device, dtype):
    """ViewTransformer(use_depth=False) at the ScanNet widths (embed 256,
    8 heads x 4 points) on a small rig: output and the gradients of
    sum(out * g) through the kernels vs the plain versions, and one stage-1
    and one stage-2 launch each way, on the bf16-depth counters at bf16."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(5)
    n, k, h, w = 3, 200, 15, 20
    model = ViewTransformer(256, 8, 4, use_depth=False)
    init_weights(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():  # exercise the zero-initialized offsets
            p.add_(0.02 * torch.from_numpy(rng.randn(*p.shape).astype(np.float32)))
    set_compute_dtype(model, dtype)
    model = model.to(cuda_device).eval()
    dev = dict(device=cuda_device)
    ref = torch.from_numpy(rng.uniform(-1, 1, (k, 3)).astype(np.float32)).to(**dev)
    proj = torch.from_numpy(np.tile(np.array(
        [[300, 0, 320, 0], [0, 300, 240, 0], [0, 0, 1, 2.5]], np.float32),
        (n, 1, 1))).to(**dev)
    feat = torch.from_numpy(rng.randn(n, 256, h, w).astype(np.float32)).to(**dev)
    feat = feat.to(dtype).requires_grad_()
    g = torch.from_numpy(rng.randn(k, 256).astype(np.float32)).to(**dev)
    dpt = torch.zeros((n, 12, h, w), **dev)  # unused on the 2D path
    args = (ref, torch.zeros(3, **dev), proj, feat, dpt, (480, 640), (0.2, 8.0, 0.4))

    def run():
        out = model(*args)
        grads = torch.autograd.grad((out.float() * g).sum(),
                                    [feat] + list(model.parameters()))
        return [out.detach()] + list(grads)

    depth_dtype = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    names = [counter_name(backward, stage1, 256 if stage1 else 32, depth_dtype)
             for backward in (False, True) for stage1 in (True, False)]
    before = [KERNELS[nm].launches for nm in names]
    got = run()
    assert [KERNELS[nm].launches - b for nm, b in zip(names, before)] == [1, 1, 1, 1]
    with plain_ops():
        expected = run()
    torch.cuda.synchronize()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    # f32: summation order (atomics) through softmax, MHA and LayerNorm;
    # bf16: rounding of the bf16 activations between the two runs
    rel = 1e-3 if dtype == torch.float32 else 5e-2
    for i, (a, b) in enumerate(zip(got, expected)):
        assert torch.isfinite(a.float()).all()
        assert_close_scaled(a.float().cpu().numpy(), b.float().cpu().numpy(), rel,
                            f"2D lifting tensor {i}")


GRAD_FLAGS = [(True, True), (False, True), (True, False), (False, False)]
GRAD_IDS = ["all", "value_depth", "no_depth", "value_only"]


def _poison_allocator(device, blocks=16):
    """Fill the caching allocator's free memory of its small pool (the
    allocations of up to 1 MB) with NaN bytes (0xff: NaN in f32 and bf16)
    and free it again, after emptying its cache: every free block of the
    segments still in use, largest first and in pieces of at most 1 MB,
    then ``blocks`` more 1 MB blocks (two to each new 2 MB segment), so
    every later allocation of up to 1 MB comes from memory that holds NaN.
    Returns the poisoned (start, end) ranges."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    free = sorted((b["size"] for seg in torch.cuda.memory_snapshot()
                   if seg["device"] == device.index and seg["segment_type"] == "small"
                   for b in seg["blocks"] if b["state"] == "inactive"), reverse=True)
    pieces = [min(size - at, 1 << 20) for size in free for at in range(0, size, 1 << 20)]
    poison = [torch.full((nbytes,), 255, dtype=torch.uint8, device=device)
              for nbytes in pieces + [1 << 20] * blocks]
    torch.cuda.synchronize(device)
    ranges = [(t.data_ptr(), t.data_ptr() + t.numel()) for t in poison]
    del poison
    return ranges


@pytest.mark.parametrize("vdtype,ddtype", DFA3D_TYPES)
@pytest.mark.parametrize("sample_grads,depth_grad", GRAD_FLAGS, ids=GRAD_IDS)
@pytest.mark.parametrize("case", DFA3D_S1_CONTENTION[1:])
def test_stage1_backward_writes_every_element(cuda_device, case, vdtype, ddtype,
                                              sample_grads, depth_grad):
    """K6 (K6') writes each d_value and d_depth element itself, no zero
    fill ahead of it: after the caching allocator's memory is filled with
    NaN, every element that no counted corner touches is exactly 0 (a view
    counted to 0 among them), the rest matches the plain version, and two
    calls give the same bits (each pixel sums its entries in query
    order)."""
    value, dpt, locs, attn, g, counts = _contention_case(case, cuda_device, vdtype,
                                                         ddtype)
    n, h, w, _ = value.shape
    kw = dict(sample_grads=sample_grads, depth_grad=depth_grad)
    want = dfa3d_bwd_plain(value, dpt, locs, attn, g, 1, counts, **kw)
    ranges = _poison_allocator(cuda_device)
    name = _dfa3d_kernel_name("bwd", 1, 1, value.shape[-1], ddtype)
    before = KERNELS[name].launches
    got = dfa3d_bwd_cuda(value, dpt, locs, attn, g, 1, counts, **kw)
    assert KERNELS[name].launches == before + 1
    again = dfa3d_bwd_cuda(value, dpt, locs, attn, g, 1, counts, **kw)
    torch.cuda.synchronize()
    for grad in got[:2]:
        if grad is not None:  # the outputs took poisoned memory
            end = grad.data_ptr() + grad.numel() * grad.element_size()
            assert any(a <= grad.data_ptr() < b for a, b in ranges)
            assert any(a < end <= b for a, b in ranges)
    # the pixels a counted corner lies on
    x = torch.floor(locs[:, :, 0, 0, 0] * w - 0.5).long()
    y = torch.floor(locs[:, :, 0, 0, 1] * h - 0.5).long()
    live = torch.arange(locs.shape[1], device=cuda_device)[None, :] < counts[:, None]
    touched = torch.zeros((n, h, w), dtype=torch.bool, device=cuda_device)
    for dy in (0, 1):
        for dx in (0, 1):
            ok = live & (x + dx >= 0) & (x + dx < w) & (y + dy >= 0) & (y + dy < h)
            cam = torch.arange(n, device=cuda_device)[:, None].expand_as(ok)
            touched[cam[ok], (y + dy)[ok], (x + dx)[ok]] = True
    assert not touched[0].any() and touched.any()
    for gname, a, b, c in zip(("d_value", "d_dpt", "d_locs", "d_attn"), got, want, again):
        assert (a is None) == (b is None), gname
        if a is None:
            continue
        assert torch.isfinite(a).all(), gname
        assert torch.equal(a, c), f"{gname} differs from run to run"
        if gname in ("d_value", "d_dpt"):
            assert (a[~touched] == 0).all(), gname
        assert_close_scaled(a.float().cpu().numpy(), b.float().cpu().numpy(),
                            _rel(a.dtype), f"{case} {gname}")


# cases of the windowed kernels: "coherent" locations keep their chunks in
# the window, "random" ones do not; "cap": one chunk's union spans exactly
# the window length the kernel is launched with and the next one pixel
# more (one staged, one on the global branch); "one_pixel": every sample
# of a chunk on one pixel centre, a view counted to 0; "misaligned":
# coherent operands that are views breaking 16-byte alignment.  The
# windowed op sends stage 1 to K2: its cases hold K2 on sorted queries
# against the plain version
WINDOW_CASES = ["coherent", "random", "cap", "one_pixel", "misaligned"]
# (heads, points, c): stage 1, stage 2 and its partial head groups (the
# backward's shapes), and the multi-head forward at c = 256
WINDOW_SHAPES = [(8, 4, 32), (1, 4, 32), (2, 4, 32), (6, 4, 32), (8, 3, 32)]
# ... and at the -L configs' c = 16 a head, where a warp takes two queries
# of 8 heads (eight of 2); these run at an odd K (599: a view's last query
# alone in its warp) with a count that splits a pair (201)
WINDOW_SHAPES_C16 = [(8, 4, 16), (2, 4, 16), (8, 3, 16)]


WINDOW_FWD = ([pytest.param(*shape, case, id=f"{sid}-{case}") for shape, sid in
               zip([(1, 1, 256)] + WINDOW_SHAPES + [(2, 4, 256)] + WINDOW_SHAPES_C16,
                   ["stage1", "stage2", "stage2_h1", "stage2_h2", "stage2_h6",
                    "stage2_p3", "c256_h2", "c16", "c16_h2", "c16_p3"])
               for case in (WINDOW_CASES if shape[:2] == (8, 4) else WINDOW_CASES[:2])])
WINDOW_BWD = ([pytest.param(*shape, case, id=case if shape == (8, 4, 32) else
                            f"h{shape[0]}p{shape[1]}-{case}" if shape[2] == 32 else
                            f"c16_h{shape[0]}p{shape[1]}-{case}")
               for shape in WINDOW_SHAPES + WINDOW_SHAPES_C16
               for case in (WINDOW_CASES if shape[:2] == (8, 4) else WINDOW_CASES[:2])])


def _window_k_counts(c):
    """Queries a view and the views' counts of a windowed case: 600 and (0,
    200, 599, 600); at c = 16, where a warp takes two queries, an odd K and
    a count that splits a pair."""
    return (599, (0, 201, 598, 599)) if c == 16 else (600, (0, 200, 599, 600))


def _windowed_case(cuda_device, heads, p, c, vdtype, ddtype, case, backward=False):
    """Operands and counts at the chunks of the forward or the backward.  A
    (4, 30, 40) map ((4, 32, 64) for "cap" and "one_pixel", whose pixel
    centres are exact in f32, and for "random", whose chunks then span
    more than the kernels' window), 600 queries, 12 depth bins; counts 0,
    200, 599 and 600 (at c = 16 ``_window_k_counts``'s).  Stage 1 has no
    windowed kernel and no plan."""
    h, w = (30, 40) if case in ("coherent", "misaligned") else (32, 64)
    k, view_counts = _window_k_counts(c)
    value, dpt, locs, attn = windowed_inputs(4, h, w, k, heads, c, p, 12,
                                             case != "random")
    qc = (QC_BWD if backward else QC_FWD)[c]
    wwin = window_length(value, dpt, backward)
    if case == "cap":
        # every sample a quarter pixel past the centre of pixel (1, 1): its
        # box is pixels [1, 2] x [1, 2], its lowest pixel w + 1; one sample
        # of chunk 0 and one of chunk 1 whose boxes end at pixels w + wwin
        # and w + wwin + 1 stretch their unions to wwin and wwin + 1 pixels
        def at(y, x):
            return torch.tensor([(x + 0.75) / w, (y + 0.75) / h])
        locs[..., :2] = at(1, 1)
        for chunk in (0, 1):
            yhi, xhi = divmod(w + wwin + chunk, w)
            locs[:, chunk * qc, 0, 0, :2] = at(yhi - 1, xhi - 1)
    elif case == "one_pixel":
        q = torch.arange(k) // qc  # chunk of each query
        locs[..., 0] = (((3 * q) % w + 0.5) / w)[None, :, None, None]
        locs[..., 1] = ((q % h + 0.5) / h)[None, :, None, None]
    args = [value.to(vdtype), dpt.to(ddtype), locs, attn]
    args = [a.to(cuda_device) for a in args]
    if case == "misaligned":
        args[0], args[1] = _misaligned(args[0]), _misaligned(args[1])
    counts = torch.tensor(view_counts, dtype=torch.int32, device=cuda_device)
    if heads == p == 1:
        return args, counts
    plan = plan_windows(args[2], counts, h, w, wwin, qc)
    live = plan.span > 0
    share = float((plan.ok & live).sum() / live.sum())
    if case == "cap":
        assert wwin == WIN_CAP
        assert plan.span[1:, 0].eq(wwin).all() and plan.span[1:, 1].eq(wwin + 1).all()
    else:
        assert share < 0.1 if case == "random" else share > 0.9
    return args, counts


@pytest.mark.parametrize("heads,p,c,case", WINDOW_FWD)
@pytest.mark.parametrize("vdtype,ddtype", DFA3D_TYPES)
def test_windowed_kernel_matches_plain_and_template(cuda_device, heads, p, c, vdtype,
                                                    ddtype, case):
    args, counts = _windowed_case(cuda_device, heads, p, c, vdtype, ddtype, case)
    name = (_dfa3d_kernel_name("fwd", 1, 1, c, ddtype) if heads == p == 1
            else win_counter(False, c))
    before = KERNELS[name].launches
    got = dfa3d_attention_windowed(*args, heads, valid_counts=counts)
    assert KERNELS[name].launches == before + 1
    with plain_ops():
        expected = dfa3d_attention_windowed(*args, heads, valid_counts=counts)
    template = dfa3d_fwd_cuda(*args, heads, counts)
    torch.cuda.synchronize()
    assert got.dtype == vdtype
    for want, what in ((expected, "plain"), (template, "template")):
        assert_close_scaled(got.float().cpu().numpy(), want.float().cpu().numpy(),
                            _rel(vdtype), f"windowed fwd vs {what}")
    for cam, cnt in enumerate(counts.tolist()):
        assert (got[cam, cnt:] == 0).all()


@pytest.mark.parametrize("heads,p,c,case", WINDOW_BWD)
@pytest.mark.parametrize("vdtype,ddtype", DFA3D_TYPES)
@pytest.mark.parametrize("sample_grads,depth_grad", GRAD_FLAGS, ids=GRAD_IDS)
def test_windowed_backward_kernel_matches_plain_and_template(
        cuda_device, heads, p, c, case, vdtype, ddtype, sample_grads, depth_grad):
    args, counts = _windowed_case(cuda_device, heads, p, c, vdtype, ddtype, case,
                                  backward=True)
    name = win_counter(True, c)
    g = torch.randn((4, args[2].shape[1], heads * c), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(0)).to(vdtype)
    if case == "misaligned":
        g = _misaligned(g)
    wants = (True, depth_grad, sample_grads, sample_grads)
    before = KERNELS[name].launches
    for a, want in zip(args, wants):
        a.requires_grad_(want)
    out = dfa3d_attention_windowed(*args, heads, valid_counts=counts)
    assert graph_has(out, "_DFA3DWindowedBackward")
    got = _grads(out, args, g)
    assert KERNELS[name].launches == before + 1
    with plain_ops():
        expected = _grads(dfa3d_attention_windowed(*args, heads, valid_counts=counts),
                          args, g)
    template = dfa3d_bwd_cuda(*[a.detach() for a in args], g, heads, counts,
                              sample_grads=sample_grads, depth_grad=depth_grad)
    template = [t for t in template if t is not None]
    torch.cuda.synchronize()
    names = [n for n, want in zip(("d_value", "d_dpt", "d_locs", "d_attn"), wants) if want]
    for gname, a, b, t in zip(names, got, expected, template):
        for want, what in ((b, "plain"), (t, "template")):
            assert_close_scaled(a.float().cpu().numpy(), want.float().cpu().numpy(),
                                _rel(a.dtype), f"windowed {gname} vs {what}")
    if sample_grads:
        by_name = dict(zip(names, got))
        for cam, cnt in enumerate(counts.tolist()):
            assert (by_name["d_locs"][cam, cnt:] == 0).all()
            assert (by_name["d_attn"][cam, cnt:] == 0).all()


@pytest.mark.parametrize("vdtype,ddtype", DFA3D_TYPES)
def test_windowed_kernels_reserve_what_the_plan_says(cuda_device, vdtype, ddtype):
    """Each windowed kernel's shared memory a block is window_bytes at the
    window_length the wrappers launch it with, plus the block window's two
    static ints a warp, at the level-2 shape, at c = 32 and 16 a head; the
    CUDA runtime's own figures."""
    for c in (32, 16):
        value = torch.zeros((1, 59, 80, 8 * c), dtype=vdtype, device=cuda_device)
        depth = torch.zeros((1, 59, 80, 12), dtype=ddtype, device=cuda_device)
        for name, backward, depth_grad in (("dfa3d_win_fwd_mh", False, True),
                                           ("dfa3d_win_bwd_mh", True, True),
                                           ("dfa3d_win_bwd_mh", True, False)):
            wwin = window_length(value, depth, backward, depth_grad)
            res = kernel_resources(backward, vdtype, ddtype, 12, wwin, c, depth_grad)
            reserved = window_bytes(wwin, value, depth, backward, depth_grad)
            assert res["smem_bytes"] == reserved + 8 * res["threads"] // 32, (
                name, c, res, reserved)
            assert res["blocks_per_sm"] >= 1, (name, c, res)


def test_windowed_stage1_backward_is_k6(cuda_device):
    """The sorted path's stage 1 is the templates' K2 and K6, as on the TPU,
    whose windowed stage 1 has no backward; no windowed kernel launches."""
    args, counts = _windowed_case(cuda_device, 1, 1, 256, torch.bfloat16,
                                  torch.float32, "coherent")
    args[0].requires_grad_()
    args[1].requires_grad_()
    names = ("dfa3d_fwd_s1_c256", "dfa3d_bwd_s1_c256", "dfa3d_win_fwd_mh", "dfa3d_win_bwd_mh")
    before = {n: KERNELS[n].launches for n in names}
    out = dfa3d_attention_windowed(*args, 1, valid_counts=counts)
    torch.autograd.grad(out, args[:2], torch.ones_like(out))
    assert {n: KERNELS[n].launches - before[n] for n in names} == dict(zip(names, (1, 1, 0, 0)))


@pytest.mark.parametrize("heads,p,c", [(8, 4, 16), (1, 4, 128)], ids=["c16", "c128"])
def test_windowed_kernels_refuse_the_large_widths(cuda_device, heads, p, c):
    """The -L configs' widths: at stage 2's 16 a head the sorted op runs
    the windowed kernels' c = 16 instances, one launch each way, and
    matches its plain version (spilling locations, counted); at 128 a
    head, which no config runs multi-head, the wrappers and the sorted op
    raise before any launch."""
    value, dpt, locs, attn = (torch.from_numpy(a).to(cuda_device)
                              for a in dfa3d_inputs(heads, p, c, n=2, k=17))
    g = torch.randn((2, 17, heads * c), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(0))
    counts = torch.tensor([9, 17], dtype=torch.int32, device=cuda_device)
    before = {n: k.launches for n, k in KERNELS.items()}
    if c == 16:
        args = [value.requires_grad_(), dpt.requires_grad_(), locs.requires_grad_(),
                attn.requires_grad_()]
        got = dfa3d_attention_windowed(*args, heads, valid_counts=counts)
        got_grads = _grads(got, args, g)
        with plain_ops():
            want = dfa3d_attention_windowed(*args, heads, valid_counts=counts)
            want_grads = _grads(want, args, g)
        torch.cuda.synchronize()
        launched = {n: k.launches - before[n] for n, k in KERNELS.items()
                    if k.launches != before[n]}
        assert launched == {"dfa3d_win_fwd_mh_c16": 1, "dfa3d_win_bwd_mh_c16": 1}
        for name, a, b in zip(("out", "d_value", "d_dpt", "d_locs", "d_attn"),
                              [got] + list(got_grads), [want] + list(want_grads)):
            assert_close_scaled(a.detach().cpu().numpy(), b.detach().cpu().numpy(),
                                _rel(torch.float32), f"windowed c16 {name}")
        return
    with pytest.raises(ValueError, match=r"windowed forward takes c in \(16, 32, 256\)"):
        dfa3d_win_fwd_cuda(value, dpt, locs, attn, heads)
    with pytest.raises(ValueError, match=r"windowed backward takes c in \(16, 32\)"):
        dfa3d_win_bwd_cuda(value, dpt, locs, attn, g, heads)
    with pytest.raises(ValueError, match="windowed forward takes c in"):
        dfa3d_attention_windowed(value, dpt, locs, attn, heads)
    torch.cuda.synchronize()
    assert {n: k.launches for n, k in KERNELS.items()} == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sorted_lifting_kernels_match_plain(cuda_device, dtype):
    """ViewTransformer(sort_queries=True) at the ScanNet widths (embed 256,
    8 heads x 4 points) on a small rig, no budget (B = K): output and the
    gradients of sum(out * g) through the kernels vs the plain versions; one
    launch each of K2, the windowed forward, K6 and the windowed backward."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(6)
    n, k, h, w = 3, 300, 15, 20
    model = ViewTransformer(256, 8, 4, sort_queries=True)
    init_weights(model, torch.Generator().manual_seed(0))
    set_compute_dtype(model, dtype)
    model = model.to(cuda_device).eval()
    dev = dict(device=cuda_device)
    ref = torch.from_numpy(rng.uniform(-1, 1, (k, 3)).astype(np.float32)).to(**dev)
    proj = torch.from_numpy(np.tile(np.array(
        [[300, 0, 320, 0], [0, 300, 240, 0], [0, 0, 1, 2.5]], np.float32),
        (n, 1, 1))).to(**dev)
    feat = torch.from_numpy(rng.randn(n, 256, h, w).astype(np.float32)).to(**dev)
    feat = feat.to(dtype).requires_grad_()
    logits = torch.from_numpy(rng.randn(n, 12, h, w).astype(np.float32)).to(**dev)
    dpt = torch.softmax(logits, 1).requires_grad_()
    g = torch.from_numpy(rng.randn(k, 256).astype(np.float32)).to(**dev)
    args = (ref, torch.zeros(3, **dev), proj, feat, dpt, (480, 640), (0.2, 5.0, 0.4))

    def run():
        out = model(*args)
        grads = torch.autograd.grad((out.float() * g).sum(),
                                    [feat, dpt] + list(model.parameters()))
        return [out.detach()] + list(grads)

    names = ["dfa3d_fwd_s1_c256", "dfa3d_win_fwd_mh", "dfa3d_bwd_s1_c256", "dfa3d_win_bwd_mh",
             "dfa3d_fwd_mh_c32", "dfa3d_bwd_mh_c32"]
    before = [KERNELS[nm].launches for nm in names]
    got = run()
    assert [KERNELS[nm].launches - b for nm, b in zip(names, before)] == [1, 1, 1, 1, 0, 0]
    with plain_ops():
        expected = run()
    torch.cuda.synchronize()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    rel = 1e-3 if dtype == torch.float32 else 5e-2
    for i, (a, b) in enumerate(zip(got, expected)):
        assert torch.isfinite(a.float()).all()
        assert_close_scaled(a.float().cpu().numpy(), b.float().cpu().numpy(), rel,
                            f"sorted lifting tensor {i}")


PROBE_INDEX_TYPES = [pytest.param(torch.int32, id="int32"),
                     pytest.param(torch.int64, id="int64")]


@pytest.mark.parametrize("window", [None, 512], ids=["direct", "windowed"])
def test_gather_epilogue_kernel_matches_plain(cuda_device, window):
    gen = torch.Generator(cuda_device).manual_seed(1)
    img = torch.randn((400, 176), device=cuda_device, generator=gen)
    rows = torch.randint(0, 400, (4, 3000), device=cuda_device, generator=gen)
    winfo = torch.rand((4, 3000, 8), device=cuda_device, generator=gen)
    winfo[..., 6:8] = torch.floor(winfo[..., 6:8] * 12)
    got = probes.gather_epilogue(img, rows, winfo, window)
    want = probes.gather_epilogue_plain(img, rows, winfo, window)
    torch.cuda.synchronize()
    assert_close_scaled(got.cpu().numpy(), want.cpu().numpy(), 1e-5, "p4+epi")


# (points, row width): the probe's four points at w = 176 (c = 32, 12
# bins), one point (eight output rows a warp), three (24 of a warp's 32
# lanes), eight (one row a warp), and four at w = 180, whose c = 33 takes
# the kernel's one-channel lanes
EPILOGUE_SHAPES = [pytest.param(4, 176, id="p4"), pytest.param(1, 176, id="p1"),
                   pytest.param(3, 176, id="p3"), pytest.param(8, 176, id="p8"),
                   pytest.param(4, 180, id="p4_c33")]


@pytest.mark.parametrize("index_dtype", PROBE_INDEX_TYPES)
@pytest.mark.parametrize("kind,window", [("random", None), ("jittered", None),
                                         ("jittered", 256)],
                         ids=["random-direct", "jittered-direct", "jittered-w256"])
@pytest.mark.parametrize("p,width", EPILOGUE_SHAPES)
def test_gather_epilogue_kernel_edges(cuda_device, p, width, kind, window, index_dtype):
    """The epilogue kernel with M = 999 output rows (a ragged last chunk of
    231, whose second block of 103 rows leaves a warp 3 of its 4 rows),
    int32 and int64 indices, direct and windowed (jittered rows, whose
    chunks fit the window), depth bins past either end of the range; one
    launch, every element of the output written."""
    gen = torch.Generator(cuda_device).manual_seed(12)
    m, r = 999, 400
    img = torch.randn((r, width), device=cuda_device, generator=gen)
    rows = torch.stack([_probe_rows(kind, m, r, index_dtype, cuda_device, seed=pt)
                        for pt in range(p)]) if kind == "jittered" else \
        torch.randint(0, r, (p, m), device=cuda_device, generator=gen).to(index_dtype)
    if window:
        assert probes.plan_rows(rows, probes.CM, window)[2].all()
    winfo = torch.rand((p, m, 8), device=cuda_device, generator=gen)
    winfo[..., 6:8] = torch.floor(winfo[..., 6:8] * 14) - 1  # bins -1 .. 12 of 12
    before = probes.KERNELS["row_gather"].launches
    got = probes.gather_epilogue(img, rows, winfo, window)
    assert probes.KERNELS["row_gather"].launches == before + 1
    want = probes.gather_epilogue_plain(img, rows, winfo, window)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert_close_scaled(got.cpu().numpy(), want.cpu().numpy(), 1e-5, f"p{p}+epi w={width}")
    assert (got[:, probes.quad_widths(width)[0]:] == 0).all()


def test_gather_epilogue_kernel_refuses_more_points(cuda_device):
    img = torch.randn((50, 176), device=cuda_device)
    n = probes.EPI_MAX_POINTS + 1
    rows = torch.zeros((n, 10), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="at most"):
        probes.gather_epilogue(img, rows, torch.zeros((n, 10, 8), device=cuda_device))


def _probe_rows(kind, m, r, dtype, device, chunk=probes.CM, seed=0):
    """m indices into r rows: sorted, jittered monotone (probe_window_matmul.py's
    regime), or mixed (sorted chunks alternating with chunks of random rows,
    which exceed any window narrower than r)."""
    gen = torch.Generator(device).manual_seed(seed)
    if kind == "jittered":
        t = torch.arange(m, device=device) * (r - 1) // max(m - 1, 1)
        rows = (t + torch.randint(-40, 40, (m,), device=device, generator=gen)).clamp(0, r - 1)
    else:
        rows = torch.sort(torch.randint(0, r, (m,), device=device, generator=gen))[0]
        if kind == "mixed":
            wild = (torch.arange(m, device=device) // chunk) % 2 == 1
            rows = torch.where(wild, torch.randint(0, r, (m,), device=device, generator=gen),
                               rows)
    return rows.to(dtype)


# (index order, M, chunk, window): every chunk windowed; ragged last chunks
# (M not a multiple of the chunk); unsorted chunks exceeding the window
PROBE_CASES = [pytest.param("sorted", 20000, 256, None, id="sorted-direct"),
               pytest.param("sorted", 20000, 256, 64, id="sorted-w64"),
               pytest.param("jittered", 9999, 128, 128, id="jittered-ragged-w128"),
               pytest.param("mixed", 5000, 256, 200, id="mixed-ragged-w200"),
               pytest.param("mixed", 4096, 64, 100, id="mixed-w100-cm64"),
               pytest.param("mixed", 3000, 256, None, id="mixed-direct")]


def _some_chunks_exceed(rows, chunk, window):
    ok = probes.plan_rows(rows[None], chunk, window)[2]
    return bool(ok.any()) and not bool(ok.all())


@pytest.mark.parametrize("index_dtype", PROBE_INDEX_TYPES)
@pytest.mark.parametrize("kind,m,chunk,window", PROBE_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_gather_kernel_matches_plain(cuda_device, kind, m, chunk, window, index_dtype,
                                         dtype):
    gen = torch.Generator(cuda_device).manual_seed(4)
    img = torch.randn((700, 1072), device=cuda_device, generator=gen).to(dtype)
    rows = _probe_rows(kind, m, 700, index_dtype, cuda_device, chunk)
    if window:
        assert _some_chunks_exceed(rows, chunk, window) == (kind == "mixed")
    before = probes.KERNELS["row_gather"].launches
    got = probes.row_gather(img, rows, window, chunk)
    assert probes.KERNELS["row_gather"].launches == before + 1
    assert torch.equal(got, img[rows.long()])
    assert torch.equal(got, probes.row_gather_plain(img, rows, window, chunk))


@pytest.mark.parametrize("window,chunk", [(128, 128), (256, 256), (512, 512)])
def test_row_gather_kernel_window_matmul_windows(cuda_device, window, chunk):
    """probe_window_matmul.py's jittered rows into the (4944, 1072) bf16
    image, at each window it measures."""
    gen = torch.Generator(cuda_device).manual_seed(5)
    img = torch.randn((4944, 1072), device=cuda_device, generator=gen).bfloat16()
    rows = _probe_rows("jittered", 1 << 16, 4944, torch.int64, cuda_device)
    assert probes.plan_rows(rows[None], chunk, window)[2].all()
    assert torch.equal(probes.row_gather(img, rows, window, chunk), img[rows])


@pytest.mark.parametrize("index_dtype", PROBE_INDEX_TYPES)
@pytest.mark.parametrize("kind,m,chunk,window", PROBE_CASES)
def test_row_scatter_add_kernel_matches_plain(cuda_device, kind, m, chunk, window,
                                              index_dtype):
    gen = torch.Generator(cuda_device).manual_seed(6)
    u = torch.randn((m, 1072), device=cuda_device, generator=gen)
    rows = _probe_rows(kind, m, 700, index_dtype, cuda_device, chunk)
    if window:
        assert _some_chunks_exceed(rows, chunk, window) == (kind == "mixed")
    before = probes.KERNELS["row_scatter_add"].launches
    got = probes.row_scatter_add(u, rows, 705, window, chunk)
    assert probes.KERNELS["row_scatter_add"].launches == before + 1
    want = probes.row_scatter_add_plain(u, rows, 705, window, chunk)
    torch.cuda.synchronize()
    # f32 sums in another order (the direct chunks' atomics): 1e-5 of the scale
    assert_close_scaled(got.cpu().numpy(), want.cpu().numpy(), 1e-5, "row scatter-add")
    named = torch.zeros(705, dtype=torch.bool, device=cuda_device)
    named[rows.long()] = True
    assert not named.all() and (got[~named] == 0).all()  # no index names them: zeros


@pytest.mark.parametrize("window", [None, 256], ids=["direct", "windowed"])
def test_row_scatter_add_kernel_moves_a_permutation_bit_for_bit(cuda_device, window):
    gen = torch.Generator(cuda_device).manual_seed(7)
    scale = torch.exp2(torch.randint(-40, 40, (1000, 1), device=cuda_device,
                                     generator=gen).float())
    u = torch.randn((1000, 1072), device=cuda_device, generator=gen) * scale
    perm = torch.randperm(1000, device=cuda_device, generator=gen)
    got = probes.row_scatter_add(u, perm, 1000, window=window)
    assert torch.equal(got, torch.zeros_like(u).index_copy_(0, perm, u))


@pytest.mark.parametrize("case", ["f32_onehot", "sorted-2^16"])
def test_row_scatter_add_kernel_is_the_same_from_run_to_run(cuda_device, case):
    gen = torch.Generator(cuda_device).manual_seed(8)
    if case == "f32_onehot":
        m, n_rows = 2048, 256
        rows = torch.randint(0, n_rows, (m,), device=cuda_device, generator=gen)
    else:
        m, n_rows = 1 << 16, 4944
        rows = _probe_rows("sorted", m, n_rows, torch.int64, cuda_device)
    u = torch.randn((m, 1072), device=cuda_device, generator=gen)
    first = probes.row_scatter_add(u, rows, n_rows, window=256)
    for _ in range(3):
        assert torch.equal(probes.row_scatter_add(u, rows, n_rows, window=256), first)


def test_row_scatter_add_kernel_f32_onehot_shape(cuda_device):
    """probe_f32_onehot.py: u (2048, 1072) with row scales 2^-40..2^40 into
    one 256-row window; each element within f32 summation error (8 terms
    on average) of its f64 sum."""
    gen = torch.Generator(cuda_device).manual_seed(9)
    scale = torch.exp2(torch.randint(-40, 40, (2048, 1), device=cuda_device,
                                     generator=gen).float())
    u = torch.randn((2048, 1072), device=cuda_device, generator=gen) * scale
    rows = torch.randint(0, 256, (2048,), device=cuda_device, generator=gen)
    got = probes.row_scatter_add(u, rows, 256, window=256)
    want = torch.zeros((256, 1072), dtype=torch.float64, device=cuda_device)
    want.index_add_(0, rows, u.double())
    mag = torch.zeros_like(want).index_add_(0, rows, u.double().abs())
    assert ((got.double() - want).abs() <= 2.0 ** -20 * mag).all()


@pytest.mark.parametrize("index_dtype", PROBE_INDEX_TYPES)
def test_probe_wrappers_launch_only_their_kernels(cuda_device, index_dtype):
    """No torch op on the card's path: a windowed gather is one kernel, a
    scatter-add at most three (plan, sum where the output lives, direct
    chunks), for int32 and int64 indices alike."""
    gen = torch.Generator(cuda_device).manual_seed(10)
    img = torch.randn((4944, 1072), device=cuda_device, generator=gen).bfloat16()
    rows = _probe_rows("jittered", 1 << 15, 4944, index_dtype, cuda_device)
    work = probes.device_work(lambda: probes.row_gather(img, rows, 256))
    assert len(work) == 1 and probes.KERNEL_SYMBOLS["row_gather"] in work[0], work
    u = torch.randn((2048, 1072), device=cuda_device, generator=gen)
    for r, n_rows, window in ((torch.randint(0, 256, (2048,), device=cuda_device,
                                             generator=gen), 256, 256),
                              (rows, 4944, 256), (rows, 4944, None)):
        uu = u if r.numel() == 2048 else torch.randn((r.numel(), 64), device=cuda_device)
        r = r.to(index_dtype)
        work = probes.device_work(lambda: probes.row_scatter_add(uu, r, n_rows, window))
        assert 1 <= len(work) <= 3 and all(probes.KERNEL_SYMBOLS["row_scatter_add"] in name
                                          for name in work), work


def test_view_collectives_on_cuda_tensors(cuda_device):
    """The view sharding's all-gather (f32, bf16, bool), its reduce-scatter
    transpose and the all-reduce sum with its transpose on CUDA tensors:
    two gloo processes on cuda:0, as chip_smoke.py phase 19 runs them."""
    launch_view_collectives("cuda")


def _frozen_bn_case(device, shape, identity, dtype, seed=0):
    """Seeded channels-last x (a conv output with an offset), identity and
    incoming gradient, and f32 BN parameters (weight, bias, running mean and
    variance)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n, c, h, w = shape

    def act(scale=1.0, offset=0.0):
        t = torch.randn(n, c, h, w, generator=gen, device=device) * scale + offset
        return t.to(dtype).contiguous(memory_format=torch.channels_last)

    x, ident, g = act(2.0, 0.3), act() if identity else None, act()
    params = (torch.rand(c, generator=gen, device=device) + 0.5,
              torch.randn(c, generator=gen, device=device) * 0.2,
              torch.randn(c, generator=gen, device=device) * 0.5,
              torch.rand(c, generator=gen, device=device) * 2 + 0.25)
    return x, ident, params, g


# the serving shapes of the main path (stage 1's last bn3 and stage 4's at
# 100 views, with the identity), the stem's, a downsample's (no ReLU), and 24
# channels on a ragged row count (no block of 256 threads filled)
FROZEN_BN_SHAPES = [pytest.param((100, 256, 60, 80), True, True, id="stage1_bn3"),
                    pytest.param((100, 2048, 8, 10), True, True, id="stage4_bn3"),
                    pytest.param((100, 64, 120, 160), False, True, id="stem"),
                    pytest.param((100, 256, 60, 80), False, False, id="downsample"),
                    pytest.param((3, 24, 5, 7), True, True, id="ragged")]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape, identity, relu", FROZEN_BN_SHAPES)
def test_frozen_bn_kernels_match_plain(cuda_device, shape, identity, relu, dtype):
    """Forward within one ulp of the larger of |bn(x)|, |identity| and |y|
    (the plain version rounds bn(x) and the sum, the kernel the sum once);
    dx within one ulp of the plain backward on the kernel's y, d_identity
    equal to g', d_weight and d_bias within 1e-5 of the summed magnitudes of
    their terms (f32 sums in another order)."""
    x, ident, (w, b, mean, var), g = _frozen_bn_case(cuda_device, shape, identity, dtype)
    eps = 1e-5
    before = KERNELS["frozen_bn_fwd"].launches
    y = frozen_bn_fwd_cuda(x, ident, w, b, mean, var, eps, relu)
    assert KERNELS["frozen_bn_fwd"].launches == before + 1
    assert y.dtype == dtype and y.is_contiguous(memory_format=torch.channels_last)
    want = frozen_bn_plain(x, ident, w, b, mean, var, eps, relu).float()
    bn = F.batch_norm(x.float(), mean, var, w, b, False, 0.0, eps)
    mag = torch.maximum(bn.abs(), want.abs())
    if identity:
        mag = torch.maximum(mag, ident.float().abs())
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -20
    assert ((y.float() - want).abs() <= ulp * mag + 1e-6 * float(mag.max())).all()

    before = KERNELS["frozen_bn_bwd"].launches
    dx, d_id, d_w, d_b = frozen_bn_bwd_cuda(g, x, y, w, mean, var, eps, relu, identity)
    assert KERNELS["frozen_bn_bwd"].launches == before + 1
    assert dx.is_contiguous(memory_format=torch.channels_last)
    p_dx, p_id, p_w, p_b = frozen_bn_bwd_plain(g, x, y, w, mean, var, eps, relu, identity)
    assert ((dx.float() - p_dx.float()).abs()
            <= ulp * p_dx.float().abs() + 1e-6 * float(p_dx.float().abs().max())).all()
    assert d_id is None if not identity else torch.equal(d_id, p_id)
    gp = torch.where(y <= 0, 0.0, g.float()) if relu else g.float()
    assert ((d_b - p_b).abs() <= 1e-5 * gp.abs().sum((0, 2, 3))).all()
    terms = (gp * (x.float() - mean[:, None, None])).abs().sum((0, 2, 3))
    assert ((d_w - p_w).abs() <= 1e-5 * terms * torch.rsqrt(var + eps)).all()


def test_frozen_bn_kernels_are_bit_identical_from_run_to_run(cuda_device):
    x, ident, (w, b, mean, var), g = _frozen_bn_case(cuda_device, (100, 256, 60, 80), True,
                                                     torch.bfloat16, seed=1)
    runs = []
    for _ in range(2):
        y = frozen_bn_fwd_cuda(x, ident, w, b, mean, var, 1e-5, True)
        runs.append((y, *frozen_bn_bwd_cuda(g, x, y, w, mean, var, 1e-5, True, True)))
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)


def test_frozen_bn_op_gradients_are_the_kernels(cuda_device):
    """The autograd op routes a CUDA tensor to both kernels, and its
    gradients in x, identity, weight and bias are the backward kernel's."""
    x, ident, (w, b, mean, var), g = _frozen_bn_case(cuda_device, (4, 64, 6, 10), True,
                                                     torch.bfloat16, seed=2)
    leaves = [t.detach().requires_grad_() for t in (x, ident, w, b)]
    y = frozen_bn(leaves[0], leaves[1], leaves[2], leaves[3], mean, var, 1e-5, True)
    got = torch.autograd.grad(y, leaves, g)
    want = frozen_bn_bwd_cuda(g, x, y.detach(), w, mean, var, 1e-5, True, True)
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


def test_resnet50_runs_channels_last_through_53_frozen_bn_launches(cuda_device):
    """A ResNet-50 forward launches the forward kernel 53 times (the stem,
    three a bottleneck, four downsamples) and its backward the backward
    kernel 53 times; the stages leave channels-last, the FPN's levels
    contiguous, and the outputs agree with the plain versions'."""
    from sgcdet_tpu_torch.models.fpn import FPN
    from sgcdet_tpu_torch.models.resnet import ResNet50

    gen = torch.Generator().manual_seed(3)
    backbone, fpn = ResNet50(), FPN(out_channels=64)
    init_weights(backbone, gen)
    init_weights(fpn, gen)
    backbone, fpn = backbone.to(cuda_device), fpn.to(cuda_device)
    for m in (backbone, fpn):
        set_compute_dtype(m, torch.bfloat16)
    imgs = torch.randn(2, 3, 64, 96, generator=gen).to(cuda_device)
    fwd0, bwd0 = KERNELS["frozen_bn_fwd"].launches, KERNELS["frozen_bn_bwd"].launches
    stages = backbone(imgs)
    levels = fpn(stages)
    assert KERNELS["frozen_bn_fwd"].launches - fwd0 == 53
    assert all(s.is_contiguous(memory_format=torch.channels_last) and not s.is_contiguous()
               for s in stages)
    assert all(lv.is_contiguous() for lv in levels)
    sum(lv.float().sum() for lv in levels).backward()
    assert KERNELS["frozen_bn_bwd"].launches - bwd0 == 53
    with plain_ops(), torch.no_grad():
        plain = fpn(backbone(imgs))
    for got, want in zip(levels, plain):
        assert_close_scaled(got.detach().float().cpu().numpy(), want.float().cpu().numpy(),
                            0.05, "FPN level")


def test_frozen_bn_wrapper_refuses(cuda_device):
    x, ident, params, g = _frozen_bn_case(cuda_device, (2, 64, 6, 10), True, torch.bfloat16)
    with pytest.raises(ValueError, match="channels-last"):
        frozen_bn_fwd_cuda(x.contiguous(), None, *params, 1e-5, True)
    with pytest.raises(ValueError, match="channels-last"):
        frozen_bn_fwd_cuda(x, ident.contiguous(), *params, 1e-5, True)
    with pytest.raises(TypeError):
        frozen_bn_fwd_cuda(x.half(), None, *params, 1e-5, True)
    with pytest.raises(TypeError):
        frozen_bn_fwd_cuda(x.double(), None, *params, 1e-5, True)
    with pytest.raises(TypeError):
        frozen_bn_fwd_cuda(x, ident.float(), *params, 1e-5, True)
    with pytest.raises(ValueError, match="channels-last"):
        frozen_bn(x.contiguous(), None, *params, 1e-5, True)
    for c in (12, 2056):
        xc, _, pc, _ = _frozen_bn_case(cuda_device, (1, c, 2, 2), False, torch.bfloat16)
        with pytest.raises(ValueError, match="multiple of 8"):
            frozen_bn_fwd_cuda(xc, None, *pc, 1e-5, True)
