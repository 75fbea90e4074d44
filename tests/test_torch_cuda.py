"""The port's CUDA kernels against their plain PyTorch versions, on a card:
the forward kernels K1-K3 (and K2'/K3' at bf16 depth), and the backward
kernels K4-K6 (K6'/K5') through autograd (the ops' ``torch.autograd.
Function``s) against the plain versions' VJPs, the DFA3D ones counted and
uncounted, also with head groups that fill only part of a warp, and K1 on a
map and plane count that no tile or plane group divides; the 2D lifting path
(``ViewTransformer(use_depth=False)``) through the kernels against its plain
run; the backward kernels K4 and K5 on the contention cases of
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
chunks, chunks exceeding the window, the windows of probe_window_matmul.py),
a permutation moved bit for bit, the scatter equal from run to run and
within f32 summation error at probe_f32_onehot.py's shape, and the device
work of a probe call counted by torch.profiler.

Every test here is marked ``cuda`` and skips where torch sees no CUDA
device: the hand-written kernels have no CPU mode.  The module imports no
JAX, so it also runs on a GPU host without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from sgcdet_tpu_torch.experiments import probes
from sgcdet_tpu_torch.models.depth_net import _warp_grid
from sgcdet_tpu_torch.models.layers import init_weights, set_compute_dtype
from sgcdet_tpu_torch.models.view_transformer import ViewTransformer
from sgcdet_tpu_torch.ops import KERNELS, dfa3d_attend, plain_ops
from sgcdet_tpu_torch.ops.dfa3d import (dfa3d_attention_plain, dfa3d_bwd_cuda,
                                        dfa3d_bwd_plain, dfa3d_fwd_cuda)
from sgcdet_tpu_torch.ops.dfa3d_windowed import (QC_BWD, QC_FWD, WIN_CAP,
                                                 dfa3d_attention_windowed,
                                                 kernel_resources, plan_windows,
                                                 window_bytes, window_length)
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


def _dfa3d_kernel_name(direction, heads, p, ddtype):
    stage = "s1" if heads == p == 1 else "mh"
    return f"dfa3d_{direction}_{stage}" + ("_bd" if ddtype == torch.bfloat16 else "")


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
# 8 heads x 3 points, 24 samples for 32 lanes)
DFA3D_SHAPES = [pytest.param(1, 1, 256, id="stage1"), pytest.param(8, 4, 32, id="stage2"),
                pytest.param(1, 4, 32, id="stage2_h1"), pytest.param(2, 4, 32, id="stage2_h2"),
                pytest.param(6, 4, 32, id="stage2_h6"), pytest.param(8, 3, 32, id="stage2_p3")]


def _counts(counted, device):
    return (torch.tensor([0, 100, 299, 300], dtype=torch.int32, device=device)
            if counted else None)


@pytest.mark.parametrize("heads,p,c", DFA3D_SHAPES)
@pytest.mark.parametrize("vdtype,ddtype", DFA3D_TYPES)
@pytest.mark.parametrize("counted", [True, False], ids=["counted", "uncounted"])
def test_dfa3d_kernel_matches_plain(cuda_device, heads, p, c, vdtype, ddtype, counted):
    value, dpt, locs, attn = dfa3d_inputs(heads, p, c, n=4, h=14, w=20, d=12,
                                          k=300)
    counts = _counts(counted, cuda_device)
    args = [torch.from_numpy(a).to(cuda_device) for a in (value, dpt, locs, attn)]
    args[0], args[1] = args[0].to(vdtype), args[1].to(ddtype)
    name = _dfa3d_kernel_name("fwd", heads, p, ddtype)
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


def _contention_case(case, device, vdtype, ddtype):
    """A DFA3D contention case on the card at the kernels' widths (stage 1's
    at c = 256): (value, depth, locs, attn, g, counts)."""
    c = 256 if case.startswith("s1_") else 32
    value, dpt, locs, attn, g, counts = (
        None if a is None else torch.from_numpy(a).to(device)
        for a in dfa3d_contention_case(case, c=c))
    return value.to(vdtype), dpt.to(ddtype), locs, attn, g.to(vdtype), counts


@pytest.mark.parametrize("vdtype,ddtype", DFA3D_TYPES)
@pytest.mark.parametrize("case", DFA3D_CONTENTION + DFA3D_S1_CONTENTION)
def test_dfa3d_stage2_backward_kernel_contention(cuda_device, case, vdtype, ddtype):
    """K5 (K5' at bf16 depth): a query's eight heads on one warp, all on one
    pixel; counted views of count 0.  K6 (K6') on stage 1's cases at c =
    256: one pixel for many queries, and lists of 4096 entries (the long
    pass)."""
    value, dpt, locs, attn, g, counts = _contention_case(case, cuda_device, vdtype,
                                                         ddtype)
    heads = locs.shape[2]
    name = _dfa3d_kernel_name("bwd", heads, locs.shape[3], ddtype)
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
    name = _dfa3d_kernel_name("bwd", heads, p, ddtype)
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

    suffix = "_bd" if dtype == torch.bfloat16 else ""
    names = [f"dfa3d_{d}_{s}{suffix}" for d in ("fwd", "bwd") for s in ("s1", "mh")]
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
    before = KERNELS[_dfa3d_kernel_name("bwd", 1, 1, ddtype)].launches
    got = dfa3d_bwd_cuda(value, dpt, locs, attn, g, 1, counts, **kw)
    assert KERNELS[_dfa3d_kernel_name("bwd", 1, 1, ddtype)].launches == before + 1
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


WINDOW_FWD = ([pytest.param(*shape, case, id=f"{sid}-{case}") for shape, sid in
               zip([(1, 1, 256)] + WINDOW_SHAPES + [(2, 4, 256)],
                   ["stage1", "stage2", "stage2_h1", "stage2_h2", "stage2_h6",
                    "stage2_p3", "c256_h2"])
               for case in (WINDOW_CASES if shape == (8, 4, 32) else WINDOW_CASES[:2])])
WINDOW_BWD = ([pytest.param(*shape[:2], case, id=case if shape == (8, 4, 32) else
                            f"h{shape[0]}p{shape[1]}-{case}")
               for shape in WINDOW_SHAPES
               for case in (WINDOW_CASES if shape == (8, 4, 32) else WINDOW_CASES[:2])])


def _windowed_case(cuda_device, heads, p, c, vdtype, ddtype, case, backward=False):
    """Operands and counts at the chunks of the forward or the backward.  A
    (4, 30, 40) map ((4, 32, 64) for "cap" and "one_pixel", whose pixel
    centres are exact in f32, and for "random", whose chunks then span
    more than the kernels' window), 600 queries, 12 depth bins; counts 0,
    200, 599 and 600.  Stage 1 has no windowed kernel and no plan."""
    h, w = (30, 40) if case in ("coherent", "misaligned") else (32, 64)
    value, dpt, locs, attn = windowed_inputs(4, h, w, 600, heads, c, p, 12,
                                             case != "random")
    qc = QC_BWD if backward else QC_FWD
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
        q = torch.arange(600) // qc  # chunk of each query
        locs[..., 0] = (((3 * q) % w + 0.5) / w)[None, :, None, None]
        locs[..., 1] = ((q % h + 0.5) / h)[None, :, None, None]
    args = [value.to(vdtype), dpt.to(ddtype), locs, attn]
    args = [a.to(cuda_device) for a in args]
    if case == "misaligned":
        args[0], args[1] = _misaligned(args[0]), _misaligned(args[1])
    counts = torch.tensor([0, 200, 599, 600], dtype=torch.int32, device=cuda_device)
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
    name = (_dfa3d_kernel_name("fwd", 1, 1, ddtype) if heads == p == 1
            else "dfa3d_win_fwd_mh")
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


@pytest.mark.parametrize("heads,p,case", WINDOW_BWD)
@pytest.mark.parametrize("vdtype,ddtype", DFA3D_TYPES)
@pytest.mark.parametrize("sample_grads,depth_grad", GRAD_FLAGS, ids=GRAD_IDS)
def test_windowed_backward_kernel_matches_plain_and_template(
        cuda_device, heads, p, case, vdtype, ddtype, sample_grads, depth_grad):
    c = 32
    args, counts = _windowed_case(cuda_device, heads, p, c, vdtype, ddtype, case,
                                  backward=True)
    g = torch.randn((4, 600, heads * c), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(0)).to(vdtype)
    if case == "misaligned":
        g = _misaligned(g)
    wants = (True, depth_grad, sample_grads, sample_grads)
    before = KERNELS["dfa3d_win_bwd_mh"].launches
    for a, want in zip(args, wants):
        a.requires_grad_(want)
    out = dfa3d_attention_windowed(*args, heads, valid_counts=counts)
    assert graph_has(out, "_DFA3DWindowedBackward")
    got = _grads(out, args, g)
    assert KERNELS["dfa3d_win_bwd_mh"].launches == before + 1
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
    static ints a warp, at the level-2 shape; the CUDA runtime's own
    figures."""
    value = torch.zeros((1, 59, 80, 256), dtype=vdtype, device=cuda_device)
    depth = torch.zeros((1, 59, 80, 12), dtype=ddtype, device=cuda_device)
    for name, backward, depth_grad in (("dfa3d_win_fwd_mh", False, True),
                                       ("dfa3d_win_bwd_mh", True, True),
                                       ("dfa3d_win_bwd_mh", True, False)):
        wwin = window_length(value, depth, backward, depth_grad)
        res = kernel_resources(name, vdtype, ddtype, 12, wwin, 32, depth_grad)
        reserved = window_bytes(wwin, value, depth, backward, depth_grad)
        assert res["smem_bytes"] == reserved + 8 * res["threads"] // 32, (name, res, reserved)
        assert res["blocks_per_sm"] >= 1, (name, res)


def test_windowed_stage1_backward_is_k6(cuda_device):
    """The sorted path's stage 1 is the templates' K2 and K6, as on the TPU,
    whose windowed stage 1 has no backward; no windowed kernel launches."""
    args, counts = _windowed_case(cuda_device, 1, 1, 256, torch.bfloat16,
                                  torch.float32, "coherent")
    args[0].requires_grad_()
    args[1].requires_grad_()
    names = ("dfa3d_fwd_s1", "dfa3d_bwd_s1", "dfa3d_win_fwd_mh", "dfa3d_win_bwd_mh")
    before = {n: KERNELS[n].launches for n in names}
    out = dfa3d_attention_windowed(*args, 1, valid_counts=counts)
    torch.autograd.grad(out, args[:2], torch.ones_like(out))
    assert {n: KERNELS[n].launches - before[n] for n in names} == dict(zip(names, (1, 1, 0, 0)))


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

    names = ["dfa3d_fwd_s1", "dfa3d_win_fwd_mh", "dfa3d_bwd_s1", "dfa3d_win_bwd_mh",
             "dfa3d_fwd_mh", "dfa3d_bwd_mh"]
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


PROBE_INDEX_TYPES = [pytest.param(torch.int32, id="int32"),
                     pytest.param(torch.int64, id="int64")]
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
