"""The frozen work arithmetic gives chip_smoke.py's bytes and flops, and
the reference's work log counts a call on flat (camera, query) pairs as
chip_smoke.py's ``dfa3d_work`` counts the same call laid out per camera."""
from __future__ import annotations

import pytest
import torch

import chip_smoke
from benchmark import work


def _case(seed, n=3, h=7, w=9, k=11, heads=4, p=2, c=8, dsize=5):
    g = torch.Generator().manual_seed(seed)
    value = torch.randn(n, h, w, heads * c, generator=g).to(torch.bfloat16)
    depth = torch.rand(n, h, w, dsize, generator=g)
    locs = torch.rand(n, k, heads, p, 3, generator=g) * 1.2 - 0.1
    locs[0, 0, 0, 0, 0] = float("nan")
    attn = torch.rand(n, k, heads, p, generator=g)
    counts = torch.randint(1, k + 1, (n,), generator=g)
    return value, depth, locs, attn, counts


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("backward", [False, True])
def test_dfa3d_work_equals_chip_smoke(seed, backward):
    value, depth, locs, attn, counts = _case(seed)
    out = torch.zeros(locs.shape[:2] + (value.shape[-1],), dtype=value.dtype)
    args = (value, depth, locs, attn) + ((out,) if backward else ())
    outs = (value, depth, locs, attn) if backward else (out,)
    for dot in (True, False):
        assert work.dfa3d_work(args, outs, counts, backward, dot) == \
            chip_smoke.dfa3d_work(args, outs, counts, backward, dot)
    assert work.touched_rows(locs, counts, 7, 9, 5) == chip_smoke.touched_rows(locs, counts, 7, 9, 5)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("backward", [False, True])
def test_sweep_work_and_bound_equal_chip_smoke(seed, backward):
    g = torch.Generator().manual_seed(seed)
    src = torch.randn(2, 5, 6, 16, generator=g)
    x, y = torch.rand(2, 4, 30, generator=g), torch.rand(2, 4, 30, generator=g)
    corr = torch.zeros(2, 4, 30)
    args = (src, src, x, y) + ((corr,) if backward else ())
    outs = (src, src) if backward else (corr,)
    got = work.sweep_work(args, outs, backward)
    assert got == chip_smoke.sweep_work(args, outs, backward)
    assert work.bound(*got) == chip_smoke.bound(*got)


@pytest.mark.parametrize("heads,p", [(1, 1), (4, 2)])
def test_work_log_counts_flat_pairs_as_the_per_camera_layout(heads, p):
    value, depth, locs, attn, counts = _case(5, heads=heads, p=p, c=16 // heads)
    n, k = locs.shape[:2]
    keep = torch.arange(k)[None, :] < counts[:, None]
    cam, q = keep.nonzero(as_tuple=True)
    log = work.WorkLog(torch.bfloat16, backward=True)
    log.dfa3d(value, depth, cam, locs[cam, q], attn[cam, q])
    kmax = int(counts.max())
    lay, at = locs[:, :kmax], attn[:, :kmax]
    out = torch.zeros(n, kmax, value.shape[-1], dtype=value.dtype)
    fwd = chip_smoke.dfa3d_work((value, depth, lay, at), (out,), counts, False)
    grads = (value, depth) if heads == 1 and p == 1 else (value, depth, lay, at)
    bwd = chip_smoke.dfa3d_work((value, depth, lay, at, out), grads, counts, True)
    want = chip_smoke.bound(*fwd)[0] + chip_smoke.bound(*bwd)[0]
    assert log.ms["dfa3d"] == pytest.approx(want, rel=1e-12)
    assert log.flops["dfa3d"] == pytest.approx(fwd[1] + bwd[1], rel=1e-12)
