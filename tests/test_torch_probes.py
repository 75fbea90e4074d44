"""The row gather/scatter probes' plain versions (the spec of the kernels of
``csrc/rows.cu``) against JAX references on the CPU: ``jnp.take`` for the
gather and ``jax.ops.segment_sum`` for the scatter-add, as
experiments/probe_window_lowering.py:137 and probe_f32_onehot.py check
themselves, on unsorted indices, ragged last chunks, int32 and int64
indices, and windows that some chunks exceed (those take the direct path);
the window plan ``plan_rows``; and the checks the card path makes before
its launch.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgcdet_tpu_torch.experiments import probes

from torch_port_tiny import keep_global_torch_rng  # noqa: F401 (autouse)

R, L = 97, 40


def _rows(kind, m, dtype, seed=0):
    """Indices into R rows: sorted, jittered monotone (probe_window_matmul.py's
    regime) or unsorted."""
    rng = np.random.RandomState(seed)
    if kind == "sorted":
        r = np.sort(rng.randint(0, R, m))
    elif kind == "jittered":
        r = np.clip(np.arange(m) * (R - 1) // max(m - 1, 1) + rng.randint(-6, 6, m), 0, R - 1)
    else:
        r = rng.randint(0, R, m)
    return r.astype(dtype)


# (index order, M, chunk, window): windows that every chunk fits, that some
# chunks exceed, ragged last chunks (M not a multiple of the chunk)
CASES = [
    pytest.param("sorted", 1024, 128, None, id="sorted-direct"),
    pytest.param("sorted", 1000, 128, 16, id="sorted-ragged-w16"),
    pytest.param("jittered", 777, 64, 24, id="jittered-ragged-w24"),
    pytest.param("unsorted", 1000, 64, 40, id="unsorted-ragged-w40"),
    pytest.param("unsorted", 512, 32, None, id="unsorted-direct"),
]
INDEX_TYPES = [pytest.param(np.int32, id="int32"), pytest.param(np.int64, id="int64")]


@pytest.mark.parametrize("index_type", INDEX_TYPES)
@pytest.mark.parametrize("kind,m,chunk,window", CASES)
def test_row_gather_plain_matches_jnp_take(kind, m, chunk, window, index_type):
    rng = np.random.RandomState(1)
    img = jnp.asarray(rng.randn(R, L).astype(np.float32)).astype(jnp.bfloat16)
    rows = _rows(kind, m, index_type)
    want = np.asarray(jnp.take(img, jnp.asarray(rows), axis=0).astype(jnp.float32))
    t_img = torch.from_numpy(np.array(img.astype(jnp.float32))).bfloat16()
    for t in (t_img, t_img.float()):
        got = probes.row_gather(t, torch.from_numpy(rows), window, chunk)
        assert got.dtype == t.dtype and got.shape == (m, L)
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("index_type", INDEX_TYPES)
@pytest.mark.parametrize("kind,m,chunk,window", CASES)
def test_row_scatter_add_plain_matches_segment_sum(kind, m, chunk, window, index_type):
    rng = np.random.RandomState(2)
    u = rng.randn(m, L).astype(np.float32)
    rows = _rows(kind, m, index_type)
    n_rows = R + 3  # rows no index names come out as zeros
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(u), jnp.asarray(rows),
                                          num_segments=n_rows))
    got = probes.row_scatter_add(torch.from_numpy(u), torch.from_numpy(rows), n_rows, window,
                                 chunk).numpy()
    assert got.shape == (n_rows, L) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()  # probe_f32_onehot.py
    assert not got[R:].any()


def test_row_scatter_add_plain_moves_a_permutation_bit_for_bit():
    rng = np.random.RandomState(3)
    u = (rng.randn(64, L) * np.exp2(rng.randint(-40, 40, (64, 1)))).astype(np.float32)
    perm = rng.permutation(64).astype(np.int64)
    for window in (None, 64):
        got = probes.row_scatter_add(torch.from_numpy(u), torch.from_numpy(perm), 64, window)
        want = np.zeros_like(u)
        want[perm] = u
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind,m,chunk,window", CASES[1:4])
def test_plan_rows_chunks_and_their_spans(kind, m, chunk, window):
    rows = _rows(kind, m, np.int64)
    base, span, ok = probes.plan_rows(torch.from_numpy(rows)[None], chunk, window)
    nchunk = -(-m // chunk)
    assert base.shape == span.shape == ok.shape == (nchunk,)
    for c in range(nchunk):  # the ragged last chunk over its own indices only
        r = rows[c * chunk:(c + 1) * chunk]
        assert int(base[c]) == r.min() and int(span[c]) == r.max() - r.min() + 1
        assert bool(ok[c]) == (r.max() - r.min() + 1 <= window)
    if kind == "unsorted":  # some chunks exceed the window: the direct path
        assert not ok.all()
    else:
        assert ok.all()


def test_card_path_checks_before_its_launch():
    u = torch.zeros((8, L + 2))
    rows = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="multiple of 4"):
        probes._scatter_prepare(u, rows, 4, None, probes.CM)
    with pytest.raises(ValueError, match="chunks of at most"):
        probes._scatter_prepare(torch.zeros((8, L)), rows, 4, 64, probes.SCATTER_TILE + 1)
    with pytest.raises(TypeError):
        probes._scatter_prepare(torch.zeros((8, L)), rows.to(torch.int16), 4, None, probes.CM)
    with pytest.raises(TypeError):
        probes._gather_prepare(torch.zeros((R, L)), rows.to(torch.int16)[None], None, None,
                               probes.CM)
