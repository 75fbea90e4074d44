"""Row gather and row scatter-add probes: this card's floors for the DFA3D
and sweep kernels' gathers and scatters.

The Hopper counterparts of the TPU probes experiments/probe_window_lowering.py,
probe_window_matmul.py, probe_gather_batch.py and probe_f32_onehot.py, which
measured how fast a v5e moves single rows and whether a one-hot MXU window
stands in for a gather.  Here the two kernels of csrc/rows.cu do that work,
each direct or through a shared-memory window:

* ``row_gather(img, rows, window=None)`` — ``img[rows]``;
* ``gather_epilogue(img, rows, winfo, window=None)`` — the ``p4+epi`` probe:
  the quad rows of P points gathered and reduced by the DFA3D corner
  epilogue (probe_gather_batch.py:104-126);
* ``row_scatter_add(u, rows, n_rows, window=None)`` — ``out[rows] += u``.

Each has a ``*_plain`` version; a wrapper launches its kernel for a CUDA
tensor and runs the plain version for a CPU one.  ``window`` is the most
rows a chunk of ``chunk`` consecutive indices may span to be served from
shared memory (a gather) or summed where the output lives (a scatter-add);
a wider chunk takes the direct path.  The plan (``plan_rows``) is the
plain version's: the kernels compute it themselves, reading the indices at
the type they come in (int32 or int64), so a call on the card runs the
probe's kernels and no torch op.  The plain version reads the planned
chunks' rows through their window only, so a planning fault shows as a
wrong number.

    python -m sgcdet_tpu_torch.experiments.probes [--attribute]

prints this card's rows/s and GB/s at the TPU probes' shapes, beside
``torch.index_select`` and ``Tensor.index_add_`` on the same data (needs a
CUDA card; it refuses to run without one); with ``--attribute``, where
the device time of the windowed probes' calls goes (``attribute_probes``).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..ops._cuda import DTYPE_CODE, Kernel, check_cuda_input, cuda_ms, use_kernel

CM = 256            # indices per chunk
SMEM = 200 * 1024   # most shared memory a window may take
TILE_BYTES = 256    # the kernels' column tile (csrc/rows.cu)

INDEX_TYPES = (torch.int32, torch.int64)  # read as they come, with no cast
SCATTER_TILE = 2048  # most indices a windowed scatter chunk may hold (csrc/rows.cu)

_P, _I = ctypes.c_void_p, ctypes.c_int
# sgc_row_gather(dtype, img, rows, idx64, winfo, out, l, m, p, cm, wwin, c,
#                dsize, stream)
ROW_GATHER = Kernel("sgc_row_gather", [_I, _P, _P, _I, _P, _P] + [_I] * 7)
# sgc_row_scatter_add(u, rows, idx64, meta, out, l, m, n_rows, cm, wwin, stream)
ROW_SCATTER_ADD = Kernel("sgc_row_scatter_add", [_P, _P, _I, _P, _P] + [_I] * 5)
KERNELS = {"row_gather": ROW_GATHER, "row_scatter_add": ROW_SCATTER_ADD}
# a part of the name of every device kernel behind each counter
KERNEL_SYMBOLS = {"row_gather": "row_gather", "row_scatter_add": "scatter_"}


def plan_rows(rows, chunk, wwin):
    """Per chunk of ``chunk`` consecutive indices (columns of ``rows``, (P,
    M), all P rows of them together): the lowest row named ``base``, the
    ``span`` to the highest, and ``ok`` where ``span <= wwin``."""
    p, m = rows.shape
    nchunk = -(-m // chunk)
    r = rows.long()
    pad = (0, nchunk * chunk - m)
    lo = F.pad(r, pad, value=1 << 40).view(p, nchunk, chunk).amin((0, 2))
    hi = F.pad(r, pad, value=-1).view(p, nchunk, chunk).amax((0, 2))
    span = hi - lo + 1
    return lo, span, span <= wwin


def _windowed(rows, chunk, wwin):
    """(index, keep) of ``rows`` (P, M) as the windowed kernels read them:
    an ``ok`` chunk's rows through its window (the row relative to the base,
    clipped into the window; ``keep`` false outside it), the others as they
    are."""
    base, span, ok = plan_rows(rows, chunk, wwin)
    c = torch.arange(rows.shape[1], device=rows.device) // chunk
    b, s, o = base[c], span[c], ok[c]
    rel = rows.long() - b
    inside = (rel >= 0) & (rel < s)
    idx = torch.where(o, b + torch.minimum(rel.clamp(min=0), s - 1), rows.long())
    return idx, ~(o & ~inside)


def _window_rows(row_bytes, window, whole_rows):
    """The window a kernel stages: at most ``window`` rows of its column
    tile (or whole rows for the epilogue) in ``SMEM`` bytes."""
    return min(window, SMEM // (row_bytes if whole_rows else TILE_BYTES))


def quad_widths(width):
    """(c, D) of the probe's quad row [vA|vB|vC|vD|dA|dB|dC|dD] of ``width``
    lanes (probe_gather_batch.py:105-106)."""
    c = (width - 48) // 4 if width >= 52 else width // 4
    return c, (width - 4 * c) // 4


def row_gather_plain(img, rows, window=None, chunk=CM):
    """img (R, L), rows (M,) in [0, R) -> img[rows] (M, L)."""
    if window is None:
        return img[rows.long()]
    wwin = _window_rows(img.shape[1] * img.element_size(), window, False)
    idx, keep = _windowed(rows[None], chunk, wwin)
    return torch.where(keep[0, :, None], img[idx[0]], 0)


def gather_epilogue_plain(img, rows, winfo, window=None, chunk=CM):
    """img (R, L) f32 quad rows, rows (P, M), winfo (P, M, 8) [w4(4), wd0,
    wd1, d0c, d1c] -> (M, L) f32: the first c lanes hold
    sum_pt sum_j winfo[j] * <row depth_j, dvec> * row value_j, the rest 0."""
    p, m = rows.shape
    l = img.shape[1]
    c, d = quad_widths(l)
    if window is None:
        idx, keep = rows.long(), torch.ones_like(rows, dtype=torch.bool)
    else:
        idx, keep = _windowed(rows, chunk, _window_rows(l * 4, window, True))
    s = torch.where(keep[..., None], img.float()[idx], 0.0)  # (P, M, L)
    wf = winfo.float()
    iota = torch.arange(d, device=img.device, dtype=torch.float32)
    dvec = (torch.where(iota == wf[..., 6:7], wf[..., 4:5], 0.0)
            + torch.where(iota == wf[..., 7:8], wf[..., 5:6], 0.0))
    acc = 0.0
    for j in range(4):
        dsj = (s[..., 4 * c + j * d:4 * c + (j + 1) * d] * dvec).sum(-1, keepdim=True)
        acc = acc + (wf[..., j:j + 1] * dsj) * s[..., j * c:(j + 1) * c]
    out = torch.zeros((m, l), dtype=torch.float32, device=img.device)
    out[:, :c] = acc.sum(0)
    return out


def row_scatter_add_plain(u, rows, n_rows, window=None, chunk=CM):
    """u (M, L) f32, rows (M,) in [0, n_rows) -> (n_rows, L) f32 with
    out[rows[i]] += u[i]."""
    idx, keep = rows.long(), None
    if window is not None:
        idx, keep = _windowed(rows[None], chunk, _window_rows(u.shape[1] * 4, window, False))
        idx, keep = idx[0], keep[0]
    u = u.float() if keep is None else torch.where(keep[:, None], u.float(), 0.0)
    out = torch.zeros((n_rows, u.shape[1]), dtype=torch.float32, device=u.device)
    return out.index_put_((idx,), u, accumulate=True)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _gather_prepare(img, rows, winfo, window, chunk):
    """The wrapper's work before its launch: operands checked, output
    allocated (no device work); returns (launch, out)."""
    dev = img.device
    im = check_cuda_input(img, "img", (torch.float32, torch.bfloat16), 2, dev)
    l = im.shape[1]
    if l * im.element_size() % 16:
        raise ValueError(f"row_gather takes rows of a multiple of 16 bytes, got {l} x "
                         f"{im.element_size()}")
    rw = check_cuda_input(rows, "rows", INDEX_TYPES, 2, dev)
    p, m = rw.shape
    wi = None
    if winfo is not None:
        if im.dtype != torch.float32:
            raise TypeError("the gather epilogue takes an f32 image")
        wi = check_cuda_input(winfo.float(), "winfo", (torch.float32,), 3, dev)
        if wi.shape != (p, m, 8):
            raise ValueError(f"winfo {tuple(wi.shape)} must be {(p, m, 8)}")
    wwin = 0 if window is None else _window_rows(l * im.element_size(), window,
                                                 winfo is not None)
    out = torch.empty((m, l), dtype=im.dtype, device=dev)

    def launch():
        ROW_GATHER(dev, DTYPE_CODE[im.dtype], im.data_ptr(), rw.data_ptr(),
                   int(rw.dtype == torch.int64), _ptr(wi), out.data_ptr(), l, m, p, chunk,
                   wwin, *quad_widths(l))
    return launch, out


def _gather_cuda(img, rows, winfo, window, chunk):
    launch, out = _gather_prepare(img, rows, winfo, window, chunk)
    launch()
    return out


def row_gather(img, rows, window=None, chunk=CM):
    """``img[rows]`` through kernel ``row_gather`` (direct, or windowed with
    ``window``) for a CUDA ``img``; the plain version for a CPU one."""
    if not use_kernel(img):
        return row_gather_plain(img, rows, window, chunk)
    return _gather_cuda(img, rows[None], None, window, chunk)


def gather_epilogue(img, rows, winfo, window=None, chunk=CM):
    """The ``p4+epi`` probe through kernel ``row_gather`` with its epilogue
    for a CUDA ``img``; the plain version for a CPU one."""
    if not use_kernel(img):
        return gather_epilogue_plain(img, rows, winfo, window, chunk)
    return _gather_cuda(img, rows, winfo, window, chunk)


def row_scatter_add(u, rows, n_rows, window=None, chunk=CM):
    """``out[rows] += u`` into zeros (n_rows, L) f32 through kernel
    ``row_scatter_add`` (global atomics, or a shared window with
    ``window``) for a CUDA ``u``; the plain version for a CPU one."""
    if not use_kernel(u):
        return row_scatter_add_plain(u, rows, n_rows, window, chunk)
    launch, out = _scatter_prepare(u, rows, n_rows, window, chunk)
    launch()
    return out


def _scatter_prepare(u, rows, n_rows, window, chunk):
    """As ``_gather_prepare``, for ``row_scatter_add`` (the plan's scratch
    is allocated here and filled by the kernel)."""
    dev = u.device
    uu = check_cuda_input(u.float(), "u", (torch.float32,), 2, dev)
    rw = check_cuda_input(rows, "rows", INDEX_TYPES, 1, dev)
    m, l = uu.shape
    if rw.shape[0] != m:
        raise ValueError(f"rows {tuple(rw.shape)} must be ({m},)")
    if l % 4:
        raise ValueError(f"row_scatter_add takes rows of a multiple of 4 f32, got {l}")
    wwin, meta = 0, None
    if window is not None:
        if chunk > SCATTER_TILE:
            raise ValueError(f"a windowed row_scatter_add takes chunks of at most "
                             f"{SCATTER_TILE} indices, got {chunk}")
        wwin = _window_rows(l * 4, window, False)
        meta = torch.empty((-(-m // chunk), 2), dtype=torch.int32, device=dev)
    out = torch.empty((n_rows, l), dtype=torch.float32, device=dev)

    def launch():
        ROW_SCATTER_ADD(dev, uu.data_ptr(), rw.data_ptr(), int(rw.dtype == torch.int64),
                        _ptr(meta), out.data_ptr(), l, m, n_rows, chunk, wwin)
    return launch, out


# ---------------------------------------------------------------------------
# the probes at the TPU probes' shapes
# ---------------------------------------------------------------------------

RQ = 4944          # rows of the level-2 quad image (probe_window_lowering.py:127)
LANES = 1072       # its lanes: 4 (256 + 12)
M_LOWERING = 1 << 20
QB, STEPS = 16384, 8  # probe_gather_batch.py:27-28


class ProbeCase(NamedTuple):
    """One probe: its kernel's run, its plain version's, the library call's
    (or None), and the work the call must do: bytes (each input read once,
    each distinct source row once, each output written once), f32
    operations, and rows moved."""
    name: str
    kernel: str
    run: Callable
    run_plain: Callable
    run_library: Optional[Callable]
    bytes: float
    flops: float
    rows: int
    prepare: Optional[Callable] = None


def nbytes_of(t):
    return t.numel() * t.element_size()


def probe_cases(dev, seed=0):
    """The probes at the TPU probes' shapes, as ``ProbeCase``s."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cases = []

    def add_gather(name, img, rows, window, chunk=CM, attribute=False):
        distinct = torch.unique(rows).numel()
        nbytes = (distinct * img.shape[1] * img.element_size() + nbytes_of(rows)
                  + rows.numel() * img.shape[1] * img.element_size())
        cases.append(ProbeCase(name, "row_gather",
                               lambda: row_gather(img, rows, window, chunk),
                               lambda: row_gather_plain(img, rows, window, chunk),
                               lambda: torch.index_select(img, 0, rows),
                               nbytes, 0.0, rows.numel(),
                               (lambda: _gather_prepare(img, rows[None], None, window, chunk)[0])
                               if attribute else None))

    def add_scatter(name, u, rows, n_rows, window, attribute=False):
        cases.append(ProbeCase(
            name, "row_scatter_add",
            lambda: row_scatter_add(u, rows, n_rows, window),
            lambda: row_scatter_add_plain(u, rows, n_rows, window),
            lambda: torch.zeros((n_rows, u.shape[1]), device=dev).index_add_(0, rows, u),
            u.numel() * 4 + nbytes_of(rows) + n_rows * u.shape[1] * 4, float(u.numel()),
            rows.numel(),
            (lambda: _scatter_prepare(u, rows, n_rows, window, CM)[0]) if attribute else None))

    # probe_window_lowering.py: 2^20 sorted rows of the (4944, 1072) image
    rows = torch.sort(torch.randint(0, RQ, (M_LOWERING,), device=dev, generator=gen))[0]
    imgf = torch.randn((RQ, LANES), device=dev, generator=gen)
    imgb = imgf.to(torch.bfloat16)
    for window in (None, 256):
        tag = "windowed 256" if window else "direct"
        add_gather(f"lowering bf16 row copies (4944, 1072), {tag}", imgb, rows, window,
                   attribute=True)
        add_gather(f"lowering f32 row copies (4944, 536), {tag}", imgf[:, :LANES // 2].contiguous(),
                   rows, window)
        add_gather(f"lowering f32 row copies (4944, 1072), {tag}", imgf, rows, window)
    u = torch.randn((M_LOWERING, LANES), device=dev, generator=gen)
    # a window of 8 rows (2 KB of shared memory) holds these chunks too
    # (about 1.2 rows each) and keeps the SM's occupancy of the direct path
    for window in (None, 256, 8):
        add_scatter(f"lowering scatter-add u (2^20, 1072) -> 4944 rows, "
                    f"{f'windowed {window}' if window else 'direct'}", u, rows, RQ, window,
                    attribute=window == 256)
    # probe_window_matmul.py: jittered monotone rows, windowed gathers
    t = torch.arange(M_LOWERING, device=dev, dtype=torch.float32) / (M_LOWERING - 1)
    jit = torch.randint(-40, 40, (M_LOWERING,), device=dev, generator=gen)
    rows_j = ((t * (RQ - 1)).long() + jit).clamp(0, RQ - 1)
    for window, chunk in ((256, 256), (128, 128), (512, 512)):
        add_gather(f"window_matmul bf16 (4944, 1072), w{window} cm{chunk}", imgb, rows_j,
                   window, chunk, attribute=True)
    # probe_gather_batch.py: random rows of narrow f32 images
    for width in (88, 128, 176, 256):
        img = torch.randn((RQ, width), device=dev, generator=gen)
        r = torch.randint(0, RQ, (STEPS * QB,), device=dev, generator=gen)
        add_gather(f"gather_batch single/g8 f32 w={width}", img, r, None)
    img = torch.randn((RQ, 176), device=dev, generator=gen)
    r4 = torch.randint(0, RQ, (4, STEPS * QB), device=dev, generator=gen)
    add_gather("gather_batch p4 f32 w=176", img, r4.reshape(-1), None)
    winfo = torch.rand((4, STEPS * QB, 8), device=dev, generator=gen)
    winfo[..., 6:8] = torch.floor(winfo[..., 6:8] * 12)
    c, d = quad_widths(176)
    # per (point, output row): 4 corners x (a D-bin dot, two lerp FMAs, a
    # weight product, c FMAs)
    cases.append(ProbeCase(
        "gather_batch p4+epi f32 w=176", "row_gather",
        lambda: gather_epilogue(img, r4, winfo),
        lambda: gather_epilogue_plain(img, r4, winfo), None,
        torch.unique(r4).numel() * 176 * 4 + nbytes_of(r4) + winfo.numel() * 4
        + STEPS * QB * 176 * 4, float(r4.numel() * 4 * (2 * d + 6 + 2 * c)), r4.numel()))
    # probe_f32_onehot.py: adversarial f32 rows scattered into one window
    scale = torch.exp2(torch.randint(-40, 40, (2048, 1), device=dev, generator=gen).float())
    u1 = torch.randn((2048, LANES), device=dev, generator=gen) * scale
    r1 = torch.randint(0, 256, (2048,), device=dev, generator=gen)
    add_scatter("f32_onehot scatter-add (2048, 1072) -> 256 rows, windowed 256", u1, r1,
                256, 256, attribute=True)
    return cases


def run_probes(dev, iters=10):
    """Time every probe's kernel and library call; returns one record per
    probe (the entry point's work: no plain versions, no checks)."""
    records = []
    for case in probe_cases(dev):
        ms = cuda_ms(case.run, iters)
        lib_ms = None if case.run_library is None else cuda_ms(case.run_library, iters)
        records.append(dict(name=case.name, kernel=case.kernel, ms=ms, library_ms=lib_ms,
                            rows_per_s=case.rows / ms * 1e3,
                            gb_per_s=case.bytes / ms / 1e6, bytes=case.bytes,
                            flops=case.flops))
    return records


def attribute_probes(dev, cases=None, iters=10):
    """Where a probe call's device time goes, for the cases with a
    ``prepare``: the whole wrapper call, its launch alone (what the
    wrapper does before it made in advance) and that work alone, each the
    warm mean of ``iters`` calls (CUDA events)."""
    records = []
    for case in cases if cases is not None else probe_cases(dev):
        if case.prepare is None:
            continue
        launch = case.prepare()
        records.append(dict(name=case.name, kernel=case.kernel,
                            whole_ms=cuda_ms(case.run, iters),
                            kernel_ms=cuda_ms(launch, iters),
                            torch_ms=cuda_ms(case.prepare, iters),
                            library_ms=cuda_ms(case.run_library, iters)))
    return records


def device_work(fn):
    """Names of the device kernels, copies and fills one call of fn runs,
    warm (torch.profiler; a CUDA card)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probes: no CUDA device (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    if "--attribute" in sys.argv[1:]:
        for r in attribute_probes(dev):
            print(f"{r['name']:66s} whole {r['whole_ms']:.4f} ms, kernel {r['kernel_ms']:.4f} ms, "
                  f"torch ops {r['torch_ms']:.4f} ms, library {r['library_ms']:.4f} ms", flush=True)
        return
    for r in run_probes(dev):
        lib = ("" if r["library_ms"] is None else
               f"; library {r['library_ms']:.4f} ms ({r['bytes'] / r['library_ms'] / 1e6:.1f} GB/s)")
        print(f"{r['name']:66s} {r['ms']:8.4f} ms  {r['rows_per_s'] / 1e6:9.1f} M rows/s  "
              f"{r['gb_per_s']:7.1f} GB/s{lib}", flush=True)


if __name__ == "__main__":
    main()
