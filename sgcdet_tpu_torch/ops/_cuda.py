"""Build, load, launch and time the hand-written Hopper kernels of ``csrc/``.

The CUDA sources are compiled at first use by ``nvcc`` for ``sm_90a``, one
process per source started together, and linked into one shared library
with a plain C interface, loaded with ``ctypes``.  The
library lands in ``build/kernels-<hash>/`` at the repository root, keyed by
a hash of the sources, so an edited kernel is rebuilt and an unchanged one
is reused.  Nothing here runs at import time: the CPU tests import every
module of the package on machines without ``nvcc`` or a card.

Dispatch rule shared by every wrapper (``use_kernel``): a CUDA tensor goes
to the kernel (or the call raises), a CPU tensor to the plain PyTorch
version.  Reference runs select the plain versions explicitly with
``plain_ops()``.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

# dtype codes of csrc/common.cuh
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_PLAIN = contextvars.ContextVar("plain_ops", default=False)


@contextlib.contextmanager
def plain_ops():
    """Route every wrapped op to its plain PyTorch version, on any device
    (reference runs in tests and in chip_smoke.py)."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def use_kernel(t: torch.Tensor) -> bool:
    """True where the wrapper must launch its kernel: a CUDA tensor outside
    ``plain_ops()``."""
    return t.is_cuda and not _PLAIN.get()


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


class _Library:
    """The compiled kernel library; built once per process on first use."""

    def __init__(self):
        self.handle = None
        self.build_seconds = None  # None: reused an existing build
        self.log = ""

    def get(self):
        if self.handle is None:
            self.handle = ctypes.CDLL(str(self._build()))
        return self.handle

    def _build(self) -> Path:
        digest = hashlib.sha256()
        for src in _sources():
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
        digest.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
        out_dir = BUILD_ROOT / f"kernels-{digest.hexdigest()[:16]}"
        lib = out_dir / "libsgcdet_kernels.so"
        if lib.exists():
            return lib
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}.tmp"
        nvcc = _nvcc()
        t0 = time.perf_counter()
        # one nvcc per source, all at once, then one link
        procs, objs = [], []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = out_dir / f"{src.stem}.{tag}.o"
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        self.log = "".join(logs)
        failed = [p.returncode for p in procs if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed ({failed}):\n{self.log}")
        tmp = out_dir / f"libsgcdet_kernels.{tag}.so"
        proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{self.log}")
        for obj in objs:
            obj.unlink()
        os.replace(tmp, lib)  # atomic: concurrent builders race harmlessly
        return lib


LIBRARY = _Library()


class Kernel:
    """A kernel behind one C entry point of the library, and its launch count.

    ``launches`` counts successful launches only; it is how a run shows
    that the main path went through the kernel.  Two kernels may share an
    entry point (stage 1 and stage 2 of DFA3D) and keep their own counts."""

    def __init__(self, symbol: str, argtypes):
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]  # + stream
        self.launches = 0
        self._fn = None

    def __call__(self, device: torch.device, *args):
        """Launch on ``device``'s current stream; raises if the launch
        was refused."""
        if self._fn is None:
            fn = getattr(LIBRARY.get(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            err = self._fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA launch failed with error {err}")
        self.launches += 1


def cuda_ms(fn, iters=10) -> float:
    """Warm mean milliseconds of fn() on the card (CUDA events).

    A spin kernel (about 50 ms) holds the stream while the host enqueues
    every launch, so the events time the device work and not the host's
    launch overhead, which exceeds a short kernel's own time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_cuda_input(t: torch.Tensor, name: str, dtypes, ndim: int,
                     device: torch.device) -> torch.Tensor:
    """Validate one kernel operand; returns it contiguous and 16-byte
    aligned (the kernels use vector loads)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def zeros_f32(shape, device: torch.device) -> torch.Tensor:
    """A zeroed f32 buffer that a kernel accumulates into by 16-byte vector
    reductions (``common.cuh::atomic_add_f32``), which need a 16-byte-aligned
    base; raises where the allocator gave another."""
    t = torch.zeros(shape, dtype=torch.float32, device=device)
    if t.data_ptr() % 16:
        raise RuntimeError(f"f32 accumulation buffer at {t.data_ptr():#x} is not "
                           "16-byte aligned")
    return t
