"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the kernel library, the seeded pool and weights, the
warm-up of every shape the cell's traffic uses) counts as ``setup_s``; the
window then measures for ``--seconds``.  ``--trace 1`` runs the same window
with the per-layer metrics' hooks and a profiled sub-window after it, and
prints the per-layer metrics instead of the end-to-end ones.  Every run
checks the window's outputs against the plain reference
(``benchmark/check.py``) and prints each compared number beside its limit,
last on standard error and under ``checks`` in the result line, which is
the last line of standard output.

Without a CUDA card, with fewer cards than the cell asks for, or when the
JAX package or JAX is loaded once the window has closed, it prints no
result and exits with 2."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# every cache of a run inside the checkout, at fixed paths
CACHE = REPO / "build" / "bench-cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(CACHE / sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "sgcdet_tpu")


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    line, err = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), dev,
                                 T_START)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or of the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 2
    for text in err:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
