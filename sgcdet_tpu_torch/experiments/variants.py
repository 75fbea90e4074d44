"""Kernel variants timed beside the kernels as they are: copies of this
tree, each with one constant of a kernel source changed, built and timed
each in its own process (the kernel library is one per process), in one
call on one card.

    python -m sgcdet_tpu_torch.experiments.variants

copies the package and ``chip_smoke.py`` under ``build/variants/`` once per
entry of ``VARIANTS``, builds every copy at once (each into its own
``build/``), then, twice over in turns, prints for the tree itself and for
each variant the warm times of K2 (stage 1) at the ScanNet and
ScanNet200-L level-2 shapes and of the gather epilogue at the probe's
shape (PERF.md rows 4, 4L, 8, 13 and 28), each case first held against its
plain version.  The inputs are ``chip_smoke.py``'s, made from the same
seeds in every copy.  Needs a CUDA card and nvcc; it refuses to run
without a card.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "variants"

# name: (kernel source, its text as committed, the variant's)
VARIANTS = {
    "K2 2 rounds a warp": ("dfa3d_fwd.cu", "constexpr int kS1Rounds = 4;",
                           "constexpr int kS1Rounds = 2;"),
    "K2 8 rounds a warp": ("dfa3d_fwd.cu", "constexpr int kS1Rounds = 4;",
                           "constexpr int kS1Rounds = 8;"),
    "K2 32 queries a warp": ("dfa3d_fwd.cu", "constexpr int kS1Rounds = 4;",
                             "constexpr int kS1Rounds = 32;"),
    "epilogue 8 rows a warp": ("rows.cu", "constexpr int kEpiWarpRows = 4;",
                               "constexpr int kEpiWarpRows = 8;"),
    "epilogue 16 loads together": ("rows.cu", "constexpr int kLoads = 8; ",
                                   "constexpr int kLoads = 16; "),
    "epilogue blocks of 64 rows": ("rows.cu", "constexpr int kEpiBlockRows = 128;",
                                   "constexpr int kEpiBlockRows = 64;"),
    "epilogue without the 64-register cap": (
        "rows.cu", "__launch_bounds__(kEpiThreads, 4) gather_epilogue_kernel(",
        "__launch_bounds__(kEpiThreads) gather_epilogue_kernel("),
}


def make_copies():
    """{name: root} of the tree itself and of one copy per variant."""
    shutil.rmtree(OUT, ignore_errors=True)
    copies = {"as committed": ROOT}
    for i, (name, (source, old, new)) in enumerate(VARIANTS.items()):
        root = OUT / f"v{i}"
        shutil.copytree(ROOT / "sgcdet_tpu_torch", root / "sgcdet_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", root)
        path = root / "sgcdet_tpu_torch" / "csrc" / source
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name!r}: {old!r} is not once in {source}")
        path.write_text(text.replace(old, new))
        copies[name] = root
    return copies


def time_here():
    """The timings of the tree in the working directory (``--time``)."""
    sys.path.insert(0, ".")
    import torch

    import chip_smoke as cs
    from sgcdet_tpu_torch.experiments import probes
    from sgcdet_tpu_torch.ops.dfa3d import dfa3d_attention_plain, dfa3d_fwd_cuda

    dev = torch.device("cuda", 0)
    cfg, scene = cs._scene_and_cfg()
    gen = torch.Generator(device=dev).manual_seed(0)
    x = cs._lifting_inputs(torch, dev, cfg, scene, 2, cs._auto_budget(cfg, scene)[2], gen)
    y = cs._lifting_2d_inputs(torch, dev, cfg, scene, 2, gen)
    lcfg, lscene = cs._scene_and_cfg(cs.LARGE)
    xl = cs._lifting_inputs(torch, dev, lcfg, lscene, 2, cs._auto_budget(lcfg, lscene)[2], gen)
    bf = torch.bfloat16
    s1 = (x["locs1"], x["attn1"], 1)
    cases = {
        "K2 c=256 bf16/f32 counted (row 4)": (x["value"].to(bf), x["depth"], *s1, x["counts"]),
        "K2 c=256 bf16/f32 uncounted": (x["value"].to(bf), x["depth"], *s1, None),
        "K2 c=256 f32/f32 counted": (x["value"], x["depth"], *s1, x["counts"]),
        "K2 c=256 f32/f32 uncounted (row 13)": (x["value"], x["depth"], *s1, None),
        "K2 c=256 2D bf16/bf16 (row 8)": (y["value"], y["ones"], y["locs1"], y["attn1"], 1,
                                          None),
        "K2 c=128 -L bf16/f32 counted (row 4L)": (xl["value"].to(bf), xl["depth"],
                                                  xl["locs1"], xl["attn1"], 1, xl["counts"]),
        "K2 c=128 -L f32/f32 counted": (xl["value"], xl["depth"], xl["locs1"], xl["attn1"], 1,
                                        xl["counts"]),
    }
    runs = {name: (lambda a=args: dfa3d_fwd_cuda(*a), lambda a=args: dfa3d_attention_plain(*a))
            for name, args in cases.items()}
    epi = next(c for c in probes.probe_cases(dev) if "p4+epi" in c.name)
    runs[f"{epi.name} (row 28)"] = (epi.run, epi.run_plain)
    for name, (run, run_plain) in runs.items():
        got, want = run(), run_plain()
        torch.cuda.synchronize()
        cs.compare_tensors(torch, name, got, want, f32_rel=1e-5 if "epi" in name else 1e-4)
        del got, want
        print(f"{name}: {cs.cuda_ms(torch, run, iters=20):.4f} ms", flush=True)


def main():
    if "--time" in sys.argv[1:]:
        time_here()
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("variants: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    copies = make_copies()
    builds = [subprocess.Popen([sys.executable, "-c", "from sgcdet_tpu_torch.ops import "
                                "LIBRARY; LIBRARY.get()"], cwd=root,
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for root in copies.values()]
    for name, proc in zip(copies, builds):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"variants: {name} did not build:\n{log}")
    for _ in range(2):
        for name, root in copies.items():
            proc = subprocess.run([sys.executable, "-m", "sgcdet_tpu_torch.experiments.variants",
                                   "--time"], cwd=root, capture_output=True, text=True)
            if proc.returncode != 0:
                raise SystemExit(f"variants: {name} failed:\n{proc.stdout}{proc.stderr}")
            for line in proc.stdout.splitlines():
                if " ms" in line and "max_abs_err" not in line:
                    print(f"[{name}] {line}", flush=True)


if __name__ == "__main__":
    main()
