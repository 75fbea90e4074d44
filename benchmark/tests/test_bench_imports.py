"""What runs on the card loads neither JAX nor the JAX package, compared
by whole top-level names (the port's name begins with the JAX package's),
and the reference loads nothing of the program; a run refuses without a
card, and in a directory that holds only the benchmark's files."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
CHECK = """
import sys
{imports}
bad = sorted(m for m in sys.modules if m.split(".")[0] in {names!r})
print(bad)
sys.exit(1 if bad else 0)
"""


def _loads_none(imports, names, cwd=REPO):
    code = CHECK.format(imports=imports, names=tuple(names))
    proc = subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_harness_traffic_reference_load_no_jax():
    _loads_none("import benchmark.run, benchmark.harness, benchmark.traffic, "
                "benchmark.check, benchmark.control, benchmark.reference.model, "
                "benchmark.reference.train, benchmark.reference.decode\n"
                "from benchmark import harness\n"
                "c = harness.load_cell('scannet.serve100')\n"
                "harness.load_cell('scannet.train40.dp4')\n"
                "harness.program_config(c.config)\n"
                "import sgcdet_tpu_torch.infer, sgcdet_tpu_torch.train",
                ("jax", "jaxlib", "flax", "sgcdet_tpu"))


def test_reference_loads_nothing_of_the_program():
    _loads_none("import benchmark.reference.model, benchmark.reference.train, "
                "benchmark.reference.decode, benchmark.reference.ops, benchmark.work, "
                "benchmark.weights, benchmark.check, benchmark.traffic",
                ("sgcdet_tpu_torch", "sgcdet_tpu", "jax", "jaxlib", "flax"))


def test_run_names_forbidden_modules_by_whole_names(monkeypatch):
    import types

    from benchmark import run

    for name in ("sgcdet_tpu_torch", "sgcdet_tpu_torch.ops", "jaxtyping", "sgcdet_tpu",
                 "jax.numpy"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == ["jax.numpy", "sgcdet_tpu"]


def test_run_refuses_without_a_card_and_without_the_program(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal without one cannot be seen here")
    args = [sys.executable, "-m", "benchmark.run", "--workload", "scannet.serve100",
            "--seed", "1", "--seconds", "1", "--trace", "0"]
    proc = subprocess.run(args, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and not proc.stdout.strip()
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(args, cwd=tmp_path, capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode != 0 and not proc.stdout.strip()


@pytest.mark.cuda
def test_a_short_run_prints_the_contract_line():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = [sys.executable, "-m", "benchmark.run", "--workload", "scannet.serve100",
            "--seed", "2147483659", "--seconds", "2", "--trace", "0"]
    proc = subprocess.run(args, cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["device"]["platform"] == "gpu"
