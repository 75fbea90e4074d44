"""The reference agrees with sgcdet_tpu_torch at a tiny float32 config on
the CPU (a whole run of each mode, the chip's look skipped), and the
control, the reference at float8 in the program's place, fails the cells'
limits.  This file imports the program; the reference does not."""
from __future__ import annotations

import time

import pytest
import torch

from benchmark import control, harness
from benchmark.tests.tiny import cpu, tiny_cell


@pytest.fixture(autouse=True)
def _global_rng():
    with torch.random.fork_rng(devices=[]):
        yield


def _run(cell, seconds=0.3):
    line, err = harness.run_cell(cell, 2 ** 31 + 12345, seconds, False, cpu(),
                                 time.perf_counter())
    return line, err


def test_serving_agrees_at_float32():
    cell = tiny_cell("serve")
    cell.config["model"]["compute_dtype"] = "float32"
    line, err = _run(cell)
    checks = line["checks"]
    assert line["correct"] and line["failed"] == 0, err
    assert checks["head_err"]["value"] < 1e-5
    assert checks["pick_gap"]["value"] == 0.0 and checks["decode_mismatch"]["value"] == 0


def test_training_agrees_at_float32():
    cell = tiny_cell("train")
    cell.config["model"]["compute_dtype"] = "float32"
    line, err = _run(cell)
    checks = line["checks"]
    assert line["correct"], err
    assert checks["loss_gap"]["value"] < 1e-5 and checks["grad_gap"]["value"] < 1e-4
    assert checks["change_gap"]["value"] < 1e-2 and checks["pick_gap"]["value"] == 0.0


@pytest.mark.parametrize("mode,limits_of", [("serve", "scannet.serve100"),
                                            ("train", "scannet.train40"),
                                            ("train", "scannet200_large.train40")])
def test_control_fails_the_limits(mode, limits_of):
    cell = tiny_cell(mode)
    limits = harness.load_cell(limits_of).limits
    read = control.control_readings(cell, 11, cpu())
    over = [k for k, lim in limits.items() if read[k] > lim]
    assert over, (read, limits)


def test_control_gradient_passes_through_the_rounding():
    from benchmark.reference.model import fp8_round

    x = torch.randn(64, dtype=torch.float64, requires_grad=True)
    y = fp8_round(x)
    (y * torch.arange(64.0, dtype=torch.float64)).sum().backward()
    assert 0 < float((y - x).abs().max()) < 0.1 * float(x.abs().max())
    assert torch.equal(x.grad, torch.arange(64.0, dtype=torch.float64))
