"""The data-parallel training cell's path on the CPU: two gloo ranks of a
tiny float32 config held by the reference run as two ranks too, the run
correct; and the same with the gradient exchange between the ranks left
out, not correct."""
from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from benchmark import control, harness
from benchmark.tests.tiny import cpu, tiny_cell

SEED = 424242


def _cell():
    cell = tiny_cell("train", limits=harness.load_cell("scannet.train40").limits)
    cell.config["model"]["compute_dtype"] = "float32"
    cell.mix["ranks"] = 2
    return dataclasses.replace(cell,
                               end_to_end=harness.load_cell("scannet.train40.dp4").end_to_end)


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def test_dp_run_is_correct():
    line, err = harness.run_cell(_cell(), SEED, 0.3, False, cpu(), time.perf_counter())
    assert line["correct"], err
    assert line["metrics"]["dp_train_scenes_per_s"]["value"] > 0
    assert line["checks"]["loss_gap"]["value"] < 1e-5
    assert line["checks"]["grad_gap"]["value"] < 1e-4


def test_dp_without_the_gradient_exchange_is_not_correct():
    cell = _cell()
    line, err = control.program_run(cell, SEED, cpu(), "noexchange", seconds=0.3)
    over = [k for k, c in line["checks"].items() if c["value"] > c["limit"]]
    assert not line["correct"] and over, err

