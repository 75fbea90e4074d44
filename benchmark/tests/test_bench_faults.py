"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven on
the CPU at a tiny float32 config, with the cells' own limits, once for
each fault that the cell can have (``control.planted``)."""
from __future__ import annotations

import pytest
import torch

from benchmark import control, harness
from benchmark.tests.tiny import cpu, tiny_cell


@pytest.fixture(autouse=True)
def _global_rng():
    with torch.random.fork_rng(devices=[]):
        yield


def _run(mode, limits_of, fault=None):
    cell = tiny_cell(mode, views=8, limits=harness.load_cell(limits_of).limits)
    cell.config["model"]["compute_dtype"] = "float32"
    line, err = control.program_run(cell, 987654321, cpu(), fault, seconds=0.3)
    return line, err


def test_sound_runs_are_correct():
    for mode, limits_of in (("serve", "scannet.serve100"), ("train", "scannet.train40")):
        line, err = _run(mode, limits_of)
        assert line["correct"], err


@pytest.mark.parametrize("fault", ["answer_altered", "half_the_views"])
def test_serving_faults(fault):
    planted = {"answer_altered": "altered", "half_the_views": "half"}[fault]
    line, err = _run("serve", "scannet.serve100", planted)
    assert not line["correct"], err


@pytest.mark.parametrize("limits_of", ["scannet.train40", "scannet200_large.train40"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_views"])
def test_training_faults(fault, limits_of):
    planted = {"state_unchanged": "unchanged", "half_the_views": "half"}[fault]
    line, err = _run("train", limits_of, planted)
    assert not line["correct"], err
