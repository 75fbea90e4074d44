"""The readers of the program's own spans and counters
(``benchmark/program_trace.py``): each on a fabricated summary of the
program's recorder, None without the program's ``tracing`` module, without
a profile, and where the root span's calls differ from the profiled
sub-window's; and the serving readers on a tiny scene recorded under a
CPU profiler."""
from __future__ import annotations

import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, program_trace
from benchmark.tests.tiny import cpu, tiny_cell

SERVE = dict(spans={"sgc.detect": dict(calls=4, host_ms=400.0, self_host_ms=4.0, device_ms=480.0),
                    "sgc.detect.upload": dict(calls=4, host_ms=60.0, self_host_ms=60.0,
                                              device_ms=68.0),
                    "sgc.decode.nms": dict(calls=4, host_ms=20.0, self_host_ms=20.0,
                                           device_ms=21.0)},
             counters={"decode.nms_in": 12000, "lift.visible": 300, "lift.slots": 1200})
STEP = dict(spans={"sgc.step": dict(calls=2, host_ms=300.0, self_host_ms=1.0, device_ms=340.0),
                   **{f"sgc.step.{p}": dict(calls=2, host_ms=ms, self_host_ms=ms, device_ms=2 * ms)
                      for p, ms in (("forward", 50.0), ("backward", 100.0), ("optimizer", 10.0),
                                    ("exchange", 30.0), ("rank_seed", 4.0))}},
            counters={})
# metric -> (its cell, the summary it reads, its value)
EXPECTED = {
    "upload_ms.serve": ("scannet.serve100", SERVE, 17.0),
    "nms_ms.serve": ("scannet.serve100", SERVE, 5.0),
    "nms_in.serve": ("scannet.serve100", SERVE, 3000.0),
    "kept_share.serve": ("scannet.serve100", SERVE, 25.0),
    "forward_ms.train": ("scannet.train40", STEP, 50.0),
    "backward_ms.train": ("scannet.train40", STEP, 100.0),
    "optimizer_ms.train": ("scannet.train40", STEP, 10.0),
    "exchange_ms.dp": ("scannet.train40.dp4", STEP, 30.0),
    "seed_wait_ms.dp": ("scannet.train40.dp4", STEP, 2.0),
}


def _reader(metric):
    cell = harness.load_cell(EXPECTED[metric][0])
    return cell.readers[metric]


def _trace(summary):
    root = "sgc.detect" if "sgc.detect" in summary["spans"] else "sgc.step"
    return dict(profile=dict(calls=summary["spans"][root]["calls"]))


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_on_a_fabricated_summary(metric, monkeypatch):
    _, summary, value = EXPECTED[metric]
    monkeypatch.setattr(program_trace, "program_summary", lambda: summary)
    read = _reader(metric).read
    assert read(_trace(summary)) == pytest.approx(value)
    assert read(dict(profile=None)) is None
    assert read(dict(profile=dict(calls=_trace(summary)["profile"]["calls"] + 1))) is None


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_without_the_programs_recorder(metric, monkeypatch):
    import sgcdet_tpu_torch

    _, summary, _ = EXPECTED[metric]
    monkeypatch.delattr(sgcdet_tpu_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "sgcdet_tpu_torch.tracing", None)  # import fails
    assert program_trace.program_summary() is None
    assert _reader(metric).read(_trace(summary)) is None


def test_serving_readers_on_a_recorded_scene():
    """Two tiny scenes through ``infer.detect`` under a CPU profiler: the
    host-clock and counter readers read the program's recorder; the device
    ms of the upload is None without a card."""
    from sgcdet_tpu_torch import infer, tracing
    from sgcdet_tpu_torch.models import SGCDet

    cell = tiny_cell("serve")
    cell.config["model"]["compute_dtype"] = "float32"
    with torch.random.fork_rng(devices=[]):
        _, pcfg, scans, _ = harness.setup(cell, 5, cpu())
        model = SGCDet(pcfg.model, pcfg.data.img_shape, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    tracing.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for scan in scans[:2]:
                infer.detect(model, scan)
        readers = harness.load_cell("scannet.serve100").readers
        trace = dict(profile=dict(calls=2))
        assert readers["nms_ms.serve"].read(trace) > 0
        assert readers["nms_in.serve"].read(trace) >= 0
        assert 0 < readers["kept_share.serve"].read(trace) <= 100
        assert readers["upload_ms.serve"].read(trace) is None
        assert readers["nms_ms.serve"].read(dict(profile=dict(calls=3))) is None
    finally:
        tracing.reset()
