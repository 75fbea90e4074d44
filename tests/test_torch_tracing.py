"""The program's spans and counters (``sgcdet_tpu_torch/tracing.py``), on the
CPU at the tiny config:

* without a profiler ``span`` is the shared no-op and nothing is recorded,
  with ``record_function`` and ``torch.cuda.Event`` made to raise;
* under ``torch.profiler.profile`` one ``infer.detect`` and one train step
  record each span of the layer boundaries once, under its parent and its
  root, on the profiler's own timeline; the lifting's visible query slots
  are at most the slots the DFA3D ran, and the NMS sees at least the boxes
  it returns;
* the data-parallel step in a gloo group of one process adds the rank
  seed's and the exchange's spans.
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from sgcdet_tpu_torch import configs, infer, tracing
from sgcdet_tpu_torch.models import SGCDet
from sgcdet_tpu_torch.scene import example_scene, example_train_scene
from sgcdet_tpu_torch.train import make_optimizer, make_train_step

from torch_port_tiny import (  # noqa: F401 (keep_global_torch_rng is autouse)
    IMG_SHAPE,
    N_VIEWS,
    PAD,
    keep_global_torch_rng,
    tiny_model_cfg,
)

MODEL = ("sgc.model.backbone", "sgc.model.depth", "sgc.model.lifting", "sgc.model.head")
# span -> its parent, in one call of the root
DETECT = {"sgc.detect": None, "sgc.detect.upload": "sgc.detect",
          **{m: "sgc.detect" for m in MODEL},
          "sgc.decode": "sgc.detect", "sgc.decode.nms": "sgc.decode"}
STEP = {"sgc.step": None, "sgc.step.forward": "sgc.step",
        **{m: "sgc.step.forward" for m in MODEL},
        "sgc.step.backward": "sgc.step", "sgc.step.optimizer": "sgc.step"}
DP_STEP = {**STEP, "sgc.step.rank_seed": "sgc.step", "sgc.step.exchange": "sgc.step"}


@pytest.fixture(scope="module")
def tiny():
    mcfg = tiny_model_cfg(configs=configs)
    # every candidate passes the score threshold, so the NMS has work
    mcfg = dataclasses.replace(mcfg, ffn_dropout=0.0, test_cfg=dataclasses.replace(
        mcfg.test_cfg, score_thr=0.0))
    base = configs.scannet()
    cfg = dataclasses.replace(base, model=mcfg, data=dataclasses.replace(
        base.data, img_shape=IMG_SHAPE, pad_size=PAD))
    train_scene = example_train_scene(IMG_SHAPE, PAD, N_VIEWS, mcfg.n_classes, 8,
                                      trajectory="ring")
    model = SGCDet(mcfg, IMG_SHAPE, device="cpu", generator=torch.Generator().manual_seed(0))
    return cfg, model, example_scene(IMG_SHAPE, PAD, N_VIEWS, trajectory="ring"), train_scene


@pytest.fixture(autouse=True)
def fresh_recorder():
    tracing.reset()
    yield
    tracing.reset()


def profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, {e.name for e in prof.events()}


def check_call(records, expected):
    """``records`` are one root call's spans: each expected name once, under
    its parent, inside its parent's interval, with the root's number."""
    assert sorted(r.name for r in records) == sorted(expected)
    by_name = {r.name: r for r in records}
    root = by_name[next(n for n, p in expected.items() if p is None)]
    for r in records:
        assert r.parent == expected[r.name], r.name
        assert r.root == root.root, r.name
        assert r.events is None  # no CUDA on this host
        if r.parent is not None:
            parent = by_name[r.parent]
            assert parent.t0_ns <= r.t0_ns <= r.t1_ns <= parent.t1_ns, r.name


def test_spans_off_without_a_profiler(tiny, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("touched with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    cfg, model, scene, train_scene = tiny
    assert tracing.span("sgc.detect") is tracing.NOOP
    assert tracing.span("sgc.step") is tracing.span("other")
    infer.detect(model, scene)
    make_train_step(model, cfg, make_optimizer(model, cfg.train))(
        train_scene, torch.Generator().manual_seed(0))
    tracing.count("lift.slots", 5)
    assert tracing.RECORDER.spans == [] and tracing.RECORDER.counters == {}
    assert tracing.summary() == dict(spans={}, counters={})


def test_detect_and_train_step_spans_and_counters(tiny):
    cfg, model, scene, train_scene = tiny
    (boxes, _, _), names = profiled(lambda: infer.detect(model, scene))
    assert set(DETECT) <= names  # the spans are the profiler's own events
    check_call(tracing.RECORDER.spans, DETECT)
    counts = tracing.summary()["counters"]
    assert 0 < counts["lift.visible"] <= counts["lift.slots"]
    assert counts["decode.nms_in"] >= len(boxes) > 0

    tracing.reset()
    step = make_train_step(model, cfg, make_optimizer(model, cfg.train))
    _, names = profiled(lambda: step(train_scene, torch.Generator().manual_seed(0)))
    assert set(STEP) <= names
    check_call(tracing.RECORDER.spans, STEP)
    summary = tracing.summary()
    for name, s in summary["spans"].items():
        assert s["calls"] == 1 and s["device_ms"] is None, name
        assert 0 <= s["self_host_ms"] <= s["host_ms"], name
    parts = sum(summary["spans"][f"sgc.step.{p}"]["host_ms"]
                for p in ("forward", "backward", "optimizer"))
    assert parts <= summary["spans"]["sgc.step"]["host_ms"]
    assert 0 < summary["counters"]["lift.visible"] <= summary["counters"]["lift.slots"]


def test_each_root_call_has_its_own_number(tiny):
    cfg, model, scene, _ = tiny
    profiled(lambda: [infer.detect(model, scene) for _ in range(2)])
    roots = sorted({r.root for r in tracing.RECORDER.spans})
    assert roots == [1, 2]
    for root in roots:
        check_call([r for r in tracing.RECORDER.spans if r.root == root], DETECT)
    assert tracing.summary()["spans"]["sgc.detect"]["calls"] == 2


def test_data_parallel_step_spans(tiny, tmp_path):
    cfg, model, _, train_scene = tiny
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        step = make_train_step(model, cfg, make_optimizer(model, cfg.train),
                               group=dist.group.WORLD)
        _, names = profiled(lambda: step(train_scene, torch.Generator().manual_seed(0)))
    finally:
        dist.destroy_process_group()
    assert set(DP_STEP) <= names
    check_call(tracing.RECORDER.spans, DP_STEP)
