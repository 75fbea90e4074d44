"""BENCHMARK.json and the files each cell reads: names and units in the
allowed characters, every cell's files present, and a cell, a
configuration, a traffic mix and a per-layer metric that are new files
found by the harness without an edit to it, a mode of driving the program
too."""
from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import harness

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert all(re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(LINE.match(w) for w in BENCH["command"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[group]}) == len(BENCH[group])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert LINE.match(m["layer"]) and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert LINE.match(x["why"])


def test_bounds_and_metric_sources():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_with_its_files(cell):
    c = harness.load_cell(cell)
    assert c.config["reduced"] == [] and len(c.config["source"]) <= 200
    assert {"setup_s"} < {m["name"] for m in c.end_to_end}
    assert c.per_layer and set(c.readers) == {m["name"] for m in c.per_layer}
    assert c.limits and callable(c.mode.run)


def test_a_new_cell_config_mix_and_metric_are_found_as_files(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(REPO / "benchmark", root, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "configs" / "scannet.json").read_text())
    cfg["name"] = "scannet_copy"
    (root / "configs" / "scannet_copy.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "serve100.json").read_text())
    mix["views"] = 60
    (root / "traffic" / "serve60.json").write_text(json.dumps(mix))
    (root / "limits" / "scannet_copy.serve60.json").write_text(json.dumps({"head_err": 1.0}))
    (root / "metrics" / "calls.serve.py").write_text(
        "def read(trace):\n    return trace['window']['calls']\n")
    (root / "modes" / "replay.py").write_text(
        "def run(cell, seed, seconds, trace_on, dev, t_start, rank_entry=None):\n"
        "    return dict(attempted=1, failed=0, readings={}, complete=True, peak=0)\n")
    (root / "traffic" / "replay.json").write_text(json.dumps(dict(mix, mode="replay")))
    (root / "limits" / "scannet_copy.replay.json").write_text(json.dumps({}))
    bench["configs"].append(dict(bench["configs"][0], name="scannet_copy",
                                 file="benchmark/configs/scannet_copy.json"))
    bench["workloads"].append(dict(name="scannet_copy.serve60", config="scannet_copy",
                                   traffic="serve60", chips=1, why="a new cell"))
    bench["workloads"].append(dict(name="scannet_copy.replay", config="scannet_copy",
                                   traffic="replay", chips=1, why="a new mode"))
    for m in bench["end_to_end"]:
        if "workloads" in m and "scannet.serve100" in m["workloads"]:
            m["workloads"].append("scannet_copy.serve60")
    bench["per_layer"].append(dict(name="calls.serve", unit="scenes", better="higher",
                                   source="host_clock", layer="host decode",
                                   moves="serve_scenes_per_s",
                                   workloads=["scannet_copy.serve60"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("scannet_copy.serve60", root=root)
    assert cell.mix["views"] == 60 and cell.config["name"] == "scannet_copy"
    assert [m["name"] for m in cell.per_layer] == ["calls.serve"]
    assert cell.readers["calls.serve"].read({"window": {"calls": 7}}) == 7
    assert {m["name"] for m in cell.end_to_end} == {"serve_scenes_per_s", "serve_p95_s",
                                                     "peak_mem_gib", "setup_s"}
    assert cell.mode.__file__ == str(root / "modes" / "serve.py")
    replay = harness.load_cell("scannet_copy.replay", root=root)
    assert replay.mode.run(replay, 1, 1.0, False, None, 0.0)["attempted"] == 1


def test_program_config_holds_every_field_of_the_file():
    for c in BENCH["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        pcfg = harness.program_config(cfg)
        assert pcfg.model.embed_dims == cfg["model"]["embed_dims"]
        assert pcfg.model.topk_list == tuple(cfg["model"]["topk_list"])
        assert pcfg.model.test_cfg.score_thr == cfg["model"]["test_cfg"]["score_thr"]
        bad = dict(cfg, model=dict(cfg["model"], no_such_field=1))
        with pytest.raises(KeyError):
            harness.program_config(bad)
