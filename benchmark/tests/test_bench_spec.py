"""``BENCHMARK.json`` and the files it names, the result line's format, and
a cell, a configuration and a per-layer metric added as files alone."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from benchmark import harness, run

from conftest import TINY

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_spec_keeps_its_format():
    spec = harness.load_spec()
    assert set(spec) == KEYS
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in spec[k]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    cfgs = {c["name"]: c for c in spec["configs"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                          "device_trace")
    for c in spec["configs"]:
        path = os.path.join(harness.REPO, c["file"])
        with open(path) as f:
            data = json.load(f)
        assert c["file"].startswith("benchmark/configs/")
        assert data["reduced"] == c["reduced"]
        assert all(k in data and NAME.match(k) for k in c["reduced"])
    for w in spec["workloads"]:
        assert w["config"] in cfgs and w["chips"] == 1
        assert len(w["why"]) <= 200
        for kind in ("traffic", "limits"):
            name = w["traffic"] if kind == "traffic" else w["name"]
            assert os.path.exists(os.path.join(harness.DATA, kind,
                                               f"{name}.json"))
        ends, layer = harness.cell_metrics(spec, w["name"])
        assert "setup_s" in {m["name"] for m in ends} and len(ends) >= 2
        assert layer
        for m in layer:
            assert m["moves"] in {x["name"] for x in ends}
            assert os.path.exists(os.path.join(
                harness.DATA, "layer_metrics", f"{m['name']}.py"))
    assert {w["config"] for w in spec["workloads"]} == set(cfgs)
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert len(json.dumps(spec)) < 64 * 1024


def test_result_line_has_its_keys():
    out = harness.run_cell("sweep2d_grid", 2**31 + 77, 0.3, False,
                           device="cpu", overrides=TINY)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(out["metrics"]) == {"fields_per_s", "setup_s"}
    assert out["metrics"]["fields_per_s"]["unit"] == "fields/s"
    assert out["metrics"]["setup_s"]["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes", "power_limit_w"}
    assert out["attempted"] > 0 and out["failed"] == 0
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    assert json.loads(json.dumps(out)) == out


def test_run_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "train2d_cache", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_a_cell_added_as_files_alone(tmp_path):
    """A made-up configuration, traffic mix, cell and per-layer metric,
    each a new file: the harness finds and runs them by name."""
    root = tmp_path / "bench"
    for kind in ("configs", "traffic", "limits", "layer_metrics"):
        shutil.copytree(os.path.join(harness.DATA, kind), root / kind)
    cfg = json.loads((root / "configs" / "smoke_pos21_size5.json")
                     .read_text())
    (root / "configs" / "tiny2d.json").write_text(json.dumps(
        {**cfg, **TINY, "name": "tiny2d"}))
    (root / "traffic" / "sweep_small.json").write_text(json.dumps(
        {"kind": "sweep", "batch_size": 16, "sample": 8, "trace_sweep": 0}))
    (root / "limits" / "tiny2d.sweep.json").write_text(json.dumps(
        {"field_l2": {"limit": 0.05}}))
    (root / "layer_metrics" / "fields_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.work['fields'])\n")
    spec = harness.load_spec()
    spec["configs"].append({"name": "tiny2d", "source": "a test",
                            "file": "x", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny2d.sweep", "config": "tiny2d",
                              "traffic": "sweep_small", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "fields_per_s":
            m["workloads"].append("tiny2d.sweep")
    spec["per_layer"].append({"name": "fields_seen", "unit": "fields",
                              "better": "higher", "source": "device_trace",
                              "layer": "sweep", "moves": "fields_per_s",
                              "workloads": ["tiny2d.sweep"]})
    timed = harness.run_cell("tiny2d.sweep", 5, 0.2, False, device="cpu",
                             spec=spec, root=str(root))
    assert timed["correct"] and set(timed["metrics"]) == {"fields_per_s",
                                                          "setup_s"}
    traced = harness.run_cell("tiny2d.sweep", 5, 0.2, True, device="cpu",
                              spec=spec, root=str(root))
    # the CPU trace holds no device row: the readers of device shares find
    # nothing to read there, the made-up reader its count
    assert traced["metrics"] == {"fields_seen": {"value": 60.0,
                                                 "unit": "fields"}}
    assert traced["device"]["window_s"] > 0
    assert list(traced)[-2:] == ["breakdown", "checks"]
