"""The port's host spans (``deepfluids_tpu_torch.spans``): totals, counts
and self time with the profiler off; nested ``user_annotation`` rows under
a CPU ``torch.profiler``; and the spans of the trainer's step path
(its chunk body, uncaptured on the CPU), of its ``metrics.jsonl`` and of ``sweep_on_device``'s ring copies."""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from deepfluids_tpu_torch import spans
from deepfluids_tpu_torch.config import Config
from deepfluids_tpu_torch.data import Manifest, save_manifest
from deepfluids_tpu_torch.infer.sweep import param_grid, sweep_on_device
from deepfluids_tpu_torch.train.trainer import Trainer

GRID = (16, 12)


@pytest.fixture(autouse=True)
def fresh_spans():
    spans.take()
    yield
    assert spans._children == [], "a span was left open"


def _annotations(path: str, names) -> list[dict]:
    """The trace's ``user_annotation`` rows named ``names``, by start."""
    with open(path) as f:
        doc = json.load(f)
    return sorted((e for e in doc["traceEvents"]
                   if e.get("cat") == "user_annotation"
                   and e.get("name") in names), key=lambda e: e["ts"])


def _inside(inner: dict, outer: dict) -> bool:
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_totals_counts_and_self_time_with_the_profiler_off(monkeypatch):
    ticks = iter([0, 10, 40, 50, 55, 100, 200, 207])
    monkeypatch.setattr(spans, "_clock", lambda: next(ticks))
    assert not autograd_profiler._is_profiler_enabled
    with spans.span("outer") as outer:
        with spans.span("inner"):
            pass
        with spans.span("inner") as second:
            pass
    with spans.span("outer"):
        pass
    assert (outer.ns, second.ns) == (100, 5)
    # outer: 100 + 7 ns, 65 of its first 100 its own
    assert spans.take() == {"outer": [2, 107, 72], "inner": [2, 35, 35]}
    assert spans.take() == {}


def test_a_span_that_raises_still_counts():
    with pytest.raises(ValueError), spans.span("fails"):
        raise ValueError
    assert spans.take()["fails"][0] == 1


def test_profiled_spans_are_nested_user_annotations_with_ids(tmp_path):
    path = str(tmp_path / "t.json")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(2):
            with spans.span("seg"):
                with spans.span("part"):
                    torch.ones(4).sum()
    prof.export_chrome_trace(path)
    segs, parts = (_annotations(path, {n}) for n in ("seg", "part"))
    assert (len(segs), len(parts)) == (2, 2)
    assert all(_inside(p, s) for p, s in zip(parts, segs))
    assert segs[0]["ts"] + segs[0]["dur"] <= segs[1]["ts"]
    assert {n: t[0] for n, t in spans.take().items()} == {"seg": 2,
                                                          "part": 2}


def test_spans_across_the_window_edges(tmp_path):
    # a span open when the profiler starts is no row of its trace; one
    # opened while it records is, though it closes after the stop; all
    # count
    path = str(tmp_path / "t.json")
    prof = profile(activities=[ProfilerActivity.CPU])
    with spans.span("before"):
        prof.start()
        with spans.span("inside"):
            torch.ones(4).sum()
    with spans.span("after"):
        prof.stop()
    prof.export_chrome_trace(path)
    assert [e["name"] for e in _annotations(
        path, {"before", "inside", "after"})] == ["inside", "after"]
    assert {n: t[0] for n, t in spans.take().items()} == {
        "before": 1, "inside": 1, "after": 1}


def _dataset(root: str) -> str:
    save_manifest(Manifest(
        param_names=["src_x_pos", "src_radius", "frame"],
        param_ranges=[[0.2, 0.8], [0.04, 0.12], [0.0, 3.0]],
        num_scenes=2, num_frames=4, resolution=list(GRID), num_channels=2,
        v_range=[-1.0, 1.0], data_type="velocity"), os.path.join(root, "d"))
    os.makedirs(os.path.join(root, "d", "v"))
    rng = np.random.default_rng(5)
    for s in range(2):
        for t in range(4):
            np.savez(os.path.join(root, "d", "v", f"{s}_0_{t}.npz"),
                     x=rng.standard_normal(GRID + (2,)).astype(np.float32),
                     y=np.array([0.2 + 0.3 * s, 0.04 + 0.02 * s, t],
                                np.float32))
    return root


def _chunked(root: str, tag: str, **kw) -> Trainer:
    c = Config(arch="de", dataset="d", data_dir=root, log_dir=root, tag=tag,
               filters=8, num_conv=1, z_num=8, batch_size=2, max_step=10,
               lr_max=2e-3, lr_min=1e-4, log_step=2, test_step=10_000,
               save_step=4, compute_dtype="float32", num_worker=1, seed=3,
               **{"device_data_cache": True, **kw})
    return Trainer(c, device="cpu")


def test_the_chunked_trainer_traces_its_feed(tmp_path):
    # --profile_steps 3,6 on the uncaptured body: the window's chunks as
    # train.block, train.fill and train.replay rows, one each a chunk in
    # order; the same trajectory as the run without it.
    root = _dataset(str(tmp_path))
    traced = _chunked(root, "p", profile_steps="3,6",
                      profile_dir=str(tmp_path / "prof"))
    plain = _chunked(root, "q")
    assert traced.train(num_steps=8) == plain.train(num_steps=8)
    for k, v in plain.model.state_dict().items():
        torch.testing.assert_close(traced.model.state_dict()[k], v, atol=0,
                                   rtol=0, msg=k)
    [path] = glob.glob(str(tmp_path / "prof" / "*.trace.json"))
    rows = _annotations(path, {"train.block", "train.fill", "train.replay"})
    names = [e["name"] for e in rows]
    assert names == ["train.block", "train.fill", "train.replay"] * 4
    # each is its own phase: none holds another
    assert not any(_inside(b, a) for a, b in zip(rows, rows[1:]))


@pytest.mark.parametrize("cache", [False, True], ids=["stream", "cache"])
def test_next_batch_spans_each_streamed_batch(tmp_path, cache):
    # the native stream's batches are taken one a span, at one step a
    # chunk and at three; the device cache takes none
    t = _chunked(_dataset(str(tmp_path)), "n", device_data_cache=cache)
    path = str(tmp_path / "t.json")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t.train(num_steps=2)
        t.c.steps_per_call = 3
        t.train(num_steps=6)
    prof.export_chrome_trace(path)
    rows = _annotations(path, {"train.block", "train.next_batch"})
    names = [e["name"] for e in rows]
    assert names.count("train.block") == 4
    assert names.count("train.next_batch") == (0 if cache else 8)
    blocks = [e for e in rows if e["name"] == "train.block"]
    assert all(any(_inside(e, b) for b in blocks) for e in rows)


def test_metrics_rows_hold_the_host_seconds_of_each_span(tmp_path):
    t = _chunked(_dataset(str(tmp_path)), "m")
    t.train(num_steps=8)
    with open(os.path.join(t.run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    assert [r["step"] for r in rows] == [2, 4, 6, 8]
    host = [r["host_s"] for r in rows]
    assert all(v > 0 for h in host for v in h.values())
    # the cache is staged in the first chunk; the checkpoint at step 4
    # comes after that step's row; a row's own log sync is in the next
    assert "train.stage_cache" in host[0]
    assert "train.checkpoint" not in host[1]
    assert host[2]["train.checkpoint"] >= host[2]["train.weights_npz"] > 0
    assert {"train.block", "train.fill", "train.replay",
            "train.log_sync"} <= set(host[2])
    assert "train.stage_cache" not in host[2]


def test_sweep_segments_are_host_copy_spans(tmp_path):
    m = Manifest(param_names=["pos", "size", "frame"],
                 param_ranges=[[0.2, 0.8], [0.04, 0.12], [0.0, 3.0]],
                 num_scenes=2, num_frames=4, resolution=list(GRID),
                 num_channels=2, v_range=[-2.0, 2.0])
    w = torch.randn(3, 16 * 12 * 2,
                    generator=torch.Generator().manual_seed(19))

    def apply_fn(p):
        return (p @ w).view(-1, *GRID, 2)

    raw = param_grid(m, (3, 1))                         # 12 fields
    one = sweep_on_device(apply_fn, m, raw, batch_size=4, device="cpu")
    path = str(tmp_path / "t.json")
    # 3 batches over a cap of 2: each batch is copied out of the ring, one
    # span a batch
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        two = sweep_on_device(apply_fn, m, raw, batch_size=4,
                              max_out_bytes=2 * 4 * 16 * 12 * 2 * 4,
                              device="cpu")
    prof.export_chrome_trace(path)
    np.testing.assert_array_equal(two, one)
    rows = _annotations(path, {"sweep.host_copy"})
    assert len(rows) == 3
    assert all(a["ts"] + a["dur"] <= b["ts"] for a, b in zip(rows, rows[1:]))
    assert spans.take()["sweep.host_copy"][0] == 3
