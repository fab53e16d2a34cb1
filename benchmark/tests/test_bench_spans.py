"""The readers of the program's spans over hand-made traces: the sweep's
host copies, and the trainer's chunk feed against the device's idle gaps;
each reads None in a trace without spans (the program before it had
them)."""

from __future__ import annotations

import json

import pytest

from benchmark import harness, spans, trace

READERS = ("host_copy_share.sweep", "feed_idle.train2d", "feed_idle.train3d")

# A training window (the trainer's own trace: no window annotation, so it
# runs from the first event to the last, 0..100 us): the device busy over
# 0..10, 30..45, 46..60 and 80..100.  A chunk's block, then its fill, whose
# staging wait holds an event sync and after which it copies; the replay's
# launch, while the device runs on with a 1-us gap between two kernels; a
# log sync outside the feed.
TRAIN = [
    ("kernel", "sm90_xmma_fprop_implicit_gemm_bf16", 0.0, 10.0),
    ("kernel", "void curl2d_kernel<float, 4, 1>(float const*)", 30.0, 15.0),
    ("kernel", "void jacobian2d_kernel<float, 4>(float const*)", 46.0, 14.0),
    ("kernel", "multi_tensor_apply_kernel", 80.0, 20.0),
    ("user_annotation", "train.block", 10.0, 4.0),
    ("user_annotation", "train.fill", 14.0, 16.0),
    ("user_annotation", "train.stage_wait", 16.0, 12.0),
    ("cuda_runtime", "cudaEventSynchronize", 16.5, 11.0),
    ("cuda_runtime", "cudaMemcpyAsync", 28.5, 1.0),
    ("user_annotation", "train.replay", 40.0, 10.0),
    ("cuda_runtime", "cudaGraphLaunch", 40.5, 9.0),
    ("user_annotation", "train.log_sync", 64.0, 16.0),
]

# A sweep window (annotated, 100..200 us): the device busy over 100..140
# and a copy to the host over 140..150; the two segments' host copies
# leave it idle over 150..170 and 175..195.
SWEEP = [
    ("user_annotation", "bench.window", 100.0, 100.0),
    ("kernel", "sm90_xmma_fprop_implicit_gemm_bf16", 100.0, 40.0),
    ("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 140.0, 10.0),
    ("user_annotation", "sweep.host_copy", 150.0, 20.0),
    ("kernel", "sm90_xmma_fprop_implicit_gemm_bf16", 170.0, 5.0),
    ("user_annotation", "sweep.host_copy", 175.0, 20.0),
    ("kernel", "sm90_xmma_fprop_implicit_gemm_bf16", 195.0, 5.0),
]


def _trace(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": c, "name": n, "ts": ts, "dur": dur}
        for c, n, ts, dur in events]}))
    return trace.load(str(path))


def _read(t) -> dict:
    ctx = harness.LayerContext(t, {}, {}, {}, "NVIDIA H100 80GB HBM3")
    return {n: harness.load_reader(harness.DATA, n).read(ctx)
            for n in READERS + ("device_idle.train2d",)}


def test_the_feed_readers(tmp_path):
    t = _trace(tmp_path, TRAIN)
    got = _read(t)
    # idle 10..30, 45..46 and 60..80
    assert got["device_idle.train2d"] == pytest.approx(41.0)
    # the card waits on the feed over 10..30 (the copy at 28.5 ends the
    # gap), less the 12-us staging wait; the gap inside the launched
    # replay and the one under the log sync are not the feed's
    assert got["feed_idle.train2d"] == got["feed_idle.train3d"] \
        == pytest.approx(8.0)
    assert got["host_copy_share.sweep"] is None
    # the idle gaps are named by the innermost span or call
    idle = dict(t.breakdown()["idle_gaps"])
    assert idle["cudaEventSynchronize"] == pytest.approx(20e-6)
    assert idle["train.log_sync"] == pytest.approx(20e-6)
    assert idle["cudaGraphLaunch"] == pytest.approx(1e-6)


def test_feed_idle_leaves_out_the_staging_wait(tmp_path):
    # the same chunk with the wait's sync ending the gap, and no copy
    # after it: the card waits on the device's own work, not the feed
    rows = [e for e in TRAIN if e[1] != "cudaMemcpyAsync"]
    assert _read(_trace(tmp_path, rows))["feed_idle.train2d"] == 0.0


@pytest.mark.parametrize("xs, ys, want", [
    ([(0, 10)], [(2, 3), (5, 7)], [(0, 2), (3, 5), (7, 10)]),
    ([(0, 4), (6, 10)], [(3, 7)], [(0, 3), (7, 10)]),
    ([(0, 4), (6, 10)], [(-1, 20)], []),
    ([(0, 4)], [], [(0, 4)]),
])
def test_interval_difference(xs, ys, want):
    assert spans.minus(xs, ys) == want
    assert spans.both(xs, want) == want


def test_the_host_copy_reader(tmp_path):
    t = _trace(tmp_path, SWEEP)
    got = _read(t)
    assert got["host_copy_share.sweep"] == pytest.approx(40.0)
    assert got["feed_idle.train2d"] is None
    gaps = t.breakdown()["idle_gaps"]
    assert gaps[0][0] == "sweep.host_copy"
    assert gaps[0][1] == pytest.approx(40e-6)


def test_spans_clipped_to_the_window(tmp_path):
    # a host copy that began before the annotated window counts from its
    # start only
    t = _trace(tmp_path, SWEEP + [("user_annotation", "sweep.host_copy",
                                   90.0, 20.0)])
    assert _read(t)["host_copy_share.sweep"] == pytest.approx(50.0)


@pytest.mark.parametrize("events", [TRAIN, SWEEP])
def test_each_reads_none_without_spans(tmp_path, events):
    bare = [e for e in events if not e[1].startswith(("train.", "sweep."))]
    got = _read(_trace(tmp_path, bare))
    assert all(got[n] is None for n in READERS)


def test_a_trace_without_device_rows_reads_none(tmp_path):
    # a CPU run's trace: spans, but nothing ran on a card
    host = [e for e in TRAIN + SWEEP if e[0] == "user_annotation"]
    got = _read(_trace(tmp_path, host))
    assert all(got[n] is None for n in READERS)
