"""Reading a Chrome trace: the window, busy and idle time, the groups and
the idle gaps, and the per-layer readers over a hand-made trace."""

from __future__ import annotations

import json

import pytest

from benchmark import harness, trace


def _trace(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": c, "name": n, "ts": ts, "dur": dur}
        for c, n, ts, dur in events]}))
    return trace.load(str(path))


EVENTS = [
    ("user_annotation", "bench.window", 100.0, 100.0),   # 100..200 us
    ("kernel", "spin_kernel", 50.0, 40.0),               # before: not read
    ("kernel", "void curl2d_kernel<float, 4, 1>(float const*)", 110.0,
     10.0),
    ("kernel", "sm90_xmma_fprop_implicit_gemm_bf16", 115.0, 20.0),
    ("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 150.0, 30.0),
    ("kernel", "void jacobian2d_bwd_kernel<float, 2>(float const*)", 190.0,
     20.0),                                              # cut at 200
    ("cpu_op", "aten::copy_", 130.0, 40.0),
    ("cuda_runtime", "cudaMemcpyAsync", 136.0, 2.0),
]


def test_window_busy_and_gaps(tmp_path):
    t = _trace(tmp_path, EVENTS)
    assert t.window_s == pytest.approx(100e-6)
    # busy: 110..135, 150..180, 190..200
    assert t.busy_s == pytest.approx(65e-6)
    assert t.idle_share() == pytest.approx(0.35)
    gaps = t.gaps()
    assert [(round(a * 1e6), round(b * 1e6)) for a, b in gaps] == [
        (100, 110), (135, 150), (180, 190)]
    assert len(t.rows("kernel")) == 3        # the sentinel lies before


def test_breakdown_groups_and_host(tmp_path):
    b = _trace(tmp_path, EVENTS).breakdown()
    ops = dict(b["device_ops"])
    assert ops["copy_DtoH"] == pytest.approx(30e-6)
    assert ops["conv_fprop"] == pytest.approx(20e-6)
    assert ops["fd_kernels"] == pytest.approx(20e-6)   # 10 + 10 in window
    idle = dict(b["idle_gaps"])
    # 135..150 is inside aten::copy_ (130..170); the others have no op
    assert idle["aten::copy_"] == pytest.approx(15e-6)
    assert idle["host (no traced op)"] == pytest.approx(20e-6)


def test_layer_readers(tmp_path):
    t = _trace(tmp_path, EVENTS)
    work = {"fd_points": 1000, "fields": 2, "flops_per_field": 1e6}
    ctx = harness.LayerContext(t, work, {}, {}, "NVIDIA H100 80GB HBM3")
    assert ctx.idle_percent() == pytest.approx(35.0)
    # curl 3 x 1000 x 4 B and jacobian2d_bwd 6 x 1000 x 4 B at 3.35 TB/s
    # over 10 + 20 us of kernels
    want = 100 * (12000 + 24000) / 3.35e12 / 30e-6
    assert ctx.fd_roofline_percent() == pytest.approx(want)
    assert ctx.mfu_percent(2e6) == pytest.approx(100 * 2e6 / 100e-6 / 989e12)
    read = {n: harness.load_reader(harness.DATA, n).read(ctx) for n in (
        "copy_share.sweep", "sweep_mfu")}
    assert read["copy_share.sweep"] == pytest.approx(30.0)
    assert read["sweep_mfu"] == pytest.approx(100 * 2e6 / 100e-6 / 989e12)


def test_a_program_trace_without_annotation_spans_its_events(tmp_path):
    t = _trace(tmp_path, EVENTS[1:])
    assert t.window == pytest.approx((50e-6, 210e-6))
