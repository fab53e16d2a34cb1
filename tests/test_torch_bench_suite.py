"""The port's ``bench_suite``: every surface runs at cut shapes on the CPU.

The seven surfaces of ``deepfluids_tpu_torch.tools.bench_suite`` are the
JAX package's (``tools/bench_suite.py``) at the same default shapes; here
each runs through its real code path at a few layers and narrow widths with
``device="cpu"`` and must return a well-formed record with zero kernel
launches (a CPU tensor takes the plain ops).  Their times mean nothing here
and none is kept.
"""

import inspect
import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools import bench_suite as j_bench  # noqa: E402

from deepfluids_tpu_torch.ops import cuda_fd  # noqa: E402
from deepfluids_tpu_torch.tools import bench_suite  # noqa: E402

SMALL2 = dict(res=(16, 12), filters=8, num_conv=1, dtype="float32")
SMALL3 = dict(res=(4, 8, 8), filters=8, num_conv=1, dtype="float32")
# surface -> (cut shapes, units of work a call at those shapes)
CUTS = {
    "infer2d": (dict(chunks=2, batch=4, iters=2, warmup=1, **SMALL2), 8),
    "infer3d": (dict(chunks=2, batch=2, iters=2, warmup=1, **SMALL3), 4),
    "train2d": (dict(batch=2, steps=3, iters=2, warmup=1, **SMALL2), 3),
    "train3d": (dict(batch=2, steps=2, iters=2, warmup=1, **SMALL3), 2),
    "rollout": (dict(frames=6, batch=3, hidden=16, iters=2, warmup=1), 15),
    "rollout_decode": (dict(frames=6, batch=2, hidden=16, iters=2, warmup=1,
                            **SMALL2), 10),
    "e2e_sweep2d": (dict(counts=(2, 2), num_frames=3, batch=4, **SMALL2),
                    12),
}


def test_surfaces_are_the_originals():
    assert list(bench_suite.BENCHES) == list(j_bench.BENCHES)


@pytest.mark.parametrize("name", list(CUTS))
def test_surface_runs_on_the_cpu(name, tmp_path):
    kw, units = CUTS[name]
    out = tmp_path / "bench.jsonl"
    before = dict(cuda_fd.launch_counts)
    rec = bench_suite.run(name, "cpu", str(out), **kw)
    assert cuda_fd.launch_counts == before and rec["launches"] == {}
    with open(out) as f:
        assert json.loads(f.read().strip()) == rec
    assert rec["surface"] == name
    assert rec["metric"].endswith("_per_sec") and rec["detail"]
    secs = rec["seconds_per_call"]
    assert len(secs) == kw.get("iters", 1) and min(secs) > 0
    # the rate is the work of a call over the mean of its timed calls
    # (the record rounds to 1e-6 s and 0.1 units/s)
    mean = sum(secs) / len(secs)
    assert rec["value"] == pytest.approx(units / mean, rel=1e-2, abs=0.05)
    assert rec["value_min"] <= rec["value"] <= rec["value_max"]
    assert (rec["backend"], rec["device"], rec["power_limit_w"]) == (
        "cpu", "cpu", None)
    if name != "e2e_sweep2d":
        assert rec["tflops_per_sec"] >= 0
        assert rec["flops_counted"] == "convolutions and matmuls"
    assert "mfu_vs_bf16_peak" not in rec      # no share of any peak


@pytest.mark.parametrize("name,defaults", [
    ("infer2d", dict(res=(128, 96), filters=128, num_conv=4, chunks=16,
                     batch=512, dtype="bfloat16")),
    ("infer3d", dict(res=(32, 64, 112), filters=128, num_conv=4, chunks=4,
                     batch=32, dtype="bfloat16")),
    ("train2d", dict(res=(128, 96), filters=128, num_conv=4, batch=8,
                     steps=16, dtype="bfloat16")),
    ("train3d", dict(res=(32, 64, 112), filters=128, num_conv=4, batch=4,
                     steps=4, dtype="bfloat16")),
    ("rollout", dict(frames=200, batch=100, z_num=16, num_param=2,
                     hidden=512, depth=2)),
    ("rollout_decode", dict(frames=200, batch=5, z_num=16, num_param=2,
                            hidden=512, depth=2, res=(128, 96), filters=128,
                            num_conv=4, dtype="bfloat16")),
    ("e2e_sweep2d", dict(res=(128, 96), filters=128, num_conv=4,
                         counts=(21, 5), num_frames=200, batch=128,
                         dtype="bfloat16")),
])
def test_default_shapes_are_the_originals(name, defaults):
    # The shapes tools/bench_suite.py times, as each surface's defaults.
    params = inspect.signature(bench_suite.BENCHES[name]).parameters
    assert {k: params[k].default for k in defaults} == defaults


def test_timeit_counts_launches_per_call():
    calls = []
    secs, launches = bench_suite.timeit(lambda: calls.append(1),
                                        torch.device("cpu"), iters=3,
                                        warmup=2)
    assert len(calls) == 5 and len(secs) == 3 and launches == {}

    def launch():
        cuda_fd.launch_counts["curl2d_fused"] += 2

    try:
        _, launches = bench_suite.timeit(launch, torch.device("cpu"),
                                         iters=4, warmup=1)
        assert launches == {"curl2d_fused": 2}
        turn = iter(range(10))

        def uneven():
            cuda_fd.launch_counts["curl2d_fused"] += next(turn)

        with pytest.raises(AssertionError, match="not a whole number"):
            bench_suite.timeit(uneven, torch.device("cpu"), iters=2,
                               warmup=0)
    finally:
        cuda_fd.reset_launch_counts()


def test_cli_raises_without_a_card_and_refuses_unknown_names():
    with pytest.raises(RuntimeError, match="found none"):
        bench_suite.main(["rollout"])
    with pytest.raises(SystemExit):
        bench_suite.main(["infer4d", "--device", "cpu"])
