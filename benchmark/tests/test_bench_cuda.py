"""On the card, at each cell's own size: the program's numbers are within
the cell's limits, and the control (the reference in float8 in the
program's place) and, for training, the faults of half the batch left out
fail at least one of them; half the batch left out in the CUDA graph's
replays alone fails a whole run.  ``python -m pytest benchmark/tests -q
-m cuda`` on a machine with an H100; skips without a card."""

from __future__ import annotations

import pytest

from benchmark import calibrate, faults, harness

TRAIN = ["train2d_cache", "train3d_cache"]
CELLS = TRAIN + ["sweep2d_grid"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_holds(workload, card):
    limits = harness.data_file(harness.DATA, "limits", workload)
    lines = calibrate.readings(workload, 2**31 + 4099, True, 384)
    for line in lines:
        over = [k for k in limits if not line[k] <= limits[k]["limit"]]
        if line["variant"] == "program":
            assert not over, line
        else:
            assert over, line


@pytest.mark.cuda
@pytest.mark.parametrize("workload", TRAIN)
def test_a_fault_in_the_graph_alone_fails_a_run(workload, card):
    """A whole run, window and all: the eager warm-up step is sound, every
    graph replay takes half its batch twice."""
    with faults.graph_half_batch():
        out = harness.run_cell(workload, 2**31 + 4111, 2.0, False)
    assert out["correct"] is False, out["checks"]
    assert all(m["value"] > 0 for m in out["metrics"].values())
