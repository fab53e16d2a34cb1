"""On the card, at the cell's own size: the autoencoder's program holds the
limits of ``train_mov_ae``, and the control (the reference in float8 in
the program's place) and the faults of half the batch left out fail at
least one of them; half the batch left out in the CUDA graph's replays
alone fails a whole run.  ``python -m pytest benchmark/tests -q -m cuda``
on a machine with an H100; skips without a card."""

from __future__ import annotations

import pytest

from benchmark import calibrate_ae, faults, harness

CELL = "train_mov_ae"


@pytest.mark.cuda
def test_control_and_faults_fail_and_program_holds(card):
    limits = harness.data_file(harness.DATA, "limits", CELL)
    lines = calibrate_ae.readings(CELL, 2**31 + 4099, True)
    assert {line["variant"] for line in lines} == {
        "program", "planted_graph_half_batch", "control_fp8",
        "fault_half_batch", "fault_half_batch_step3"}
    for line in lines:
        over = [k for k in limits if not line[k] <= limits[k]["limit"]]
        if line["variant"] == "program":
            assert not over, line
        else:
            assert over, line


@pytest.mark.cuda
def test_a_fault_in_the_graph_alone_fails_a_run(card):
    """A whole run, window and all: the eager warm-up step is sound, every
    graph replay takes half its batch twice."""
    with faults.graph_half_batch():
        out = harness.run_cell(CELL, 2**31 + 4111, 2.0, False)
    assert out["correct"] is False, out["checks"]
    assert all(m["value"] > 0 for m in out["metrics"].values())
