"""Readings the limits of ``correct`` are set from, for the autoencoder's
training cell (traffic kind ``train_ae``), on the card:

    python3 -m benchmark.calibrate_ae --workload train_mov_ae \
        --seeds 1,2,3 [--controls 3]

The readings of :mod:`benchmark.calibrate`, which reads the faults of
half the batch for the kind ``train`` alone: for every seed the program's
numbers from its first, checked steps (all six of the driver's
``readings``, of which ``correct`` compares three); for the first ``--controls``
seeds also the control (the reference in float8), half the batch left out
of the reference's loss at every step (``fault_half_batch``) and at the
third alone (``fault_half_batch_step3``), and half the batch left out of
the program's graph replays (``planted_graph_half_batch``,
:func:`benchmark.faults.graph_half_batch`).  One JSON line a reading.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import calibrate, faults, harness


def readings(workload: str, seed: int, control: bool, device: str = "cuda",
             overrides: dict | None = None,
             root: str = harness.DATA) -> list[dict]:
    """The program's numbers for ``seed`` and, with ``control``, the
    control's and the faults'."""
    spec = harness.load_spec()
    cell = harness.named(spec["workloads"], workload, "workload")
    cfg = {**harness.data_file(root, "configs", cell["config"]),
           **(overrides or {})}
    traffic = harness.data_file(root, "traffic", cell["traffic"])
    kind = traffic["kind"]
    d = calibrate._observed(kind, cfg, traffic, seed, device, 0)
    variants = {"program": d.observed()}
    if control:
        with faults.graph_half_batch():
            variants["planted_graph_half_batch"] = calibrate._observed(
                kind, cfg, traffic, seed, device, 0).observed()
    with harness.no_tf32():
        ref = d.expected("f32")
        if control:
            variants["control_fp8"] = d.expected("fp8")
            variants["fault_half_batch"] = d.expected(
                "f32", half_batch=(1, 2, 3))
            variants["fault_half_batch_step3"] = d.expected(
                "f32", half_batch=(3,))
        return [{"workload": workload, "seed": seed, "variant": name,
                 **d.readings(got, ref)} for name, got in variants.items()]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate_ae")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--controls", type=int, default=3,
                    help="the first seeds that also read the control and "
                    "the faults")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        for line in readings(args.workload, seed, i < args.controls):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
