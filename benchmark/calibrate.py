"""Readings the limits of ``correct`` are set from, for one cell, on the
card:

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 \
        [--controls 3] [--fields 384]

For every seed it sets the cell up as a run does and reads the numbers
``correct`` compares for the program: training from its first, checked
steps (no window), the sweep from one sweep that keeps ``--fields``
fields.  For the first ``--controls`` seeds it also reads the control,
the reference computed in float8 (the precision below the configuration's
bfloat16) in the program's place, and, for training, the faults of half
the batch left out: in the reference's loss at every step
(``fault_half_batch``) or at the third alone (``fault_half_batch_step3``,
the step the program takes by its CUDA graph), and planted in the program's
graph replays (``planted_graph_half_batch``, :mod:`benchmark.faults`).  A
step that leaves the state unchanged reads 1 on ``update_gap`` by its
definition and needs no run.  One JSON line a reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

import torch

from benchmark import faults, harness
from benchmark.drivers import driver_class


def _observed(kind: str, cfg: dict, traffic: dict, seed: int, device: str,
              fields: int):
    """A driver set up as a run does, the program's state freed."""
    with tempfile.TemporaryDirectory(prefix="dfbench-") as tmp:
        d = driver_class(kind)(cfg, traffic, seed, device, tmp)
        d.setup()
        if hasattr(d, "short_window"):
            d.short_window(fields)
        d.release()
    return d


def readings(workload: str, seed: int, control: bool, fields: int,
             device: str = "cuda", overrides: dict | None = None,
             root: str = harness.DATA) -> list[dict]:
    """The program's numbers for ``seed`` and, with ``control``, the
    control's and the faults'."""
    spec = harness.load_spec()
    cell = harness.named(spec["workloads"], workload, "workload")
    cfg = {**harness.data_file(root, "configs", cell["config"]),
           **(overrides or {})}
    traffic = harness.data_file(root, "traffic", cell["traffic"])
    kind = traffic["kind"]
    d = _observed(kind, cfg, traffic, seed, device, fields)
    variants = {"program": d.observed()}
    if control and kind == "train":
        with faults.graph_half_batch():
            variants["planted_graph_half_batch"] = _observed(
                kind, cfg, traffic, seed, device, fields).observed()
    out = []
    with harness.no_tf32():
        ref = d.expected("f32")
        if control:
            variants["control_fp8"] = d.expected("fp8")
            if kind == "train":
                variants["fault_half_batch"] = d.expected(
                    "f32", half_batch=(1, 2, 3))
                variants["fault_half_batch_step3"] = d.expected(
                    "f32", half_batch=(3,))
        for name, got in variants.items():
            out.append({"workload": workload, "seed": seed,
                        "variant": name, **d.numbers(got, ref)})
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--controls", type=int, default=3,
                    help="the first seeds that also read the control")
    ap.add_argument("--fields", type=int, default=384,
                    help="fields a serving cell compares")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        for line in readings(args.workload, seed, i < args.controls,
                             args.fields):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
