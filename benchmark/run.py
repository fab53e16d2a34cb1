"""Run one cell of the benchmark once:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository's root, on a machine with the cards the cell asks
for.  It sets up the measured program (``deepfluids_tpu_torch``), warms
it up, measures for ``--seconds`` and checks what the timed path produced
against the plain reference.  Standard error ends with each number
compared beside its limit; the last line of standard output is the result:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` (with
``--trace 1`` also ``busy_s`` and ``window_s``), ``breakdown`` (with
``--trace 1``) and ``checks``.

It exits non-zero and prints no result without a CUDA card (or with fewer
than the cell's), and when JAX or the JAX package was loaded.  Build and
kernel caches live inside the checkout at fixed paths; everything else
goes under ``TMPDIR`` and is removed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".bench_cache")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    spec = harness.load_spec()
    cell = harness.named(spec["workloads"], args.workload, "workload")
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), spec=spec)
    found = harness.foreign_modules(sys.modules)
    if found:
        print(f"loaded {', '.join(found)}: a run of the port may not load "
              "JAX or the JAX package", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
