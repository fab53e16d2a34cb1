"""Benchmark harness of the port: prints ONE JSON line.

Counterpart of the repo root's ``bench.py``: the same keys in the same
order and the same metric, velocity fields a second on one card for the
flagship 2D smoke generator at the reference's 128x96 resolution, curl
applied (:func:`deepfluids_tpu_torch.graft_entry.entry`).  ``vs_baseline``
divides it by a live proxy of the reference's CPU setting: the same model
at batch 1 on the CPU, in a subprocess that sees no card.

    python -m deepfluids_tpu_torch.bench     (the CUDA card; raises without)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

BATCH = 512    # fields a batch
CHUNKS = 16    # batches a timed call
WARMUP = 2
ITERS = 5
CPU_ITERS = 8      # batch-1 forwards a CPU window
CPU_WINDOWS = 5    # windows; the median window's rate is the baseline

# The CPU proxy's rate (fields/s) that `vs_baseline_pinned` divides by, so
# that the ratio moves with the card and not with whoever shares the host:
# the median of the cpu_rate_median of three calls of this module on an
# "NVIDIA H100 80GB HBM3, 700.00 W" machine (7.91, 5.42 and 5.59; 8 host
# cores, whose model lscpu gives as "unknown").  PERF.md, Findings.
CPU_RATE_PINNED = 5.59

# The directory that holds the package: the CPU proxy's working directory.
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _measure(fn, iters: int, warmup: int) -> float:
    """Seconds a call of ``fn``, which returns a host number that depends
    on all of its work (one stream sync a call), after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def run_device_bench(batch: int = BATCH, chunks: int = CHUNKS,
                     iters: int = ITERS, warmup: int = WARMUP,
                     device: str | torch.device | None = None) -> float:
    """Fields a second of :func:`..graft_entry.entry`'s forward over
    ``chunks`` batches of ``batch`` parameter vectors, each batch reduced to
    a sum on the device and added into one device scalar, read back once a
    call."""
    from deepfluids_tpu_torch import graft_entry

    fn, (model, p0) = graft_entry.entry(device)
    chunked = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, size=(chunks, batch, 3)).astype(np.float32)).to(p0.device)

    def call() -> float:
        with torch.inference_mode():
            total = torch.zeros((), device=p0.device)
            for p in chunked:
                total += fn(model, p).sum()
            return total.item()

    return chunks * batch / _measure(call, iters, warmup)


def cpu_windows(iters: int = CPU_ITERS, windows: int = CPU_WINDOWS,
                warmup: int = WARMUP) -> list[float]:
    """The proxy's rates, measured in this process on the CPU: ``windows``
    windows of ``iters`` batch-1 forwards each, after ``warmup``."""
    from deepfluids_tpu_torch import graft_entry

    fn, (model, _) = graft_entry.entry("cpu")
    p = torch.zeros((1, 3))

    def call() -> float:
        with torch.inference_mode():
            return float(fn(model, p).sum())

    for _ in range(warmup):
        call()
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        rates.append(iters / (time.perf_counter() - t0))
    return rates


def run_cpu_baseline(iters: int = CPU_ITERS, windows: int = CPU_WINDOWS,
                     warmup: int = WARMUP) -> list[float]:
    """Batch-1 CPU fields a second (the reference's CPU proxy) from
    :func:`cpu_windows` in a subprocess with no card visible: one rate a
    window; callers take the median, which a window shared with another
    process does not move."""
    code = ("import json; from deepfluids_tpu_torch.bench import "
            f"cpu_windows; print('CPURATES', json.dumps(cpu_windows("
            f"{iters}, {windows}, {warmup})))")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=_ROOT, timeout=900)
    for line in out.stdout.splitlines():
        if line.startswith("CPURATES"):
            return json.loads(line.split(None, 1)[1])
    raise RuntimeError(f"cpu baseline failed: {out.stderr[-800:]}")


def main() -> None:
    # Bound the whole bench: a card whose runtime hangs at start-up gives
    # one clear failure line instead of a silent hang.
    budget = float(os.environ.get("BENCH_TIMEOUT_SECS", "2400"))

    def _abort():
        print(f"bench: no result within {budget:.0f}s — the card's runtime "
              "is likely down (a hang at start-up)", file=sys.stderr)
        os._exit(3)

    killer = threading.Timer(budget, _abort)
    killer.daemon = True
    killer.start()

    fields_per_sec = run_device_bench()
    killer.cancel()
    try:
        cpu_rates = sorted(run_cpu_baseline())
        cpu_rate = float(np.median(cpu_rates))
        vs = fields_per_sec / cpu_rate
    except (RuntimeError, OSError, subprocess.SubprocessError,
            ValueError):
        cpu_rates, cpu_rate, vs = [], None, float("nan")
    try:
        load1 = round(os.getloadavg()[0], 1)  # contention context for the
    except OSError:                           # CPU-proxy number
        load1 = None
    print(json.dumps({
        "metric": "2d_velocity_fields_per_sec_per_chip",
        "value": round(fields_per_sec, 1),
        "unit": f"fields/s (128x96, sweep {CHUNKS}x{BATCH}, curl applied)",
        "vs_baseline": round(vs, 1) if vs == vs else None,
        "vs_baseline_pinned": round(fields_per_sec / CPU_RATE_PINNED, 1),
        "cpu_rate_pinned": CPU_RATE_PINNED,
        "device_rate": round(fields_per_sec, 1),
        "cpu_rate_median": round(cpu_rate, 2) if cpu_rate else None,
        "cpu_rates": [round(r, 2) for r in cpu_rates],
        "loadavg_1m": load1,
    }), flush=True)


if __name__ == "__main__":
    main()
