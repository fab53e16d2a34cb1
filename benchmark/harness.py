"""The harness: finds a cell's configuration, traffic, limits and per-layer
readers by name, runs the cell once and builds its result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own under the benchmark's folder:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<mix>.json``: the mix's parameters; its ``kind`` names the
  driver (``drivers/<kind>.py``) that reads them;
* ``limits/<cell>.json``: the limit of each number ``correct`` compares;
* ``layer_metrics/<metric>.py``: a ``read(ctx)`` that returns the
  metric's value, or None where it finds nothing to read.

``BENCHMARK.json`` at the repository's root names the cells and metrics.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import subprocess
import tempfile

import torch

from benchmark import flops
from benchmark import trace as tracemod
from benchmark.drivers import driver_class

DATA = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(DATA)
# Top-level modules a run of the port may not load: JAX and the JAX
# package (``deepfluids_tpu_torch`` is another name).
FOREIGN = ("jax", "jaxlib", "flax", "deepfluids_tpu")


def load_spec(path: str | None = None) -> dict:
    with open(path or os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def named(items: list[dict], name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r}")


def data_file(root: str, kind: str, name: str) -> dict:
    with open(os.path.join(root, kind, f"{name}.json")) as f:
        return json.load(f)


def cell_metrics(spec: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and per-layer metrics a cell reports."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def load_reader(root: str, name: str):
    path = os.path.join(root, "layer_metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_layer_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def foreign_modules(modules) -> list[str]:
    """The names in ``FOREIGN`` that are the top-level name (the part
    before the first dot) of a loaded module, compared whole."""
    return sorted({m.split(".", 1)[0] for m in modules} & set(FOREIGN))


def process_age() -> float:
    """Seconds since this process started, from the kernel's record."""
    with open("/proc/self/stat") as f:
        # fields after the command name, which may hold spaces
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def power_limit_w(device: torch.device) -> float | None:
    """The card's power limit in W as nvidia-smi reads it (a card set
    below 700 W runs slower under load), None where it cannot be read."""
    if device.type != "cuda":
        return None
    ids = [v for v in os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
           if v]
    index = device.index or 0
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", ids[index] if index < len(ids)
             else str(index), "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


@contextlib.contextmanager
def no_tf32():
    """Float32 matmuls and convolutions in float32 (the reference's)."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


class LayerContext:
    """What a per-layer reader reads: the traced window, the driver's
    account of its work, the configuration, the traffic and the card."""

    def __init__(self, trace: tracemod.Trace, work: dict, cfg: dict,
                 traffic: dict, kind: str):
        self.trace, self.work, self.cfg = trace, work, cfg
        self.traffic, self.kind = traffic, kind
        self.peaks = flops.peaks(kind)

    def idle_percent(self) -> float | None:
        """None where nothing ran on the device in the window."""
        if not self.trace.busy():
            return None
        return 100.0 * self.trace.idle_share()

    def mfu_percent(self, total_flops: float) -> float | None:
        if self.peaks is None or not total_flops:
            return None
        return 100.0 * total_flops / self.trace.window_s / (
            self.peaks["bf16_flops"])

    def fd_roofline_percent(self) -> float | None:
        """Sum of the FD launches' bytes bounds over the sum of their device
        times; each launch runs over ``work["fd_points"]`` points."""
        if self.peaks is None:
            return None
        bound = busy = 0.0
        for r in self.trace.rows("kernel"):
            k = flops.fd_kernel(r.name)
            if k is not None:
                bound += flops.fd_bytes(k, self.work["fd_points"],
                                        flops.element_bytes(r.name))
                busy += r.t1 - r.t0
        if not busy:
            return None
        return 100.0 * bound / self.peaks["hbm_bytes_per_s"] / busy


def checked(numbers: dict[str, float], limits: dict) -> dict:
    """Each number beside its limit; a number that is not finite reads
    1e300 (JSON has no NaN or infinity)."""
    return {k: {"value": v if math.isfinite(v) else 1e300,
                "limit": limits[k]["limit"]}
            for k, v in numbers.items()}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", spec: dict | None = None,
             root: str = DATA, overrides: dict | None = None) -> dict:
    """Run one cell once; its result line as a dict (``checks`` last)."""
    spec = spec or load_spec()
    cell = named(spec["workloads"], workload, "workload")
    cfg = {**data_file(root, "configs", cell["config"]), **(overrides or {})}
    traffic = data_file(root, "traffic", cell["traffic"])
    limits = data_file(root, "limits", workload)
    e2e, layer = cell_metrics(spec, workload)
    dev = torch.device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    with tempfile.TemporaryDirectory(prefix="dfbench-") as tmp:
        d = driver_class(traffic["kind"])(cfg, traffic, seed, dev, tmp,
                                          trace)
        d.setup(seconds)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        setup_s = process_age()
        values = d.window(seconds)
        values["setup_s"] = setup_s
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        found = tracemod.load(d.trace_path) if trace and d.trace_path else None
        d.release()
        observed = d.observed()
        with no_tf32():
            numbers = d.numbers(observed, d.expected("f32"))
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": kind, "count": 1, "memory_peak_bytes": int(peak),
                   "power_limit_w": power_limit_w(dev)}
    out = {"correct": all(v <= limits[k]["limit"]
                          for k, v in numbers.items()),
           "attempted": d.attempted, "failed": d.failed}
    if not trace:
        missing = [m["name"] for m in e2e if m["name"] not in values]
        if missing:
            raise KeyError(f"{workload}: the driver measured no {missing}")
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]} for m in e2e}
    else:
        metrics = {}
        if found is not None:
            ctx = LayerContext(found, d.work, cfg, traffic, kind)
            for m in layer:
                v = load_reader(root, m["name"]).read(ctx)
                if v is not None and math.isfinite(v):
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            device_info["busy_s"] = found.busy_s
            device_info["window_s"] = found.window_s
        out["metrics"] = metrics
    out["device"] = device_info
    if trace and found is not None:
        out["breakdown"] = found.breakdown()
    out["checks"] = checked(numbers, limits)
    return out
