"""Reading a ``torch.profiler`` Chrome trace: the window, the device's busy
time, its rows in the benchmark's groups, and the host's idle gaps.

Device rows are the trace's ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
events.  The window is the ``user_annotation`` named ``bench.window`` where
the benchmark opened one; a trace the program wrote itself (the trainer's
``--profile_steps``) has none, and its window runs from its first event to
its last.  Times are in seconds.
"""

from __future__ import annotations

import heapq
import json
import re
from dataclasses import dataclass, field

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")

# The benchmark's groups of device rows, first match wins.
GROUPS = [
    ("fd_kernels", r"\b(curl|jacobian)(2d|3d)(_bwd)?_kernel"),
    ("conv_wgrad", r"wgrad"),
    ("conv_dgrad", r"dgrad"),
    ("conv_fprop", r"fprop|implicit_convolve|winograd|conv2d|conv3d"),
    ("layout_transpose", r"nchwToNhwc|nhwcToNchw|transpose"),
    ("optimizer", r"multi_tensor_apply|[Aa]dam"),
    ("matmul", r"gemm|cublas|cutlass"),
    ("activation", r"leaky_relu|where_kernel|threshold"),
    ("bias_add", r"CUDAFunctor_add|AddFunctor|add_kernel"),
    ("cast_copy", r"copy_kernel|direct_copy|_to_copy|cast"),
    ("reduce", r"reduce_kernel|[Rr]educe"),
    ("upsample_gather", r"index|gather|repeat|upsample"),
    ("elementwise_other", r"elementwise"),
]
_GROUPS = [(g, re.compile(p)) for g, p in GROUPS]


def group_of(name: str, cat: str) -> str:
    """The group of a device row."""
    if cat == "gpu_memcpy":
        m = re.search(r"(HtoD|DtoH|DtoD|HtoH|PtoP)", name)
        return f"copy_{m.group(1) if m else 'other'}"
    if cat == "gpu_memset":
        return "memset"
    for g, pat in _GROUPS:
        if pat.search(name):
            return g
    return "other_kernels"


@dataclass
class Row:
    t0: float
    t1: float
    name: str
    cat: str


@dataclass
class Trace:
    window: tuple[float, float]
    device: list[Row] = field(default_factory=list)
    host: list[Row] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def rows(self, cat: str | None = None) -> list[Row]:
        """Device rows that start inside the window (of ``cat``)."""
        w0, w1 = self.window
        return [r for r in self.device if w0 <= r.t0 <= w1
                and (cat is None or r.cat == cat)]

    def busy(self) -> list[tuple[float, float]]:
        """The union of device rows, clipped to the window, in order."""
        w0, w1 = self.window
        spans = sorted((max(r.t0, w0), min(r.t1, w1)) for r in self.device
                       if r.t1 > w0 and r.t0 < w1)
        out: list[list[float]] = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def gaps(self) -> list[tuple[float, float]]:
        """The intervals of the window in which nothing ran on the
        device."""
        w0, w1 = self.window
        out, at = [], w0
        for a, b in self.busy():
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if w1 > at:
            out.append((at, w1))
        return out

    def host_at(self, times: list[float]) -> list[str]:
        """The innermost (shortest) host event running at each of
        ``times``, the window's own annotation aside: one sweep over the
        events in time, holding the running ones by length."""
        events = sorted((r for r in self.host if r.name != WINDOW),
                        key=lambda r: r.t0)
        out = ["host (no traced op)"] * len(times)
        running: list[tuple[float, int]] = []
        i = 0
        for q in sorted(range(len(times)), key=times.__getitem__):
            t = times[q]
            while i < len(events) and events[i].t0 <= t:
                heapq.heappush(running, (events[i].t1 - events[i].t0, i))
                i += 1
            while running and events[running[0][1]].t1 < t:
                heapq.heappop(running)
            if running:
                out[q] = events[running[0][1]].name
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device groups that took most time and the idle gaps' time
        by what the host was doing, in seconds."""
        ops: dict[str, float] = {}
        w0, w1 = self.window
        for r in self.device:
            if r.t1 > w0 and r.t0 < w1:
                g = group_of(r.name, r.cat)
                ops[g] = ops.get(g, 0.0) + min(r.t1, w1) - max(r.t0, w0)
        idle: dict[str, float] = {}
        gaps = self.gaps()
        for (a, b), name in zip(gaps, self.host_at(
                [0.5 * (a + b) for a, b in gaps])):
            idle[name] = idle.get(name, 0.0) + (b - a)

        def best(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(ops), "idle_gaps": best(idle)}


def load(path: str) -> Trace:
    """Read a Chrome trace written by ``torch.profiler``."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    device, host, window = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        t0 = float(e["ts"]) * 1e-6
        row = Row(t0, t0 + float(e["dur"]) * 1e-6, str(e.get("name", "")),
                  str(e.get("cat", "")))
        if row.cat in DEVICE_CATS:
            device.append(row)
        elif row.cat in HOST_CATS:
            host.append(row)
            if row.cat == "user_annotation" and row.name == WINDOW:
                window = (row.t0, row.t1)
    if window is None:
        every = device + host
        if not every:
            raise ValueError(f"{path}: the trace holds no event")
        window = (min(r.t0 for r in every), max(r.t1 for r in every))
    return Trace(window, device, host)
