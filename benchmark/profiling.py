"""The benchmark's own profiler window: ``torch.profiler`` over CPU and
CUDA activity, opened by a short sentinel kernel (a fresh window can lose
its first device record) and an annotation, ``bench.window``, that marks
the window itself; written as a Chrome trace for :mod:`benchmark.trace`.
"""

from __future__ import annotations

import contextlib
import os

import torch

from benchmark.trace import WINDOW


class Window:
    """``start()`` / ``stop()`` a profiled window; ``path`` is the trace
    written at ``stop``."""

    def __init__(self, device: torch.device, tmp: str):
        self.device, self.tmp = device, tmp
        self.path: str | None = None
        self._prof = self._mark = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self._prof = profile(activities=acts)
        self._prof.start()
        if self.device.type == "cuda":
            torch.cuda._sleep(1000)
        self._sync()
        self._mark = record_function(WINDOW)
        self._mark.__enter__()

    def stop(self) -> None:
        self._sync()
        self._mark.__exit__(None, None, None)
        self._prof.stop()
        self.path = os.path.join(self.tmp, "bench_window.trace.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = self._mark = None


@contextlib.contextmanager
def window(device: torch.device, on: bool, tmp: str):
    """A :class:`Window` around the block when ``on``, else nothing (the
    yielded window's ``path`` stays None)."""
    w = Window(device, tmp)
    if not on:
        yield w
        return
    w.start()
    try:
        yield w
    finally:
        w.stop()
