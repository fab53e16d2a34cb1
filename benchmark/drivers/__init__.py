"""The benchmark's drivers: one a kind of traffic, each the general code
that reads a mix's data file and drives the program's entry through a
window.

A driver is built with the configuration and traffic dicts, the seed, the
device and a scratch directory, and has:

* ``setup(seconds)``: the program's set-up and warm-up, everything
  before the first timed operation of a window of ``seconds`` (training
  also takes its first, checked steps; with ``seconds`` None, only what
  the checked answers need);
* ``window(seconds)``: the timed window; returns the end-to-end
  values it measures by name, and with ``trace`` leaves the profiler's
  Chrome trace at ``trace_path``;
* ``attempted``, ``failed``: operations of the window;
* ``work``: what the per-layer readers need of the window's shapes;
* ``release()``: frees the program's state;
* ``observed()`` and ``expected(precision)``: what the timed path produced
  and the reference's answer to the same inputs, which
  :func:`numbers` compares.
"""

from __future__ import annotations

import gc
import importlib

import torch


class Base:
    """What every driver shares: its inputs, the window's account, the
    card's sync and the release of the program's state (``trainer``)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 tmp: str, trace: bool = False):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.tmp, self.trace = tmp, trace
        self.trace_path = None
        self.attempted = self.failed = 0
        self.work: dict = {}
        self.trainer = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self) -> None:
        self.trainer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def driver_class(kind: str):
    """The driver of a traffic kind (``benchmark/drivers/<kind>.py``)."""
    return importlib.import_module(f"benchmark.drivers.{kind}").Driver
