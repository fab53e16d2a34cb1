"""Sweep traffic: ``sweep_on_device(trainer.apply, manifest, grid)`` over
the configuration's whole published parameter grid (every scene, every
frame), whole sweeps back to back into host memory.  The rate is the
fields of all sweeps over their time; the last sweep may end after
``--seconds``.

Set-up builds a serving ``Trainer`` with the benchmark's weights and runs
one sweep.  After each sweep of the window the fields of ``sample`` rows
drawn from the seed are kept; ``correct`` compares them with the
reference's fields of the same raw parameters.

Traffic keys: ``batch_size``, ``sample`` (fields kept a sweep),
``trace_sweep`` (the index of the sweep traced with ``--trace 1``).
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from benchmark import compare, flops, port, profiling, references, synth
from benchmark.drivers import Base


def serving_trainer(cfg: dict, seed: int, device, tmp: str):
    """A serving ``Trainer`` over a dataset that names the configuration's
    space (one field), and its weights' host copy."""
    shape = tuple(cfg["resolution"]) + (cfg["num_channels"],)
    one = np.zeros((1,) + shape, np.float32)
    params = synth.param_grid(cfg, cfg["num_frames"])[:1]
    data = port.write_dataset(os.path.join(tmp, "data"), cfg, one, params,
                              np.zeros(1, np.int64), cfg["num_frames"])
    weights = synth.weights(references.load(cfg["reference"]).param_shapes(
        cfg), seed, device)
    start = {k: v.cpu() for k, v in weights.items()}
    t = port.trainer(cfg, {}, data, os.path.join(tmp, "run"), seed, device,
                     weights, is_train=False)
    return t, start


class Driver(Base):
    def setup(self, seconds: float | None = None) -> None:
        from deepfluids_tpu_torch.infer.sweep import sweep_on_device

        self.sweep_on_device = sweep_on_device
        self.trainer, self.start = serving_trainer(self.cfg, self.seed,
                                                   self.device, self.tmp)
        self.grid = synth.param_grid(self.cfg, self.cfg["num_frames"])
        self.rng = np.random.default_rng(synth.stream_seed(self.seed, 1))
        self.kept_p, self.kept_f = [], []
        self._sweep()

    def _sweep(self) -> np.ndarray:
        t = self.trainer
        return self.sweep_on_device(t.apply, t.manifest, self.grid,
                                    batch_size=self.traffic["batch_size"],
                                    device=self.device)

    def keep(self, fields: np.ndarray, count: int) -> None:
        rows = self.rng.choice(len(self.grid), size=min(count, len(self.grid)),
                               replace=False)
        self.kept_p.append(self.grid[rows])
        self.kept_f.append(fields[rows].copy())

    def window(self, seconds: float) -> dict:
        n, total, k = len(self.grid), 0.0, 0
        sample = self.traffic["sample"]
        while total < seconds:
            traced = self.trace and k == self.traffic["trace_sweep"]
            with profiling.window(self.device, traced, self.tmp) as prof:
                t0 = time.perf_counter()
                fields = self._sweep()
                total += time.perf_counter() - t0
            if traced:
                self.trace_path = prof.path
            self.keep(fields, sample)
            del fields
            k += 1
        self.attempted = k * n
        self.work = {"fields": n, "flops_per_field":
                     flops.forward_flops(self.cfg),
                     "fd_points": self.traffic["batch_size"]
                     * math.prod(self.cfg["resolution"])}
        return {"fields_per_s": k * n / total}

    def short_window(self, count: int) -> None:
        """One sweep with ``count`` fields kept (the readings of limits)."""
        self.keep(self._sweep(), count)

    def observed(self) -> torch.Tensor:
        return torch.from_numpy(np.concatenate(self.kept_f))

    def expected(self, precision: str = "f32") -> torch.Tensor:
        return reference_fields(self.cfg, self.start,
                                np.concatenate(self.kept_p), self.device,
                                precision)

    @staticmethod
    def numbers(observed: torch.Tensor, expected: torch.Tensor) -> dict:
        return compare.field_numbers(observed.to(expected.device), expected)


@torch.no_grad()
def reference_fields(cfg: dict, start: dict, raw: np.ndarray, device,
                     precision: str, block: int = 64) -> torch.Tensor:
    """The reference's fields in raw units (the serving manifest's
    ``v_range``) of raw parameters ``raw``, in blocks of ``block`` rows."""
    ref = references.load(cfg["reference"])
    v_scale = max(abs(v) for v in cfg["v_range"])
    params = {k: v.to(device) for k, v in start.items()}
    out = []
    for at in range(0, len(raw), block):
        p = synth.normalize(torch.from_numpy(raw[at:at + block]).to(device),
                            cfg)
        out.append(ref.field(params, p, cfg, precision) * v_scale)
    return torch.cat(out)
