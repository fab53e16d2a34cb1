"""Training traffic: ``Trainer.train`` on a seeded training set staged on
the device (``--device_data_cache``), at the program's default cadence (a
log sync every 100 steps, a sample dump every 1000, a checkpoint every
5000 and at the end of every call).

Set-up builds one ``Trainer`` and drives it through its first three steps
by the window's own call and feed: ``train(1)`` (the eager warm-up chunk)
and ``train(2)`` (a warm-up chunk and the first CUDA graph replay), over
rows that hold fields that all differ.  Those steps are what ``correct``
compares with the reference: the losses ``train`` reports (steps 1 and 3;
step 2's is not reported off the log cadence), the first gradient from
Adam's state after step 1 (``exp_avg / (1 - beta1)``), and after step 3
(the graph's) the parameters' change and Adam's two moments.  The window
is one ``train(N)`` call of the same object, N = ``--seconds`` x the
mix's ``steps_per_second``: the same work for every seed.

Traffic keys: ``metric`` (the end-to-end metric the window's rate is
reported as), ``flags`` (the program's flags of the mix),
``steps_per_second`` (the steps of the window a second of ``--seconds``),
``trace_steps`` (``[a, b]``: with ``--trace 1`` the program's own
``--profile_steps`` window covers steps ``a + 1 .. b`` of the window
call).
"""

from __future__ import annotations

import glob
import math
import os
import time

import torch

from benchmark import compare, flops, port, references, synth
from benchmark.drivers import Base

CHECKED_STEPS = [1, 3]


def crosses(period: int, start: int, n: int) -> bool:
    """Whether steps ``start + 1 .. start + n`` hold a multiple of
    ``period``."""
    return (start + n) // period > start // period


class Driver(Base):
    def setup(self, seconds: float | None = None) -> None:
        cfg, dev, b = self.cfg, self.device, self.cfg["batch_size"]
        fields, raw = synth.blob_fields(cfg, self.seed, dev)
        rows_of = synth.staged_rows(cfg)
        pool = len(rows_of)
        self.tseed = synth.distinct_rows_seed(self.seed, rows_of, b, 3)
        host, params = fields.cpu().numpy(), raw.cpu().numpy()
        del fields, raw
        self.v_scale = port.v_range(host, cfg)[1]
        rows = [rows_of[synth.batch_rows(self.tseed, s, pool, b)]
                for s in (1, 2, 3)]
        self.batches = [(params[r].copy(), host[r].copy()) for r in rows]
        data = port.write_dataset(os.path.join(self.tmp, "data"), cfg, host,
                                  params, rows_of, cfg["num_frames"])
        del host, params
        self.ref = references.load(cfg["reference"])
        weights = synth.weights(self.ref.param_shapes(cfg), self.seed, dev)
        self.start = {k: v.cpu() for k, v in weights.items()}
        flags = dict(self.traffic["flags"])
        if self.trace:
            # the window call starts after the three checked steps
            a, z = self.traffic["trace_steps"]
            self.traced = (3 + a + 1, 3 + z)
            flags["profile_steps"] = f"{self.traced[0]},{self.traced[1]}"
            flags["profile_dir"] = os.path.join(self.tmp, "profile")
        t = self.trainer = port.trainer(
            cfg, flags, data, os.path.join(self.tmp, "run"), self.tseed, dev,
            weights, is_train=True)
        del weights
        self.losses = {1: t.train(num_steps=1)["loss"]}
        b1 = cfg["beta1"]
        self.grad = compare.leaf_norms(
            {k: t.opt.state[p]["exp_avg"] / (1 - b1)
             for k, p in t.model.named_parameters()})
        self.losses[3] = t.train(num_steps=2)["loss"]
        named = dict(t.model.named_parameters())
        self.update = compare.leaf_norms(
            {k: p.detach() - self.start[k].to(dev) for k, p in named.items()})
        self.m = compare.leaf_norms(
            {k: t.opt.state[p]["exp_avg"] for k, p in named.items()})
        self.v = compare.leaf_norms(
            {k: t.opt.state[p]["exp_avg_sq"] for k, p in named.items()})
        if seconds is None:
            return
        self.n = max(2, round(seconds * self.traffic["steps_per_second"]))
        if crosses(t.c.test_step, t.step, self.n):
            # the sample dump's forward (a batch of 8) runs in the window
            t.generate(torch.zeros((8, cfg["num_param"])).numpy())
            self.sync()

    def window(self, seconds: float) -> dict:
        t, n = self.trainer, self.n
        start = t.step
        self.sync()
        t0 = time.perf_counter()
        t.train(num_steps=n)
        self.sync()
        elapsed = time.perf_counter() - t0
        self.attempted = n
        res = self.cfg["resolution"]
        self.work = {
            "flops_per_step": flops.train_step_flops(self.cfg,
                                                     self.cfg["batch_size"]),
            "fd_points": self.cfg["batch_size"] * math.prod(res)}
        if self.trace:
            found = sorted(glob.glob(os.path.join(self.tmp, "profile",
                                                  "*.trace.json")))
            self.trace_path = found[-1] if found else None
            lo, hi = self.traced
            self.work["steps"] = max(0, min(hi, start + n) - lo + 1)
        return {self.traffic["metric"]: n / elapsed}

    def observed(self) -> dict:
        return {"losses": self.losses, "grad": self.grad,
                "update": self.update, "m": self.m, "v": self.v}

    def expected(self, precision: str = "f32", half_batch=()) -> dict:
        dev = self.device
        params = {k: v.to(dev) for k, v in self.start.items()}
        batches = [(synth.normalize(torch.from_numpy(p).to(dev), self.cfg),
                    torch.from_numpy(x).to(dev) / self.v_scale)
                   for p, x in self.batches]
        run = self.ref.train_steps(params, batches, self.cfg, precision,
                                   half_batch)
        return compare.reference_observables(run, params, CHECKED_STEPS)

    @staticmethod
    def numbers(observed: dict, expected: dict) -> dict:
        return compare.train_numbers(observed, expected)
