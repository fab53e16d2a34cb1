"""Training traffic of the autoencoder (arch ``ae``): the training driver
(:mod:`benchmark.drivers.train`) on a configuration whose ``arch`` is
``ae``, the same ``Trainer.train`` calls, checked steps and window.

It differs in four places:

* the configuration's ``z_num``, ``w3`` and ``ae_pred_w`` join the mix's
  flags (the program's flags of a run), which
  :func:`benchmark.port.trainer` does not pass;
* after the checked steps, set-up has the program reconstruct the checked
  steps' fields by the sample dump's forward (``Trainer.reconstruct``,
  4 fields a call, as an ``ae`` dump takes them) at the seeded weights
  both sides start from, then puts its trained weights back; this also
  warms the dumps of the window;
* ``correct`` compares those reconstructions with the reference's
  forward at the same seeded weights (``field_l2``, as the sweep's
  fields are compared; after three steps the two sides' weights part by
  Adam's sign-like first updates, and the reconstructions by 0.065–0.13,
  too near the float8 control to tell it apart), and leaves out the
  gaps of the first gradient and of Adam's two moments: in the
  autoencoder the program's bfloat16 forward and backward move them as
  far as the float8 control does (the control rounds the forward alone),
  so no reading sets a limit for them.  :meth:`Driver.readings` still
  gives all six numbers;
* the window's FLOPs a step are the autoencoder's
  (:mod:`benchmark.flops_ae`).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import compare, flops_ae, synth
from benchmark.drivers import train

AE_FLAGS = ("z_num", "w3", "ae_pred_w")
DUMP_ROWS = 4
CHECKED = ("loss_gap", "update_gap", "field_l2")


class Driver(train.Driver):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 tmp: str, trace: bool = False):
        flags = {**traffic["flags"], **{k: cfg[k] for k in AE_FLAGS}}
        super().__init__(cfg, {**traffic, "flags": flags}, seed, device,
                         tmp, trace)

    def _fields(self) -> np.ndarray:
        """The checked steps' fields, normalized as the program reads
        them."""
        return np.concatenate([x for _, x in self.batches]) / self.v_scale

    def setup(self, seconds: float | None = None) -> None:
        super().setup(None)
        t, x = self.trainer, self._fields()
        # the dump's forward at the seeded weights both sides start from;
        # then the trained weights go back into the same tensors, which
        # the captured graph reads
        named = dict(t.model.named_parameters())
        trained = {k: p.detach().clone() for k, p in named.items()}
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(self.start[k])
            self.recon = np.concatenate(
                [t.reconstruct(x[i:i + DUMP_ROWS])
                 for i in range(0, len(x), DUMP_ROWS)])
            for k, p in named.items():
                p.copy_(trained[k])
        if seconds is not None:
            self.n = max(2, round(seconds * self.traffic["steps_per_second"]))

    def window(self, seconds: float) -> dict:
        values = super().window(seconds)
        self.work["flops_per_step"] = flops_ae.train_step_flops(
            self.cfg, self.cfg["batch_size"])
        return values

    def observed(self) -> dict:
        return {**super().observed(), "recon": torch.from_numpy(self.recon)}

    def expected(self, precision: str = "f32", half_batch=()) -> dict:
        dev = self.device
        params = {k: v.to(dev) for k, v in self.start.items()}
        batches = [(synth.normalize(torch.from_numpy(p).to(dev), self.cfg),
                    torch.from_numpy(x).to(dev) / self.v_scale)
                   for p, x in self.batches]
        run = self.ref.train_steps(params, batches, self.cfg, precision,
                                   half_batch)
        out = compare.reference_observables(run, params, train.CHECKED_STEPS)
        with torch.no_grad():
            out["recon"] = self.ref.field(
                params, torch.from_numpy(self._fields()).to(dev), self.cfg,
                precision)
        return out

    @staticmethod
    def readings(observed: dict, expected: dict) -> dict:
        """Every number the cell can read: the training cells' five and
        ``field_l2``."""
        want = expected["recon"]
        return {**compare.train_numbers(observed, expected),
                **compare.field_numbers(observed["recon"].to(want.device),
                                        want)}

    @staticmethod
    def numbers(observed: dict, expected: dict) -> dict:
        every = Driver.readings(observed, expected)
        return {k: every[k] for k in CHECKED}
