"""A whole run of each cell, past the harness's look for a card (tiny
sizes, the CPU, float32), with the timed path broken underneath:
``correct`` must come out false for every fault the cell can have, and
true for the sound run.  The faults are planted in the measured program:

* ``unchanged``: each optimizer step leaves the parameters as they were;
* ``half_batch``: the loss is the mean over the first half of the batch;
* ``altered``: the curl (the answer, where it is produced) reads 10 %
  high.

One card, so no exchange between cards can be left out.  The CPU runs no
CUDA graph: a fault planted in the graph's replays alone is the card's test
(``test_bench_cuda.py``).
"""

from __future__ import annotations

import pytest
import torch

from benchmark import harness

from conftest import tiny

TRAIN = ["train2d_cache", "train3d_cache"]
SERVE = ["sweep2d_grid"]


def _unchanged(monkeypatch):
    real = torch.optim.Adam.step

    def step(self, *a, **kw):
        keep = [p.detach().clone() for g in self.param_groups
                for p in g["params"]]
        out = real(self, *a, **kw)
        with torch.no_grad():
            for p, k in zip((p for g in self.param_groups
                             for p in g["params"]), keep):
                p.copy_(k)
        return out
    monkeypatch.setattr(torch.optim.Adam, "step", step)


def _half_batch(monkeypatch):
    from deepfluids_tpu_torch.train import losses

    real = losses.generator_loss

    def loss(net_out, x, *a, **kw):
        n = x.shape[0] // 2
        return real(net_out[:n], x[:n], *a, **kw)
    monkeypatch.setattr(losses, "generator_loss", loss)


def _altered(monkeypatch):
    from deepfluids_tpu_torch.ops import cuda_fd

    for name in ("curl2d_p", "curl3d_p"):
        real = getattr(cuda_fd, name)
        monkeypatch.setattr(cuda_fd, name,
                            lambda x, real=real: real(x) * 1.1)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "altered": _altered}
CASES = ([(w, f) for w in TRAIN for f in (None, *FAULTS)]
         + [(w, f) for w in SERVE for f in (None, "altered")])


@pytest.mark.parametrize("workload,fault", CASES)
def test_correct_sees_the_fault(workload, fault, monkeypatch):
    if fault is not None:
        FAULTS[fault](monkeypatch)
    out = harness.run_cell(workload, 2**31 + 1234, 0.3, False,
                           device="cpu", overrides={
                               **tiny(workload), "compute_dtype": "float32"})
    failed = [k for k, c in out["checks"].items()
              if not c["value"] <= c["limit"]]
    assert out["correct"] is (fault is None), out["checks"]
    assert bool(failed) is (fault is not None)
