"""The numbers that decide ``correct``: what the timed path produced against
the reference's answer to the same inputs.

Training (the first steps of the object the window then drives):

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: over the leaves, the gap between the norms of the first
  gradient (the program's worked out from its optimizer's state after one
  step), over the larger of the reference's norm of that leaf and of the
  median leaf;
* ``update_gap``: the same of the parameters' change over the checked
  steps;
* ``moment1_gap``, ``moment2_gap``: the same of Adam's first and second
  moments (``exp_avg``, ``exp_avg_sq``) after the last checked step.  The
  last step is the first replay of the program's CUDA graph, and the
  moments hold its gradient without Adam's normalization (with beta1 0.5
  it is half of the first moment), which the change of the parameters
  divides out.

Leaves whose first gradient in the reference is under a thousandth of the
median leaf's (nought up to rounding, such as the last bias, which the
curl cancels) are left out of both gaps: Adam moves them by round-off.

Fields (the sweep): ``field_l2``, the largest
over the compared fields of ``|f - f_ref| / |f_ref|`` (L2 norms).
"""

from __future__ import annotations

import math
from statistics import median

import torch

ROUNDING_ONLY = 1e-3


def worst(values) -> float:
    """The largest of ``values``; infinite where one is not finite (a
    NaN never hides behind a larger number)."""
    values = list(values)
    if not all(math.isfinite(v) for v in values):
        return math.inf
    return max(values)


def leaf_norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def _leaf_gap(obs: dict[str, float], ref: dict[str, float],
              keep: list[str]) -> float:
    mid = median(ref[k] for k in keep)
    return worst(abs(obs[k] - ref[k]) / max(ref[k], mid) for k in keep)


def train_numbers(obs: dict, ref: dict) -> dict[str, float]:
    """``obs`` and ``ref`` each hold ``losses`` ({step: loss}), ``grad``
    (first-gradient norms by leaf), ``update`` (norms of the change by
    leaf), ``m`` and ``v`` (norms of Adam's moments by leaf)."""
    gmid = median(ref["grad"].values())
    keep = [k for k, g in ref["grad"].items() if g >= ROUNDING_ONLY * gmid]
    loss = worst(abs(v - ref["losses"][s]) / abs(ref["losses"][s])
                 for s, v in obs["losses"].items())
    return {"loss_gap": loss,
            "grad_gap": _leaf_gap(obs["grad"], ref["grad"], keep),
            "update_gap": _leaf_gap(obs["update"], ref["update"], keep),
            "moment1_gap": _leaf_gap(obs["m"], ref["m"], keep),
            "moment2_gap": _leaf_gap(obs["v"], ref["v"], keep)}


def reference_observables(run: dict, start: dict[str, torch.Tensor],
                          steps: list[int]) -> dict:
    """A reference run of ``generator_be.train_steps`` as the observables
    of :func:`train_numbers`."""
    return {"losses": {s: run["losses"][s - 1] for s in steps},
            "grad": leaf_norms(run["first_grad"]),
            "update": leaf_norms({k: run["params"][k] - start[k]
                                  for k in start}),
            "m": leaf_norms(run["m"]), "v": leaf_norms(run["v"])}


def field_numbers(got: torch.Tensor, want: torch.Tensor) -> dict[str, float]:
    """``got`` and ``want`` are ``[N, *field]`` on one device."""
    g, w = got.double().flatten(1), want.double().flatten(1)
    err = torch.linalg.vector_norm(g - w, dim=1) / torch.linalg.vector_norm(
        w, dim=1)
    return {"field_l2": worst(err.tolist())}
