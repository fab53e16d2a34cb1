"""Optimizer, LR schedule and gradient clipping of the port.

Counterpart of :mod:`deepfluids_tpu.train.state`: Adam (b1 = ``--beta1``,
b2 = ``--beta2``, eps 1e-8) with the reference's cosine decay

    lr(s) = lr_min + 0.5 * (lr_max - lr_min) * (1 + cos(pi * s / S)),

s clamped at S = max_step, and optional global-norm clipping.  As in optax,
the schedule is driven by the optimizer's update count: the first update
uses lr(0).  The caller sets the learning rate before each update
(:func:`set_lr`).
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

ADAM_EPS = 1e-8


def cosine_lr_schedule(lr_max: float, lr_min: float,
                       max_step: int) -> Callable[[int], float]:
    """The reference's cosine decay, clamped past ``max_step``, evaluated in
    float32 as the JAX schedule is."""
    f32 = np.float32
    half_span = f32(0.5 * (lr_max - lr_min))

    def schedule(step: int) -> float:
        s = f32(min(step, max_step))
        return float(f32(lr_min) + half_span * (
            f32(1.0) + np.cos(f32(np.pi) * s / f32(max_step))))

    return schedule


def make_optimizer(params: Iterable[torch.nn.Parameter], beta1: float = 0.5,
                   beta2: float = 0.999) -> torch.optim.Adam:
    """Adam as optax builds it; the learning rate is set per update."""
    return torch.optim.Adam(params, lr=0.0, betas=(beta1, beta2),
                            eps=ADAM_EPS)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         norm: torch.Tensor | None = None) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place: every gradient becomes
    ``g / norm * max_norm`` when the global norm reaches ``max_norm``, and
    stays as it is below it (no epsilon is added to the norm, unlike
    ``torch.nn.utils.clip_grad_norm_``).  ``norm``: the global norm when
    ``grads`` are a rank's cut of the model's.  Returns the norm; no host
    sync."""
    if norm is None:
        norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm
