"""Optimizer, LR schedule and gradient clipping of the port.

Counterpart of :mod:`deepfluids_tpu.train.state`: Adam (b1 = ``--beta1``,
b2 = ``--beta2``, eps 1e-8) with the reference's cosine decay

    lr(s) = lr_min + 0.5 * (lr_max - lr_min) * (1 + cos(pi * s / S)),

s clamped at S = max_step, and optional global-norm clipping.  As in optax,
the schedule is driven by the optimizer's update count: the first update
uses lr(0).  The caller sets the learning rate before each update
(:func:`set_lr`).

On a CUDA card the one-card trainer's Adam is ``capturable`` and reads its
learning rate from a device tensor (:func:`make_optimizer` with ``lr``), so
its updates can be captured into a CUDA graph; the rate of each step comes
from :func:`cosine_lr_table`.  Such an optimizer's ``state_dict`` is saved
in the plain one's form (:func:`portable_optimizer_state`), so checkpoints
move between the two.
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


def cosine_lr_table(lr_max: float, lr_min: float,
                    max_step: int) -> np.ndarray:
    """``[max_step + 1]`` float32: the value of
    :func:`cosine_lr_schedule` at every step from 0 to ``max_step``, bit for
    bit (the same float32 operations, on an array); :func:`lr_rows` clamps
    past its end as the schedule does."""
    f32 = np.float32
    half_span = f32(0.5 * (lr_max - lr_min))
    s = np.arange(max_step + 1, dtype=f32)
    return f32(lr_min) + half_span * (
        f32(1.0) + np.cos(f32(np.pi) * s / f32(max_step)))


def lr_rows(table: np.ndarray, step: int, k: int) -> np.ndarray:
    """``[k]`` float32: the rates of the updates ``step .. step + k - 1``
    (the updates done before each), clamped at the table's end."""
    return table[np.minimum(np.arange(step, step + k), len(table) - 1)]


def make_optimizer(params: Iterable[torch.nn.Parameter], beta1: float = 0.5,
                   beta2: float = 0.999,
                   lr: torch.Tensor | None = None) -> torch.optim.Adam:
    """Adam as optax builds it; the learning rate is set per update.  With
    ``lr``, a 0-d float32 tensor on the parameters' CUDA device, the
    optimizer is ``capturable`` and reads its rate from that tensor: its
    bias corrections are taken on the device in float32 (the plain one
    takes them in Python's double), and a CUDA graph can capture its
    update."""
    if lr is None:
        return torch.optim.Adam(params, lr=0.0, betas=(beta1, beta2),
                                eps=ADAM_EPS)
    return torch.optim.Adam(params, lr=lr, betas=(beta1, beta2),
                            eps=ADAM_EPS, capturable=True)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    """The rate of the next update, a float or a 0-d tensor: a
    capturable optimizer's rate tensor takes it by ``copy_`` / ``fill_``
    (no host sync); a plain optimizer takes it as a float."""
    for group in opt.param_groups:
        if not isinstance(group["lr"], torch.Tensor):
            group["lr"] = float(lr)
        elif isinstance(lr, torch.Tensor):
            group["lr"].copy_(lr)
        else:
            group["lr"].fill_(lr)


def portable_optimizer_state(sd: dict) -> dict:
    """An Adam ``state_dict`` in the plain optimizer's form: each group's
    rate a float and ``capturable`` off, each ``step`` a float32 scalar on
    the CPU.  The checkpoint format of every run, so a checkpoint written
    by a capturable optimizer resumes a plain one and the other way
    round."""
    groups = [{**g, "lr": float(g["lr"]), "capturable": False}
              for g in sd["param_groups"]]
    state = {i: {k: v.detach().to("cpu", torch.float32) if k == "step"
                 else v for k, v in s.items()}
             for i, s in sd["state"].items()}
    return {**sd, "param_groups": groups, "state": state}


def load_optimizer_state_(opt: torch.optim.Adam, sd: dict) -> None:
    """``opt.load_state_dict(sd)`` that keeps ``opt``'s own rate tensor and
    ``capturable`` flag (``load_state_dict`` takes the saved groups'), with
    a capturable optimizer's ``step`` counts moved to their parameters'
    device, as float32, and each moment laid out in memory as its
    parameter is (a checkpoint may hold another layout), which keeps the
    update on the foreach path.  The state's tensors are new: a CUDA graph
    that captured the old ones must be captured again."""
    own = [(g["lr"], g["capturable"]) for g in opt.param_groups]
    opt.load_state_dict(sd)
    for group, (lr, capturable) in zip(opt.param_groups, own):
        group["lr"], group["capturable"] = lr, capturable
        for p in group["params"]:
            st = opt.state.get(p, {})
            for k, v in st.items():
                if v.shape == p.shape and v.stride() != p.stride():
                    st[k] = torch.empty_like(p, dtype=v.dtype).copy_(v)
            if capturable and "step" in st:
                st["step"] = st["step"].to(p.device, torch.float32)


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
