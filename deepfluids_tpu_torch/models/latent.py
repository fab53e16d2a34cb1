"""Latent integration network (arch "nn") and its temporal rollout.

Counterpart of :mod:`deepfluids_tpu.models.latent`.  The autoencoder's code
is split as ``z = [p (num_param, supervised) ; z_free]``; a small ELU MLP
predicts the residual update of the free block,

    dz_free_t = T([z_t ; dp_t])              (dp_t = p_{t+1} - p_t)
    z_{t+1}   = [p_{t+1} ; z_free_t + dz_free_t]

and :func:`rollout` advances a code through a parameter trajectory.  JAX
runs the rollout as one ``lax.scan``; here it is a Python loop over the
steps on the device, with ``remat`` through ``torch.utils.checkpoint``.

Submodules carry the Flax names (``fc_{i}``, ``fc_out``), so
:mod:`.weights` maps one onto the other by name.  ``fc_out`` is
zero-initialized (:func:`.generator.flax_init_` keeps it at zero): the
initial rollout is then the identity map, where a random head makes the
first 30-step loss about 120x larger.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

# Mixed into the seed of the --nn_noise stream, as the JAX trainer does.
NOISE_SEED_XOR = 0x6E01


class LatentIntegrator(nn.Module):
    """``[z ; dp]`` -> ``dz_free`` (f32), the residual update of the free
    block.

    Args:
      z_num: full code size (supervised params + free dims).
      num_param: supervised parameter dims at the front of ``z``.
      hidden, depth: width and number of the hidden layers.
      history: codes the input holds (``--nn_history``): ``fc_0`` takes
        ``history * z_num + num_param`` inputs, the width Flax infers from
        the example input.
    """

    def __init__(self, z_num: int = 16, num_param: int = 2,
                 hidden: int = 512, depth: int = 2, history: int = 1):
        super().__init__()
        self.depth = depth
        width = history * z_num + num_param
        for i in range(depth):
            self.add_module(f"fc_{i}", nn.Linear(width, hidden))
            width = hidden
        self.fc_out = nn.Linear(width, z_num - num_param)
        self.fc_out.flax_zero_init = True

    def forward(self, z: torch.Tensor, dp: torch.Tensor) -> torch.Tensor:
        h = torch.cat([z, dp], dim=-1).float()
        for i in range(self.depth):
            h = F.elu(getattr(self, f"fc_{i}")(h))
        return self.fc_out(h)


def noise_generator(seed: int, step: int,
                    device: str | torch.device) -> torch.Generator:
    """The ``--nn_noise`` stream of one train step: a ``torch.Generator`` on
    ``device`` seeded from ``(seed ^ 0x6E01, step)``, a pure function of the
    two, so a resumed run draws the noise the uninterrupted one drew.
    (JAX's ``fold_in`` stream cannot be reproduced in torch.)"""
    state = np.random.SeedSequence(
        [seed ^ NOISE_SEED_XOR, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _noise(noise_std: float, generator: torch.Generator | None, steps: int,
           like: torch.Tensor, n_free: int,
           rows: tuple[int, int] | None = None) -> torch.Tensor | None:
    """``[steps, B, n_free]`` Gaussian noise of std ``noise_std``, or None
    when ``noise_std`` is 0.  ``rows`` ``(global batch, first row)``: the
    noise of the whole global batch is drawn and these B rows kept, so a
    batch split over ranks gets the one-process noise."""
    if noise_std <= 0.0:
        return None
    if generator is None:
        raise ValueError("rollout(noise_std>0) needs a generator")
    b = like.shape[-2]
    total, first = rows or (b, 0)
    return noise_std * torch.randn(
        (steps, total, n_free), generator=generator,
        device=like.device, dtype=like.dtype)[:, first:first + b]


def rollout(apply_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
            z0: torch.Tensor, p_seq: torch.Tensor, num_param: int,
            remat: bool = False, noise_std: float = 0.0,
            generator: torch.Generator | None = None,
            history: int = 1,
            noise_rows: tuple[int, int] | None = None) -> torch.Tensor:
    """Advance a latent code through a parameter trajectory.

    Args:
      apply_fn: ``(z_full, dp) -> dz_free``, e.g. a :class:`LatentIntegrator`.
      z0: ``[B, z_num]`` start codes, or ``[H, B, z_num]`` (the true codes
        of steps 0..H-1) for a history-H integrator.
      p_seq: ``[T, B, num_param]`` normalized parameter trajectory; the
        parameter block of every code is pinned to it.
      remat: recompute each step in the backward pass instead of keeping
        its activations (``torch.utils.checkpoint``).
      noise_std, generator: Gaussian noise added to the carried free block
        before each step (``--nn_noise``, training only), drawn up front
        from ``generator`` as JAX draws it from its key.
      history: H > 1 feeds the integrator ``[z_t ; z_{t-1} ; .. ;
        z_{t-H+1} ; dp_t]`` (:func:`_rollout_history`).
      noise_rows: ``(global batch, first row)`` when these B rows are a
        rank's part of a larger batch (the noise is the global batch's).

    Returns:
      ``[T, B, z_num]``, step 0 included (with history H the first H
      entries are the seed codes).
    """
    if history > 1 or z0.dim() == 3:
        return _rollout_history(apply_fn, z0, p_seq, num_param, history,
                                remat, noise_std, generator, noise_rows)
    z_free = z0[:, num_param:]
    dp_seq = p_seq[1:] - p_seq[:-1]
    eps_seq = _noise(noise_std, generator, dp_seq.shape[0], z_free,
                     z_free.shape[-1], noise_rows)

    def step(z_free, p_cur, dp, eps):
        if eps is not None:
            z_free = z_free + eps     # corrupt the carried state (training)
        z_full = torch.cat([p_cur, z_free], dim=-1)
        return z_free + apply_fn(z_full, dp)

    traj = [torch.cat([p_seq[0], z_free], dim=-1)]
    for t in range(dp_seq.shape[0]):
        args = (z_free, p_seq[t], dp_seq[t],
                None if eps_seq is None else eps_seq[t])
        z_free = (checkpoint(step, *args, use_reentrant=False)
                  if remat and torch.is_grad_enabled() else step(*args))
        traj.append(torch.cat([p_seq[t + 1], z_free], dim=-1))
    return torch.stack(traj)


def _rollout_history(apply_fn, z0, p_seq, num_param, history, remat,
                     noise_std, generator, noise_rows=None):
    """History-H rollout (see :func:`rollout`): carries the last H codes as
    a ``[H, B, z_num]`` window, feeds the integrator the window newest
    first, and advances the free block as the first-order path does."""
    if z0.dim() != 3:
        raise ValueError("rollout(history>1) needs z0 of shape "
                         f"[history, B, z_num]; got {tuple(z0.shape)}")
    h = z0.shape[0]
    if history not in (1, h):
        raise ValueError(f"z0 leading dim {h} != history {history}")
    # The seed codes' parameter blocks are pinned to the trajectory.
    zwin = torch.cat([p_seq[:h], z0[:, :, num_param:]], dim=-1)
    dp_seq = p_seq[h:] - p_seq[h - 1:-1]          # dp_t for t = H-1..T-2
    eps_seq = _noise(noise_std, generator, dp_seq.shape[0], z0,
                     z0.shape[-1] - num_param, noise_rows)

    def step(zwin, dp, p_next, eps):
        z_free = zwin[-1][:, num_param:]
        if eps is not None:
            z_free = z_free + eps     # corrupt the carried state (training)
        z_cur = torch.cat([zwin[-1][:, :num_param], z_free], dim=-1)
        zwin = torch.cat([zwin[:-1], z_cur[None]])
        # [z_t ; z_{t-1} ; ..]: the window newest first, flattened per row.
        z_cat = zwin.flip(0).transpose(0, 1).reshape(zwin.shape[1], -1)
        z_next = torch.cat([p_next, z_free + apply_fn(z_cat, dp)], dim=-1)
        return torch.cat([zwin[1:], z_next[None]]), z_next

    traj = list(zwin)
    for t in range(dp_seq.shape[0]):
        args = (zwin, dp_seq[t], p_seq[h + t],
                None if eps_seq is None else eps_seq[t])
        zwin, z_next = (checkpoint(step, *args, use_reentrant=False)
                        if remat and torch.is_grad_enabled()
                        else step(*args))
        traj.append(z_next)
    return torch.stack(traj)
