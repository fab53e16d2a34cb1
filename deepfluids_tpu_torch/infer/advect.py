"""On-device density rendering: semi-Lagrangian advection through generated
velocity sequences.

Counterpart of :mod:`deepfluids_tpu.infer.advect`.  Rendering an advected
smoke density through the GENERATED velocities is the visual check that
the learned fields actually transport like the simulator's.  The frame
loop runs on the device the velocities lie on, with the scenes as a leading
axis; velocities can come straight from the generator on the card, with no
host transfer until the final density frames are fetched.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from deepfluids_tpu_torch.datagen.grids import (advect2d, advect3d,
                                                resolve_device)
from deepfluids_tpu_torch.datagen.smoke2d import _source_mask


@torch.no_grad()
def advect_density(vel_seq: torch.Tensor, rho0: torch.Tensor,
                   source: torch.Tensor | None = None,
                   dt: float = 1.0, inject: bool = True) -> torch.Tensor:
    """Advect a density field through a velocity sequence.

    Args:
      vel_seq: ``[T, H, W, 2]`` or ``[T, D, H, W, 3]`` velocity frames in
        GRID units per step (denormalized); with a leading scene axis,
        ``[S, T, ...]``, every scene is advected at once.
      rho0: initial density ``[H, W]`` / ``[D, H, W]`` (``[S, ...]``).
      source: optional per-step inflow mask added before advection (same
        shape as rho0); None -> no injection.
      inject: whether to add `source` each step.
    Returns:
      ``[T, ...]`` (``[S, T, ...]``) density frames (after each step).
    """
    nd = vel_seq.shape[-1]
    advect = advect2d if nd == 2 else advect3d
    batched = vel_seq.dim() == nd + 3
    t_axis = 1 if batched else 0
    frames = torch.empty(vel_seq.shape[:-1], dtype=rho0.dtype,
                         device=vel_seq.device)
    rho = rho0
    for f in range(vel_seq.shape[t_axis]):
        # Inject BEFORE advecting: same ordering as the simulator's frame
        # loop (datagen.smoke2d.step), so rendered frames line up with d/.
        if inject and source is not None:
            rho = (rho + source).clamp(0.0, 1.0)
        rho = advect(rho, vel_seq.select(t_axis, f), dt)
        frames.select(t_axis, f).copy_(rho)
    return frames


@torch.no_grad()
def render_density_sweep(
    generate_fn: Callable[[torch.Tensor], torch.Tensor],
    manifest,
    scene_params: np.ndarray,
    num_frames: int,
    dt: float = 1.0,
    source_rate: float = 1.0,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Generate a scene's velocity trajectory and advect smoke through it,
    for every scene at once, all on the device.

    Args:
      generate_fn: ``p_norm [B, P] (a tensor on the device) -> velocity
        [B, H, W, 2]`` (normalized units; curl applied), such as a
        trainer's ``apply``.
      scene_params: [S, num_param-1] raw non-frame parameters per scene.
      num_frames: frames per scene.
      device: where to run; the card when None.
    Returns:
      densities [S, T, H, W] (numpy, host).
    """
    if len(manifest.resolution) != 2:
        raise ValueError(
            "render_density_sweep is 2D-only (advect_density itself "
            f"handles 3D); got resolution {manifest.resolution}")
    if manifest.num_param - 1 != 2:
        raise ValueError(
            "render_density_sweep interprets the two non-frame params as "
            "(source x-position, source radius) for its source mask; got "
            f"{manifest.num_param - 1} non-frame params "
            f"({manifest.param_names[:-1]})")
    device = resolve_device(device)
    scene_params = np.asarray(scene_params)
    s = scene_params.shape[0]
    frames = np.arange(num_frames, dtype=np.float32)
    # [S, T, P] raw params
    raw = np.concatenate([
        np.repeat(scene_params[:, None, :], num_frames, axis=1),
        np.repeat(frames[None, :, None], s, axis=0)], axis=-1)
    p_norm = torch.as_tensor(manifest.normalize_params(raw)).to(device)

    h, w = manifest.resolution
    # [S, T, H, W, 2], grid units
    vel = torch.stack([generate_fn(p_seq).float() for p_seq in p_norm]
                      ) * manifest.v_scale
    # Same source geometry AND injection rate as the simulator
    # (datagen.smoke2d: pos_y=0.08, rho += source_rate*mask before
    # advection), so the rendered density is directly comparable to the
    # dataset's d/ frames.  Pass the dataset's Smoke2DConfig.source_rate.
    pos = torch.as_tensor(scene_params[:, 0], dtype=torch.float32).to(device)
    rad = (torch.as_tensor(scene_params[:, 1], dtype=torch.float32).to(device)
           if scene_params.shape[1] > 1
           else torch.full((s,), 0.08, device=device))
    src = source_rate * _source_mask(h, w, pos, rad, 0.08)
    rho0 = torch.zeros((s, h, w), dtype=torch.float32, device=device)
    return advect_density(vel, rho0, src, dt=dt).cpu().numpy()
