"""3D smoke plume solver (PyTorch; mantaflow smoke3 scene equivalent).

Counterpart of :mod:`deepfluids_tpu.datagen.smoke3d`.  Scene family
smoke3_vel5_buo3_f250: parameters are source inflow velocity and buoyancy
strength; grid 112x64x32 (W x H x D) -> tensors [D, H, W] = [32, 64, 112],
with a leading scene axis.
"""

from __future__ import annotations

import dataclasses

import torch

from deepfluids_tpu_torch.datagen import grids


@dataclasses.dataclass(frozen=True)
class Smoke3DConfig:
    depth: int = 32             # D (z)
    height: int = 64            # H (y)
    width: int = 112            # W (x)
    num_frames: int = 250
    dt: float = 1.0
    source_rate: float = 1.0
    project_iters: int = 40
    projection: str = "jacobi"  # "jacobi" (legacy) | "cg" (converged
                                # reference, solver-consistency study) |
                                # "matched" (discrete Leray projection
                                # onto range(curl3d), datagen/projection.py)
    cg_tol: float = 1e-6
    mg_cycles: int = 16         # V-cycles for projection="matched" (the 3D
                                # curl normal operator is semidefinite,
                                # gauge modes, and converges ~0.7x/cycle
                                # vs 0.15x in 2D, so it needs more cycles)

    def __post_init__(self):
        # Reject typos loudly instead of silently generating off-manifold
        # frames with the legacy Jacobi branch (see Smoke2DConfig).
        if self.projection not in ("jacobi", "cg", "matched"):
            raise ValueError(
                f"projection={self.projection!r}: expected one of "
                "'jacobi', 'cg', 'matched'")


def _source_mask3(d: int, h: int, w: int,
                  device: str | torch.device = "cpu") -> torch.Tensor:
    """Soft spherical source near the bottom center, ``[D, H, W]``."""
    zz = torch.arange(d, dtype=torch.float32, device=device)[:, None, None]
    yy = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    cz, cy, cx = (d - 1) / 2.0, 0.1 * (h - 1), (w - 1) / 2.0
    r = 0.12 * w
    d2 = (zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2
    return (1.0 - torch.sqrt(d2) / r).clamp(0.0, 1.0)


def _step3(state, inflow_vel, buoyancy, mask, cfg: Smoke3DConfig):
    """One solver step (source -> buoyancy -> advect -> project).  state =
    (vel [S,D,H,W,3], rho [S,D,H,W]); inflow_vel and buoyancy broadcast
    against rho (``[S,1,1,1]`` for per-scene values)."""
    vel, rho = state
    rho = (rho + cfg.source_rate * mask).clamp(0.0, 1.0)
    vel = vel.clone()
    # Source inflow: set vertical velocity inside the source.
    vel[..., 1] = vel[..., 1] * (1 - mask) + inflow_vel * mask
    vel[..., 1] += cfg.dt * buoyancy * rho
    vel = grids.wall_bc3d(vel)
    rho = grids.advect3d(rho, vel, cfg.dt)
    vel = grids.advect3d(vel, vel, cfg.dt)
    vel = grids.wall_bc3d(vel)
    if cfg.projection == "matched":
        # Leray projection onto range(curl3d): zero wall through-flow by
        # construction, so no trailing wall_bc (it would knock the frame
        # off the generator manifold).
        from deepfluids_tpu_torch.datagen import projection
        vel = projection.project_curl3d(vel, cycles=cfg.mg_cycles)
    elif cfg.projection == "cg":
        vel = grids.pressure_project3d_cg(vel, tol=cfg.cg_tol)
        vel = grids.wall_bc3d(vel)
    else:
        vel = grids.pressure_project3d(vel, cfg.project_iters)
        vel = grids.wall_bc3d(vel)
    return vel, rho


@torch.no_grad()
def simulate_smoke3d_segment_batch(vel, rho, inflow_vel, buoyancy,
                                   cfg: Smoke3DConfig, num_frames: int):
    """Advance ``num_frames`` steps from (vel [S,D,H,W,3], rho [S,D,H,W])
    for S scenes at once, on the device the state lies on.  Returns (vel,
    rho, vel_traj [S,T,...], rho_traj [S,T,...])."""
    device = vel.device
    inflow_vel = grids.scene_vector(inflow_vel, device)[0].reshape(-1, 1, 1, 1)
    buoyancy = grids.scene_vector(buoyancy, device)[0].reshape(-1, 1, 1, 1)
    mask = _source_mask3(cfg.depth, cfg.height, cfg.width, device)
    vt = torch.empty((vel.shape[0], num_frames) + tuple(vel.shape[1:]),
                     dtype=vel.dtype, device=device)
    rt = torch.empty((rho.shape[0], num_frames) + tuple(rho.shape[1:]),
                     dtype=rho.dtype, device=device)
    for f in range(num_frames):
        vel, rho = _step3((vel, rho), inflow_vel, buoyancy, mask, cfg)
        vt[:, f] = vel
        rt[:, f] = rho
    return vel, rho, vt, rt


def simulate_smoke3d_segment(vel, rho, inflow_vel, buoyancy,
                             cfg: Smoke3DConfig, num_frames: int):
    """Advance ``num_frames`` steps from (vel [D,H,W,3], rho [D,H,W]): the
    SEGMENTED entry point.

    A whole trajectory is held on the device until it is fetched (50 frames
    x 3 scenes of 32x64x112x3 f32 are 413 MB); callers run segments,
    carrying (vel, rho) across calls, which is numerically identical to one
    long run.  Returns (vel, rho, vel_traj [T,...], rho_traj [T,...]).
    """
    vel, rho, vt, rt = simulate_smoke3d_segment_batch(
        vel[None], rho[None], inflow_vel, buoyancy, cfg, num_frames)
    return vel[0], rho[0], vt[0], rt[0]


def simulate_smoke3d(inflow_vel, buoyancy, cfg: Smoke3DConfig,
                     device: str | torch.device | None = None):
    """One scene, or S at once; returns (vel_traj [T,D,H,W,3], rho_traj
    [T,D,H,W]), with a leading ``S`` axis when the parameters are vectors.

    Args:
      inflow_vel: upward source velocity injected inside the source mask.
      buoyancy: buoyancy coefficient (force per unit density).
      device: where to run; the card when None.
    """
    device = grids.resolve_device(device)
    inflow_vel, scalar_v = grids.scene_vector(inflow_vel, device)
    buoyancy, scalar_b = grids.scene_vector(buoyancy, device)
    s = max(inflow_vel.shape[0], buoyancy.shape[0])
    d, h, w = cfg.depth, cfg.height, cfg.width
    vel0 = torch.zeros((s, d, h, w, 3), dtype=torch.float32, device=device)
    rho0 = torch.zeros((s, d, h, w), dtype=torch.float32, device=device)
    _, _, vt, rt = simulate_smoke3d_segment_batch(
        vel0, rho0, inflow_vel, buoyancy, cfg, cfg.num_frames)
    return (vt[0], rt[0]) if scalar_v and scalar_b else (vt, rt)


def simulate_smoke3d_batch(inflow_vel, buoyancy, cfg: Smoke3DConfig,
                           device: str | torch.device | None = None):
    """Vectorized 3D scene sweep (see smoke2d.simulate_smoke2d_batch)."""
    inflow_vel = torch.as_tensor(inflow_vel, dtype=torch.float32).reshape(-1)
    buoyancy = torch.as_tensor(buoyancy, dtype=torch.float32).reshape(-1)
    return simulate_smoke3d(inflow_vel, buoyancy, cfg, device=device)
