"""2D buoyant smoke plume solver (PyTorch; mantaflow smoke scene equivalent).

Counterpart of :mod:`deepfluids_tpu.datagen.smoke2d`.  Per-frame loop:
apply source -> add buoyancy -> advect (semi-Lagrangian) -> wall BCs ->
pressure projection.  Every state tensor carries a leading scene axis, so a
parameter sweep over (source position, source radius) is one solver run on
``[S, H, W, ...]`` fields; the frame loop is a Python loop that writes into
a preallocated ``[S, T, ...]`` trajectory.
"""

from __future__ import annotations

import dataclasses

import torch

from deepfluids_tpu_torch.datagen import grids


@dataclasses.dataclass(frozen=True)
class Smoke2DConfig:
    height: int = 128           # H (y)
    width: int = 96             # W (x)
    num_frames: int = 200
    dt: float = 1.0
    buoyancy: float = 0.08      # upward force per unit density
    source_rate: float = 1.0    # density injected per step inside source
    project_iters: int = 50
    projection: str = "jacobi"  # "jacobi" (legacy default, project_iters
                                # central-difference sweeps)
                                # | "cg" (converged central solve: the
                                # solver-consistency oracle)
                                # | "matched" (discrete Leray projection
                                # onto the GENERATOR'S manifold,
                                # projection.project_curl2d: frames are
                                # exactly curl(psi), zero wall through-flow)
    cg_tol: float = 1e-6
    mg_cycles: int = 8          # V-cycles for projection="matched"

    def __post_init__(self):
        # A typo like projection='Matched' would otherwise silently fall
        # through to the Jacobi branch and regenerate hours of frames
        # off-manifold.
        if self.projection not in ("jacobi", "cg", "matched"):
            raise ValueError(
                f"projection={self.projection!r}: expected one of "
                "'jacobi', 'cg', 'matched'")


def _source_mask(h: int, w: int, pos_x: torch.Tensor, radius: torch.Tensor,
                 pos_y: torch.Tensor | float) -> torch.Tensor:
    """Soft circular source masks ``[S, H, W]``.  pos_x/pos_y in [0,1]
    (fractions), radius as a fraction of width; each ``[S]`` (or a float)."""
    dev = pos_x.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]

    def per_scene(v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=dev).reshape(-1, 1, 1)

    cy = per_scene(pos_y) * (h - 1)
    cx = per_scene(pos_x) * (w - 1)
    r = per_scene(radius) * w
    d2 = (yy - cy) ** 2 + (xx - cx) ** 2
    return (1.0 - torch.sqrt(d2) / r.clamp(min=1e-6)).clamp(0.0, 1.0)


def step(state, src_mask, cfg: Smoke2DConfig):
    """One solver step.  state = (vel [S,H,W,2], rho [S,H,W])."""
    vel, rho = state
    rho = (rho + cfg.source_rate * src_mask).clamp(0.0, 1.0)
    # Buoyancy: upward (+y) force proportional to density.
    vel = vel.clone()
    vel[..., 1] += cfg.dt * cfg.buoyancy * rho
    vel = grids.wall_bc2d(vel)
    rho = grids.advect2d(rho, vel, cfg.dt)
    vel = grids.advect2d(vel, vel, cfg.dt)
    vel = grids.wall_bc2d(vel)
    if cfg.projection == "matched":
        # Leray projection onto the generator's manifold: the result is
        # exactly curl(psi) with zero wall through-flow, so NO trailing
        # wall_bc: it would push the frame off-manifold again.
        from deepfluids_tpu_torch.datagen import projection
        vel = projection.project_curl2d(vel, cycles=cfg.mg_cycles)
    elif cfg.projection == "cg":
        vel = grids.pressure_project2d_cg(vel, tol=cfg.cg_tol)
        vel = grids.wall_bc2d(vel)
    else:
        vel = grids.pressure_project2d(vel, cfg.project_iters)
        vel = grids.wall_bc2d(vel)
    return vel, rho


@torch.no_grad()
def simulate_smoke2d(pos_x, radius, cfg: Smoke2DConfig,
                     pos_x_per_frame=None, moving: bool = False,
                     device: str | torch.device | None = None):
    """Run one scene, or ``S`` scenes at once; returns (vel_traj
    [T,H,W,2], rho_traj [T,H,W]), with a leading ``S`` axis when the
    parameters are vectors.

    Args:
      pos_x: static source x-position (fraction of width, in [0, 1]); a
        scalar or ``[S]``.
      radius: source radius (fraction of width); a scalar or ``[S]``.
      cfg: solver config.
      pos_x_per_frame: ``[T]`` (or ``[S, T]``) per-frame source positions;
        used when ``moving`` (the smoke_mov scene family), and then sets
        the number of frames.
      device: where to run; the card when None.
    """
    device = grids.resolve_device(device)
    h, w = cfg.height, cfg.width
    radius, squeeze = grids.scene_vector(radius, device)
    if moving:
        xs = torch.as_tensor(pos_x_per_frame, dtype=torch.float32)
        squeeze = squeeze and xs.dim() == 1
        xs = xs.reshape(-1, xs.shape[-1]).to(device)           # [S, T]
        num_frames = xs.shape[1]
        s = max(xs.shape[0], radius.shape[0])
    else:
        pos_x, scalar_pos = grids.scene_vector(pos_x, device)
        squeeze = squeeze and scalar_pos
        num_frames = cfg.num_frames
        s = max(pos_x.shape[0], radius.shape[0])
        mask = _source_mask(h, w, pos_x, radius, 0.08)   # near the bottom
    vel = torch.zeros((s, h, w, 2), dtype=torch.float32, device=device)
    rho = torch.zeros((s, h, w), dtype=torch.float32, device=device)
    vt = torch.empty((s, num_frames, h, w, 2), dtype=torch.float32,
                     device=device)
    rt = torch.empty((s, num_frames, h, w), dtype=torch.float32,
                     device=device)
    for f in range(num_frames):
        if moving:
            mask = _source_mask(h, w, xs[:, f], radius, 0.08)
        vel, rho = step((vel, rho), mask, cfg)
        vt[:, f] = vel
        rt[:, f] = rho
    return (vt[0], rt[0]) if squeeze else (vt, rt)


def simulate_smoke2d_batch(pos_x, radius, cfg: Smoke2DConfig,
                           device: str | torch.device | None = None):
    """Vectorized scene sweep: S solver instances advance together over
    (pos_x [S], radius [S]).

    Returns (vel [S,T,H,W,2], rho [S,T,H,W]).
    """
    pos_x = torch.as_tensor(pos_x, dtype=torch.float32).reshape(-1)
    radius = torch.as_tensor(radius, dtype=torch.float32).reshape(-1)
    return simulate_smoke2d(pos_x, radius, cfg, device=device)
