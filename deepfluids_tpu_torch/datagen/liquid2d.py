"""2D FLIP liquid solver with a particle-tracked free surface (PyTorch).

Counterpart of :mod:`deepfluids_tpu.datagen.liquid2d`.  Scene family
liquid_pos10_size4: a liquid drop falls into a basin; the dataset's field
is the LEVELSET (signed distance, negative inside the liquid), the
``--data_type=levelset`` path of the reference.

This is a real FLIP method, in fixed shapes with a leading scene axis:

  * particles carry momentum (fixed lattice of 4/cell over the whole
    domain; a float ``active`` mask selects the liquid, so shapes never
    depend on the scene's parameters);
  * P2G: bilinear scatter of particle momentum/mass to the grid
    (``index_add_`` of the 4 corners x 3 fields in one call);
  * grid: gravity on liquid cells, wall BCs, and a FREE-SURFACE pressure
    projection (Jacobi with Dirichlet p = 0 in air, not the uniform
    projection the smoke solvers use);
  * G2P: FLIP delta transfer blended with PIC
    (v_p <- a (v_p + du_grid) + (1-a) u_grid, a = flip_ratio);
  * particles advect through the grid field (RK2 midpoint, CFL-clamped);
  * the levelset is rebuilt from particle occupancy and redistanced.

Mass is conserved exactly in the particle representation (particles are
never created or destroyed).

On a CUDA device the scatter sums with atomics, in no fixed order, so the
grid mass differs in its last bits from run to run, and the liquid mask
(``mass > 0.4``) and the extrapolation's ``known``/``fill`` masks are
thresholds of it: a trajectory on the card is not bitwise repeatable and
drifts from the CPU's.  On the CPU the scatter adds in index order.
"""

from __future__ import annotations

import dataclasses

import torch

from deepfluids_tpu_torch.datagen import grids


@dataclasses.dataclass(frozen=True)
class Liquid2DConfig:
    height: int = 128
    width: int = 96
    num_frames: int = 200
    dt: float = 0.5
    gravity: float = 0.15
    basin_level: float = 0.25   # fraction of height filled with liquid
    project_iters: int = 60
    redist_iters: int = 6
    flip_ratio: float = 0.95    # FLIP/PIC blend (1 = pure FLIP, noisy;
                                # 0 = pure PIC, dissipative)
    max_disp: float = 2.5       # CFL clamp: max particle move per step (cells)
    density_relax: float = 0.5  # volume-conservation strength: over-packed
                                # cells (particle mass > rest) get a
                                # positive divergence target so the
                                # projection pushes particles apart


def _phi_init(y, x, h, w, pos_x, radius, basin):
    """Analytic initial signed distance (cells, neg = liquid) at (y, x):
    basin up to ``basin*h`` plus a falling drop."""
    phi_basin = y - basin * h
    cy, cx = 0.7 * h, pos_x * (w - 1)
    r = radius * w
    phi_drop = torch.sqrt((y - cy) ** 2 + (x - cx) ** 2) - r
    return torch.minimum(phi_basin, phi_drop)


def _initial_levelset(h, w, pos_x, radius,
                      basin: float = Liquid2DConfig.basin_level):
    """Initial levelsets ``[S, H, W]`` for pos_x, radius ``[S]``."""
    dev = pos_x.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    return _phi_init(yy, xx, h, w, pos_x.reshape(-1, 1, 1),
                     radius.reshape(-1, 1, 1), basin)


def _seed_particles(h, w, pos_x, radius, basin):
    """Fixed 2x2-per-cell lattice over the whole domain; particles inside
    the initial liquid are active.  Returns (py, px, pvy, pvx, active),
    each ``[S, 4*h*w]`` for pos_x, radius ``[S]``."""
    dev = pos_x.device

    def lattice(n):
        return (torch.arange(2 * n, dtype=torch.float32, device=dev)
                + 0.5) / 2.0 - 0.5

    ys, xs = lattice(h), lattice(w)
    py, px = [a.reshape(1, -1)
              for a in torch.meshgrid(ys, xs, indexing="ij")]
    phi_p = _phi_init(py, px, h, w, pos_x.reshape(-1, 1),
                      radius.reshape(-1, 1), basin)
    active = (phi_p < 0.0).float()
    py = py.expand_as(active).contiguous()
    px = px.expand_as(active).contiguous()
    zeros = torch.zeros_like(px)
    return py, px, zeros, zeros.clone(), active


def _bilinear_corners(py, px, h, w):
    """Corner indices + weights for bilinear P2G/G2P at cell centers."""
    y0 = py.floor().clamp(0, h - 2).long()
    x0 = px.floor().clamp(0, w - 2).long()
    fy = (py - y0).clamp(0.0, 1.0)
    fx = (px - x0).clamp(0.0, 1.0)
    corners = []
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            corners.append((y0 + dy, x0 + dx, wy * wx))
    return corners


def _p2g(py, px, pvy, pvx, active, h, w):
    """Scatter particle momentum + mass to the grid (bilinear): particles
    ``[S, N]`` -> (vel [S,H,W,2], mass [S,H,W])."""
    s = py.shape[0]
    cell0 = torch.arange(s, device=py.device).reshape(-1, 1) * (h * w)
    idx, vals = [], []
    for iy, ix, wgt in _bilinear_corners(py, px, h, w):
        wa = wgt * active
        idx.append((cell0 + iy * w + ix).reshape(-1))
        vals.append(torch.stack([wa * pvx, wa * pvy, wa], dim=-1
                                ).reshape(-1, 3))
    grid = torch.zeros((s * h * w, 3), dtype=torch.float32, device=py.device)
    grid.index_add_(0, torch.cat(idx), torch.cat(vals))
    grid = grid.reshape(s, h, w, 3)
    mass = grid[..., 2]
    inv = 1.0 / mass.clamp(min=1e-6)
    return grid[..., :2] * inv[..., None], mass


def _box3(q):
    """3x3 box mean of ``q [*B, H, W]`` with replicated edges."""
    qn = grids._pad_edge(q, 2)
    hp, wp = qn.shape[-2:]
    out = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            t = qn[:, 1 + dy:hp - 1 + dy, 1 + dx:wp - 1 + dx]
            out = t if out is None else out + t
    return (out / 9.0).reshape(q.shape)


def _extrapolate_velocity(vel, liquid, sweeps: int = 4):
    """Extend liquid velocity into nearby air cells (masked diffusion).

    Without ghost velocities the collocated divergence sees a false jump
    at the free surface (air cells are zero), the projection builds
    back-pressure, and falling liquid 'parachutes'."""
    v, w = vel, liquid
    for _ in range(sweeps):
        wavg = _box3(w)
        avg = torch.stack([_box3(v[..., c] * w) for c in range(2)], dim=-1)
        avg = avg / wavg.clamp(min=1e-6)[..., None]
        known = (w > 0.0)[..., None]
        fill = (wavg > 1e-6)[..., None]
        v = torch.where(known, v, torch.where(fill, avg, v))
        w = torch.maximum(w, (wavg > 1e-6).float())
    return v


def _project_free_surface(vel, liquid, iters, div_src=None):
    """Jacobi pressure solve with Dirichlet p = 0 in air (free surface);
    divergence is driven to ``div_src`` (default 0) inside the liquid.

    ``div_src`` > 0 in over-packed cells is the standard FLIP volume-
    conservation correction: the projection then pushes particles apart
    instead of letting the liquid silently compress."""
    div = grids.divergence2d_c(vel)
    if div_src is not None:
        div = div - div_src
    div = div * liquid
    flat_div = div.reshape(-1, *div.shape[-2:])
    flat_liquid = liquid.reshape(flat_div.shape)
    p = torch.zeros_like(flat_div)
    for _ in range(iters):
        p = 0.25 * (grids._neighbors2d(grids._pad_edge(p, 2)) - flat_div)
        p = p * flat_liquid                      # air pressure pinned to 0
    return grids._subtract_gradient2d(vel, p)


def _redistance(phi, iters):
    """A few smoothing sweeps toward |grad phi| = 1 (cheap PDE redistance)."""
    shape = phi.shape
    p = phi.reshape(-1, *shape[-2:])
    for _ in range(iters):
        pn = grids._pad_edge(p, 2)
        gx = (pn[:, 1:-1, 2:] - pn[:, 1:-1, :-2]) * 0.5
        gy = (pn[:, 2:, 1:-1] - pn[:, :-2, 1:-1]) * 0.5
        grad = torch.sqrt(gx**2 + gy**2 + 1e-6)
        s = p / torch.sqrt(p**2 + 1.0)
        p = p - 0.3 * s * (grad - 1.0)
    return p.reshape(shape)


def _levelset_from_mass(mass, redist_iters):
    """Occupancy -> signed levelset: interior where particle mass exceeds
    ~40% of a full cell's (4 particles), then redistanced."""
    occ = mass / 4.0
    # one 3x3 box blur knocks down particle-lattice aliasing
    occ = _box3(occ)
    phi = (0.4 - occ) * 3.0
    return _redistance(phi, redist_iters)


def _sample_vec(vel, py, px):
    out = grids._gather_linear(vel, [py, px], channels=True)
    return out[..., 0], out[..., 1]


def _step(state, active, cfg: Liquid2DConfig):
    """One FLIP step.  state = (py, px, pvy, pvx), each ``[S, N]``; returns
    the new state and the frame's outputs (phi [S,H,W], vel [S,H,W,2])."""
    h, w = cfg.height, cfg.width
    py, px, pvy, pvx = state
    # --- P2G (+ ghost velocities in the air band) ---
    vel_p2g, mass = _p2g(py, px, pvy, pvx, active, h, w)
    liquid = (mass > 0.4).float()
    vel_old = _extrapolate_velocity(vel_p2g, liquid)
    # --- grid forces + free-surface projection ---
    vel = vel_old.clone()
    vel[..., 1] += -cfg.dt * cfg.gravity * liquid
    vel = grids.wall_bc2d(vel)
    div_src = cfg.density_relax * (mass / 4.0 - 1.0).clamp(min=0.0)
    vel = _project_free_surface(vel, liquid, cfg.project_iters, div_src)
    vel = grids.wall_bc2d(vel)
    # --- G2P: FLIP delta + PIC blend ---
    ux, uy = _sample_vec(vel, py, px)
    dx_, dy_ = _sample_vec(vel - vel_old, py, px)
    a = cfg.flip_ratio
    pvx = a * (pvx + dx_) + (1.0 - a) * ux
    pvy = a * (pvy + dy_) + (1.0 - a) * uy
    # --- advect particles (RK2 midpoint through the grid field) ---
    mx, my = _sample_vec(vel, py + 0.5 * cfg.dt * uy, px + 0.5 * cfg.dt * ux)
    dxp = (cfg.dt * mx).clamp(-cfg.max_disp, cfg.max_disp)
    dyp = (cfg.dt * my).clamp(-cfg.max_disp, cfg.max_disp)
    px = (px + dxp).clamp(0.5, w - 1.5)
    py = (py + dyp).clamp(0.5, h - 1.5)
    # --- outputs: levelset from particle occupancy + grid velocity ---
    _, mass2 = _p2g(py, px, pvy, pvx, active, h, w)
    phi = _levelset_from_mass(mass2, cfg.redist_iters)
    return (py, px, pvy, pvx), (phi, vel)


@torch.no_grad()
def simulate_liquid2d(pos_x, radius, cfg: Liquid2DConfig,
                      device: str | torch.device | None = None):
    """One scene, or S at once; returns (levelset_traj [T,H,W,1], vel_traj
    [T,H,W,2]), with a leading ``S`` axis when the parameters are
    vectors."""
    device = grids.resolve_device(device)
    pos_x, scalar_p = grids.scene_vector(pos_x, device)
    radius, scalar_r = grids.scene_vector(radius, device)
    pos_x, radius = torch.broadcast_tensors(pos_x, radius)
    s, h, w = pos_x.shape[0], cfg.height, cfg.width
    py, px, pvy, pvx, active = _seed_particles(h, w, pos_x, radius,
                                               cfg.basin_level)
    phit = torch.empty((s, cfg.num_frames, h, w, 1), dtype=torch.float32,
                       device=device)
    velt = torch.empty((s, cfg.num_frames, h, w, 2), dtype=torch.float32,
                       device=device)
    state = (py, px, pvy, pvx)
    for f in range(cfg.num_frames):
        state, (phi, vel) = _step(state, active, cfg)
        phit[:, f, ..., 0] = phi
        velt[:, f] = vel
    return (phit[0], velt[0]) if scalar_p and scalar_r else (phit, velt)


def simulate_liquid2d_batch(pos_x, radius, cfg: Liquid2DConfig,
                            device: str | torch.device | None = None):
    """Vectorized liquid scene sweep (see smoke2d.simulate_smoke2d_batch)."""
    pos_x = torch.as_tensor(pos_x, dtype=torch.float32).reshape(-1)
    radius = torch.as_tensor(radius, dtype=torch.float32).reshape(-1)
    return simulate_liquid2d(pos_x, radius, cfg, device=device)
