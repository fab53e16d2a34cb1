"""Shared grid utilities for the PyTorch solvers (2D and 3D).

Counterpart of :mod:`deepfluids_tpu.datagen.grids`.  Collocated
(cell-centered) grids; semi-Lagrangian advection by an explicit
bilinear/trilinear gather; Jacobi pressure projection with Neumann
(solid-wall) boundaries.  2D fields are ``[..., H, W]`` (y, x), 3D are
``[..., D, H, W]`` (z, y, x); velocity channels are (u, v[, w]) = (x, y[, z])
components.

Every function takes any number of leading axes (the solvers carry one
scene axis ``S``), where the JAX functions are written for one scene and
batched by ``vmap``.  Nothing here tracks gradients: the callers run under
``torch.no_grad()``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

# Whether the CG solves run in float64 whatever their input's dtype
# (:func:`cg_in_float64`).
_CG_FLOAT64 = False


@contextlib.contextmanager
def cg_in_float64():
    """Inside, :func:`solve_pressure2d_cg` / :func:`solve_pressure3d_cg`
    (and so the ``projection="cg"`` solvers) solve in float64 and return
    the pressure in their input's dtype: the converged oracle of the
    consistency study, what the JAX functions do under
    ``jax_enable_x64``."""
    global _CG_FLOAT64
    saved, _CG_FLOAT64 = _CG_FLOAT64, True
    try:
        yield
    finally:
        _CG_FLOAT64 = saved


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The card unless the caller names a device; raises without a card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "deepfluids_tpu_torch runs on a CUDA card and found none "
                "(torch.cuda.is_available() is False); pass device='cpu' "
                "to run the plain PyTorch path on the CPU")
        device = "cuda"
    return torch.device(device)


def scene_vector(x, device: torch.device) -> tuple[torch.Tensor, bool]:
    """A scene parameter as a float32 ``[S]`` tensor on ``device`` and
    whether it was given as a scalar (S = 1, squeezed on return)."""
    t = torch.as_tensor(x, dtype=torch.float32)
    return t.reshape(-1).to(device), t.dim() == 0


def _gather_linear(q: torch.Tensor, coords: list[torch.Tensor],
                   channels: bool) -> torch.Tensor:
    """Multilinear sample of ``q`` at ``coords`` (one tensor per spatial
    axis, clipped into the box first).

    ``q`` is ``[*B, *spatial]`` (``channels``: ``[*B, *spatial, C]``) and
    each coordinate tensor ``[*B, *P]``; the result is ``[*B, *P]``
    (``[*B, *P, C]``).  Order-1 ``map_coordinates(mode="nearest")``: lower
    index ``floor(c)``, upper index ``floor(c) + 1`` clamped to ``n - 1``,
    weights ``1 - f`` and ``f``; corners summed lower-before-upper, first
    axis outermost.
    """
    nd = len(coords)
    sp0 = q.dim() - nd - (1 if channels else 0)      # first spatial axis
    batch, spatial = q.shape[:sp0], q.shape[sp0:sp0 + nd]
    pshape = coords[0].shape
    nb = 1
    for n in batch:
        nb *= n
    cells = 1
    for n in spatial:
        cells *= n
    c = q.shape[-1] if channels else 1
    flat = q.reshape(nb, cells, c)
    lows, highs, fracs = [], [], []
    for x, n in zip(coords, spatial):
        x = x.clamp(0.0, n - 1.0).reshape(nb, -1)
        lo = x.floor()
        fracs.append(x - lo)
        lo = lo.long()
        lows.append(lo)
        highs.append((lo + 1).clamp_(max=n - 1))
    out = None
    for corner in range(2 ** nd):
        idx, wgt = None, None
        for d in range(nd):
            upper = (corner >> (nd - 1 - d)) & 1
            i = highs[d] if upper else lows[d]
            w = fracs[d] if upper else 1.0 - fracs[d]
            idx = i if idx is None else idx * spatial[d] + i
            wgt = w if wgt is None else wgt * w
        vals = flat.gather(1, idx[..., None].expand(-1, -1, c))
        term = vals * wgt[..., None]
        out = term if out is None else out + term
    out = out.reshape(*pshape, c)
    return out if channels else out[..., 0]


def sample2d(q: torch.Tensor, coords_y: torch.Tensor,
             coords_x: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of scalar grids ``q [*B, H, W]`` at (y, x)
    coordinates ``[*B, *P]``."""
    return _gather_linear(q, [coords_y, coords_x], channels=False)


def _backtrace(vel: torch.Tensor, dt: float) -> list[torch.Tensor]:
    """Departure points ``x - dt * u`` of every cell, one tensor per
    spatial axis (first axis first); vel is ``[*B, *spatial, ndim]`` with
    channel k the component along spatial axis ``-1 - k``."""
    nd = vel.shape[-1]
    spatial = vel.shape[-1 - nd:-1]
    coords = []
    for ax, n in enumerate(spatial):
        shape = [1] * nd
        shape[ax] = n
        grid = torch.arange(n, dtype=torch.float32,
                            device=vel.device).reshape(shape)
        coords.append(grid - dt * vel[..., nd - 1 - ax])
    return coords


def advect2d(q: torch.Tensor, vel: torch.Tensor, dt: float) -> torch.Tensor:
    """Semi-Lagrangian advection of q (``[*B, H, W]`` or ``[*B, H, W, C]``)
    by vel ``[*B, H, W, 2]``; all channels are gathered at once."""
    return _gather_linear(q, _backtrace(vel, dt),
                          channels=q.dim() == vel.dim())


def _central(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Central difference that WRAPS AROUND at the box edge (``roll``), as
    the reference's operator does."""
    return (torch.roll(x, -1, dim) - torch.roll(x, 1, dim)) * 0.5


def divergence2d_c(vel: torch.Tensor) -> torch.Tensor:
    """Central-difference divergence of collocated vel ``[*B, H, W, 2]``."""
    return _central(vel[..., 0], -1) + _central(vel[..., 1], -2)


def _pad_edge(p: torch.Tensor, nd: int) -> torch.Tensor:
    """``p [*B, *spatial]`` padded by one replicated cell on every side of
    its ``nd`` spatial axes, as ``[N, *padded]`` (N the flattened batch)."""
    return F.pad(p.reshape(-1, *p.shape[p.dim() - nd:]), (1, 1) * nd,
                 mode="replicate")


def _neighbors2d(pn: torch.Tensor) -> torch.Tensor:
    return (pn[:, 2:, 1:-1] + pn[:, :-2, 1:-1] + pn[:, 1:-1, 2:]
            + pn[:, 1:-1, :-2])


def _subtract_gradient2d(vel: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """vel minus the central gradient of p (edge-replicated)."""
    pn = _pad_edge(p, 2)
    gx = (pn[:, 1:-1, 2:] - pn[:, 1:-1, :-2]) * 0.5
    gy = (pn[:, 2:, 1:-1] - pn[:, :-2, 1:-1]) * 0.5
    return vel - torch.stack([gx, gy], dim=-1).reshape(vel.shape)


def pressure_project2d(vel: torch.Tensor, iters: int = 50) -> torch.Tensor:
    """Make vel approximately divergence-free via Jacobi + gradient
    subtract."""
    div = divergence2d_c(vel)
    flat_div = div.reshape(-1, *div.shape[-2:])
    p = torch.zeros_like(flat_div)
    for _ in range(iters):
        p = 0.25 * (_neighbors2d(_pad_edge(p, 2)) - flat_div)
    return _subtract_gradient2d(vel, p)


def laplacian2d(p: torch.Tensor) -> torch.Tensor:
    """5-point Laplacian with edge-replicated (Neumann) boundaries: the
    EXACT operator the Jacobi sweep in :func:`pressure_project2d` relaxes
    (p_new = (sum_neighbors - div)/4  <=>  laplacian2d(p) = div)."""
    return _neighbors2d(_pad_edge(p, 2)).reshape(p.shape) - 4.0 * p


def _solve_pressure_cg(div: torch.Tensor, nd: int, tol: float,
                       maxiter: int, check_every: int = 8) -> torch.Tensor:
    """Deflated CG on ``-laplacian`` for every scene of ``div [*B,
    *spatial]`` at once.

    Each scene stops on its own residual: once ``rs <= (tol |b|)^2`` (or at
    ``maxiter``) its iterate, residual and direction are frozen while the
    others go on, which is what a batched ``while_loop`` does.  The stop
    condition is read back to the host only every ``check_every``
    iterations; the iterations run past a scene's stop change nothing.
    """
    lap = laplacian2d if nd == 2 else laplacian3d
    dims = tuple(range(-nd, 0))
    out_dtype = div.dtype
    if _CG_FLOAT64:
        div = div.double()

    def mean(q):
        return q.mean(dim=dims, keepdim=True)

    def dot(a, b):
        return (a * b).sum(dim=dims, keepdim=True)

    def proj(q):                                  # deflate the constant mode
        return q - mean(q)

    b = -(div - mean(div))                        # solve (-lap) p = -div, PSD
    atol2 = (tol * torch.sqrt(dot(b, b))) ** 2
    x = torch.zeros_like(b)
    r = proj(b)
    p = r
    rs = dot(r, r)
    for k in range(maxiter):
        live = rs > atol2
        if k % check_every == 0 and not bool(live.any()):
            break
        ap = -lap(p)
        alpha = rs / dot(p, ap)
        x = torch.where(live, x + alpha * p, x)
        r_new = proj(r - alpha * ap)
        rs_new = dot(r_new, r_new)
        p = torch.where(live, proj(r_new + (rs_new / rs) * p), p)
        r = torch.where(live, r_new, r)
        rs = torch.where(live, rs_new, rs)
    return (x - mean(x)).to(out_dtype)


def solve_pressure2d_cg(div: torch.Tensor, tol: float = 1e-6,
                        maxiter: int = 2000) -> torch.Tensor:
    """Conjugate-gradient reference solve of ``laplacian2d(p) = div``.

    The independent-convergence oracle for the production Jacobi sweep.
    The pure-Neumann operator has a constant null space; the RHS is
    projected mean-zero and CG iterates on -laplacian (positive
    semidefinite), with the mean projected out of the residual and the
    search direction every iteration: on this SINGULAR system plain CG
    feeds the constant mode by rounding and rebounds after a plateau.

    The solve runs in the dtype of ``div``: f32 loses conjugacy over
    O(1000) iterations, so an f32 call should keep ``tol`` modest (~1e-5);
    a float64 ``div`` gives the converged oracle, and so does an f32 one
    inside :func:`cg_in_float64`.
    """
    return _solve_pressure_cg(div, 2, tol, maxiter)


def pressure_project2d_cg(vel: torch.Tensor, tol: float = 1e-6,
                          maxiter: int = 2000) -> torch.Tensor:
    """:func:`pressure_project2d` with the CG reference solve in place of
    the fixed Jacobi iteration count (same divergence, same gradient
    subtract): the converged-projection oracle."""
    p = solve_pressure2d_cg(divergence2d_c(vel), tol=tol, maxiter=maxiter)
    return _subtract_gradient2d(vel, p)


def wall_bc2d(vel: torch.Tensor) -> torch.Tensor:
    """Zero wall-normal velocity on the box boundary (closed domain)."""
    vel = vel.clone()
    vel[..., :, 0, 0] = 0.0
    vel[..., :, -1, 0] = 0.0
    vel[..., 0, :, 1] = 0.0
    vel[..., -1, :, 1] = 0.0
    return vel


# ---------------------------------------------------------------------------
# 3D variants
# ---------------------------------------------------------------------------

def sample3d(q: torch.Tensor, cz: torch.Tensor, cy: torch.Tensor,
             cx: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of scalar grids ``q [*B, D, H, W]`` at (z, y, x)
    coordinates ``[*B, *P]``."""
    return _gather_linear(q, [cz, cy, cx], channels=False)


def advect3d(q: torch.Tensor, vel: torch.Tensor, dt: float) -> torch.Tensor:
    """Semi-Lagrangian advection of q (``[*B, D, H, W]`` or ``[*B, D, H, W,
    C]``) by vel ``[*B, D, H, W, 3]``."""
    return _gather_linear(q, _backtrace(vel, dt),
                          channels=q.dim() == vel.dim())


def divergence3d_c(vel: torch.Tensor) -> torch.Tensor:
    """Central-difference (wrap-around) divergence of ``[*B, D, H, W, 3]``."""
    return (_central(vel[..., 0], -1) + _central(vel[..., 1], -2)
            + _central(vel[..., 2], -3))


def _neighbors3d(pn: torch.Tensor) -> torch.Tensor:
    return (pn[:, 2:, 1:-1, 1:-1] + pn[:, :-2, 1:-1, 1:-1]
            + pn[:, 1:-1, 2:, 1:-1] + pn[:, 1:-1, :-2, 1:-1]
            + pn[:, 1:-1, 1:-1, 2:] + pn[:, 1:-1, 1:-1, :-2])


def _subtract_gradient3d(vel: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    pn = _pad_edge(p, 3)
    gx = (pn[:, 1:-1, 1:-1, 2:] - pn[:, 1:-1, 1:-1, :-2]) * 0.5
    gy = (pn[:, 1:-1, 2:, 1:-1] - pn[:, 1:-1, :-2, 1:-1]) * 0.5
    gz = (pn[:, 2:, 1:-1, 1:-1] - pn[:, :-2, 1:-1, 1:-1]) * 0.5
    return vel - torch.stack([gx, gy, gz], dim=-1).reshape(vel.shape)


def pressure_project3d(vel: torch.Tensor, iters: int = 40) -> torch.Tensor:
    div = divergence3d_c(vel)
    flat_div = div.reshape(-1, *div.shape[-3:])
    p = torch.zeros_like(flat_div)
    for _ in range(iters):
        p = (_neighbors3d(_pad_edge(p, 3)) - flat_div) / 6.0
    return _subtract_gradient3d(vel, p)


def laplacian3d(p: torch.Tensor) -> torch.Tensor:
    """7-point Laplacian with edge-replicated (Neumann) boundaries: the
    EXACT operator the Jacobi sweep in :func:`pressure_project3d` relaxes
    (p_new = (sum_neighbors - div)/6  <=>  laplacian3d(p) = div)."""
    return _neighbors3d(_pad_edge(p, 3)).reshape(p.shape) - 6.0 * p


def solve_pressure3d_cg(div: torch.Tensor, tol: float = 1e-6,
                        maxiter: int = 4000) -> torch.Tensor:
    """Deflated-CG reference solve of ``laplacian3d(p) = div``: the 3D
    analogue of :func:`solve_pressure2d_cg` (same singular pure-Neumann
    system, same constant-mode deflation every iteration).  Give it a
    float64 ``div`` for a true converged oracle."""
    return _solve_pressure_cg(div, 3, tol, maxiter)


def pressure_project3d_cg(vel: torch.Tensor, tol: float = 1e-6,
                          maxiter: int = 4000) -> torch.Tensor:
    """:func:`pressure_project3d` with the CG reference solve in place of
    the fixed Jacobi iteration count: the 3D converged-projection oracle."""
    p = solve_pressure3d_cg(divergence3d_c(vel), tol=tol, maxiter=maxiter)
    return _subtract_gradient3d(vel, p)


def wall_bc3d(vel: torch.Tensor) -> torch.Tensor:
    vel = vel.clone()
    vel[..., :, :, 0, 0] = 0.0
    vel[..., :, :, -1, 0] = 0.0
    vel[..., :, 0, :, 1] = 0.0
    vel[..., :, -1, :, 1] = 0.0
    vel[..., 0, :, :, 2] = 0.0
    vel[..., -1, :, :, 2] = 0.0
    return vel
