"""Model-matched pressure projection via variational geometric multigrid.

Counterpart of :mod:`deepfluids_tpu.datagen.projection`.

Why this exists: the generator emits velocity through ``ops.fd.curl2d/3d``
(forward differences, edge replication), so its output manifold is exactly
``range(curl)``.  The production Jacobi sweep projects with
CENTRAL-difference operators, whose kernel differs, and whose
under-converged iterates leave a large share of each frame's L2 norm
outside the model's manifold (the reference measures a median distance of
0.247 for smoke_pos21_size5 frames).  No decoder in the curl family can
beat that floor; the error is in the data.  Projecting the solver's
velocity onto the model's own manifold removes it at the source.

Two projections are provided, both solved by the same multigrid core:

* :func:`project_curl2d` / :func:`project_curl3d`: the production ones.
  Solve the psi-space least squares  min_psi ||curl(psi) - v||^2  with
  psi = 0 on the boundary ring: the discrete Leray projector of the closed
  box.  The output is literally ``curl(psi)``, on-manifold to machine
  precision, AND has exactly zero wall-normal flow, so no trailing
  ``wall_bc`` is needed.  The Dirichlet ring also makes the 2D normal
  operator E J^T J E nonsingular.
* :func:`project_matched`: orthogonal projection onto ker(div_f) via
  (D D^T) p = D v, v' = v - D^T p with D the model's forward-difference
  divergence.  Used by the solver-consistency study; keeps wall handling
  outside.  A = D D^T has a rank-1 null space (an alternating 2^ndim corner
  block where the replicated edges meet), deflated from the RHS.

Solver: geometric multigrid, a stationary iteration with no divergence
risk in f32 (f32 CG on these systems plateaus, then diverges).  The
hierarchy is built EXACTLY variationally: P = linear prolongation (a small
dense matrix per level and axis, the weights of a half-pixel-centre linear
resize), R = P^T (the same matrices transposed), A_c = P^T A P composed
functionally down to the fine grid, and the coarsest level solved exactly
with a pseudo-inverse probed out of the composed operator (the pinv cutoff
also absorbs near-null modes).  Coarse applications chain through the fine
operator, costing O(N_fine) each: a V(2,2) cycle is 5 fine applications a
smoothing level.

The curl and its transpose go through the package's kernels.  On float32
fields they are :func:`~deepfluids_tpu_torch.ops.cuda_fd.curl2d_fused` /
``curl2d_bwd`` and ``curl3d_fused`` / ``curl3d_bwd`` with the scenes (or
the setup's probes) as the kernels' batch axis: on a CUDA tensor the
hand-written kernels, on a CPU tensor their plain versions.  The kernels
take f32 and bf16 only, so a float64 call (the consistency study's) takes
the plain :mod:`~deepfluids_tpu_torch.ops.fd` functions on either device:
a dtype rule.  The projection is f32/f64 only: any other dtype raises.
The operators look ``_curl`` / ``_curl_adj`` / ``_curl3`` / ``_curl3_adj``
up at call time, and the written-out ``_curl_adj_plain`` /
``_curl3_adj_plain`` are the plain versions the kernels' path is held
against.

Every function takes leading batch axes in front of the spatial ones;
``project_*`` return what they were given (``[H, W, 2]`` or ``[S, H, W,
2]``).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from deepfluids_tpu_torch.ops import cuda_fd, fd


def _through_kernels(x: torch.Tensor) -> bool:
    """The dtype rule: float32 takes the kernel wrappers, float64 the plain
    ``ops.fd`` functions, anything else is refused."""
    if x.dtype == torch.float32:
        return True
    if x.dtype == torch.float64:
        return False
    raise TypeError(f"the matched projection takes float32 or float64 "
                    f"fields, got {x.dtype}")


# ---------------------------------------------------------------------------
# Matched operators: D (the model's forward-difference divergence) and D^T
# ---------------------------------------------------------------------------

def _fdiff_adj(y: torch.Tensor, axis: int) -> torch.Tensor:
    """Adjoint of ``ops.fd._fdiff`` (forward diff, last slice replicated).

    For the 1D operator T with d[i] = x[i+1]-x[i] (i < n-1) and
    d[n-1] = x[n-1]-x[n-2]:
      (T^T y)[0]    = -y[0]
      (T^T y)[k]    = y[k-1] - y[k]          1 <= k <= n-3
      (T^T y)[n-2]  = y[n-3] - y[n-2] - y[n-1]
      (T^T y)[n-1]  = y[n-2] + y[n-1]
    i.e. a backward difference with two boundary corrections from the
    replicated last slice.
    """
    y = y.movedim(axis, -1)
    n = y.shape[-1]
    prev = torch.cat([torch.zeros_like(y[..., :1]), y[..., :-1]], dim=-1)
    out = prev - y                       # y[k-1] - y[k], with y[-1] := 0
    out[..., n - 2] -= y[..., n - 1]
    out[..., n - 1] += 2.0 * y[..., n - 1]
    return out.movedim(-1, axis)


def div_f(vel: torch.Tensor) -> torch.Tensor:
    """Forward-difference divergence, [..., *S, C] -> [..., *S] (C = ndim).

    Dispatches to the EXACT operators the models train against
    (``ops.fd.divergence2d/3d``) so ker(D) is the generator's manifold.
    """
    if vel.shape[-1] == 2:
        return fd.divergence2d(vel)[..., 0]
    return fd.divergence3d(vel)[..., 0]


def div_f_adj(p: torch.Tensor, ndim: int) -> torch.Tensor:
    """D^T: [..., *S] -> [..., *S, ndim]. Axis convention: channels are (u,
    v[, w]) = d/dx, d/dy[, d/dz] with x = last spatial axis, y =
    second-to-last, z = third-to-last (matches ops.fd)."""
    comps = [_fdiff_adj(p, axis=-1), _fdiff_adj(p, axis=-2)]
    if ndim == 3:
        comps.append(_fdiff_adj(p, axis=-3))
    return torch.stack(comps, dim=-1)


def matched_laplacian(p: torch.Tensor, ndim: int) -> torch.Tensor:
    """A = D D^T: symmetric PSD, reach-2 stencil (the replicated-edge
    closure couples indices two apart near the boundary)."""
    return div_f(div_f_adj(p, ndim))


# --- curl least-squares operator (psi-space, Dirichlet ring) ---------------

def _batched(fn: Callable, x: torch.Tensor, spatial: int,
             channels: int) -> torch.Tensor:
    """A kernel wrapper ``fn`` (one batch axis, contiguous input) on ``x``
    with any number of leading axes; ``channels`` of the output."""
    lead = x.shape[:x.dim() - spatial - 1]
    out = fn(x.reshape(-1, *x.shape[x.dim() - spatial - 1:]).contiguous())
    return out.reshape(*lead, *out.shape[1:-1], channels)


def _curl(psi: torch.Tensor) -> torch.Tensor:
    """[..., H, W] stream function -> [..., H, W, 2] velocity via the
    model's own curl."""
    if _through_kernels(psi):
        return _batched(cuda_fd.curl2d_fused, psi[..., None], 2, 2)
    return fd.curl2d(psi[..., None])


def _curl_adj_plain(v: torch.Tensor) -> torch.Tensor:
    """J^T for the 2D curl, written out: u = T_y psi, v = -T_x psi  =>
    J^T w = T_y^T w_u - T_x^T w_v."""
    return _fdiff_adj(v[..., 0], axis=-2) - _fdiff_adj(v[..., 1], axis=-1)


def _curl_adj(v: torch.Tensor) -> torch.Tensor:
    """J^T for the 2D curl, [..., H, W, 2] -> [..., H, W]: the transposed
    kernel on f32, :func:`_curl_adj_plain` otherwise."""
    if _through_kernels(v):
        return _batched(cuda_fd.curl2d_bwd, v, 2, 1)[..., 0]
    return _curl_adj_plain(v)


def _ring_mask(shape: tuple[int, ...], dtype,
               device: str | torch.device = "cpu") -> torch.Tensor:
    """1 in the interior, 0 on the boundary ring (Dirichlet DOF mask)."""
    m = torch.ones(shape, dtype=dtype, device=device)
    for ax in range(len(shape)):
        m.select(ax, 0).zero_()
        m.select(ax, -1).zero_()
    return m


def curl_ls_operator(shape: tuple[int, ...], dtype,
                     device: str | torch.device = "cpu"):
    """B psi = M J^T J (M psi) + (1-M) psi: the normal operator of the
    Dirichlet-ring curl least squares, extended with identity on the ring
    so the full-grid system is SPD and nonsingular (MG-friendly shapes)."""
    m = _ring_mask(shape, dtype, device)

    def B(psi):
        return m * _curl_adj(_curl(m * psi)) + (1.0 - m) * psi
    return B


def _curl3(psi: torch.Tensor) -> torch.Tensor:
    """[..., D, H, W, 3] vector potential -> velocity via the model's 3D
    curl."""
    if _through_kernels(psi):
        return _batched(cuda_fd.curl3d_fused, psi, 3, 3)
    return fd.curl3d(psi)


def _curl3_adj_plain(v: torch.Tensor) -> torch.Tensor:
    """J^T for the 3D curl, written out (u = T_y c - T_z b, v = T_z a - T_x
    c, w = T_x b - T_y a):  a <- T_z^T v - T_y^T w;  b <- T_x^T w - T_z^T u;
    c <- T_y^T u - T_x^T v."""
    u, vv, w = v[..., 0], v[..., 1], v[..., 2]
    a = _fdiff_adj(vv, axis=-3) - _fdiff_adj(w, axis=-2)
    b = _fdiff_adj(w, axis=-1) - _fdiff_adj(u, axis=-3)
    c = _fdiff_adj(u, axis=-2) - _fdiff_adj(vv, axis=-1)
    return torch.stack([a, b, c], dim=-1)


def _curl3_adj(v: torch.Tensor) -> torch.Tensor:
    """J^T for the 3D curl: the transposed kernel on f32,
    :func:`_curl3_adj_plain` otherwise."""
    if _through_kernels(v):
        return _batched(cuda_fd.curl3d_bwd, v, 3, 3)
    return _curl3_adj_plain(v)


def curl3_ls_operator(shape: tuple[int, ...], dtype,
                      device: str | torch.device = "cpu"):
    """3D analogue of :func:`curl_ls_operator` on Psi [D, H, W, 3] with a
    zero-Dirichlet SHELL on all three vector-potential components (=> zero
    wall-normal flow: tangential derivatives of a vanishing face are zero).
    Unlike 2D the normal operator is only semidefinite (gauge fields
    Psi = grad(phi) are invisible to the curl) but the RHS J^T V is always
    compatible, the smoother's null drift is bounded, the coarsest pinv
    cuts the null space off, and any residual null component is annihilated
    by the final curl anyway (only curl(Psi) is returned)."""
    m = _ring_mask(shape[:-1], dtype, device)[..., None]

    def B(psi):
        return m * _curl3_adj(_curl3(m * psi)) + (1.0 - m) * psi
    return B


# ---------------------------------------------------------------------------
# Variational geometric multigrid core
# ---------------------------------------------------------------------------

def _probe_chunk(fine_cells: int) -> int:
    """Probes per batched operator application: bounds the fine-grid
    transient of a probe batch to ~128 MB of f32."""
    return int(min(64, max(8, (32 * 1024 * 1024) // max(fine_cells, 1))))


def _op_diag(Afn, shape: tuple[int, ...], dtype,
             strides: tuple[int, ...] | None = None,
             device: str | torch.device = "cpu",
             chunk: int = 64) -> torch.Tensor:
    """Exact diagonal of a short-reach linear operator by stride-color
    probing: sum_c A(chi_c) * chi_c is exact when same-color cells are
    never coupled.  The fine operators have reach 2 along spatial axes;
    Galerkin coarse operators reach ~3.  Plain red/black 2-coloring
    corrupts boundary diagonals here and blows up the smoother; spatial
    stride 4 covers every level.  A channel axis (the 3D vector potential)
    couples any-to-any, so its stride must equal its size: pass per-axis
    ``strides`` for that.  The colors are probed ``chunk`` at a time as the
    operator's batch."""
    ndim = len(shape)
    strides = strides or (4,) * ndim
    ncolors = 1
    for st in strides:
        ncolors *= st
    # color of a cell: sum_d (index_d % stride_d) * prod(strides[:d])
    cell_color = torch.zeros(shape, dtype=torch.long, device=device)
    weight = 1
    for d in range(ndim):
        idx_shape = [1] * ndim
        idx_shape[d] = shape[d]
        idx = torch.arange(shape[d], device=device).reshape(idx_shape)
        cell_color = cell_color + (idx % strides[d]) * weight
        weight *= strides[d]
    diag = torch.zeros(shape, dtype=dtype, device=device)
    for c0 in range(0, ncolors, chunk):
        colors = torch.arange(c0, min(c0 + chunk, ncolors), device=device)
        e = (cell_color[None] == colors.reshape(-1, *[1] * ndim)).to(dtype)
        diag = diag + (Afn(e) * e).sum(dim=0)
    return diag


def _null_vector(shape: tuple[int, ...], dtype,
                 device: str | torch.device = "cpu") -> torch.Tensor:
    """The one null vector of A = D D^T: a 2^ndim alternating-sign block at
    the far corner, where the replicated last slices of every axis meet
    (T's rows n-1 and n-2 coincide, so T^T annihilates their alternating
    combination).  A is otherwise nonsingular.  D^T maps this to zero, so
    it never touches the projected velocity; it is deflated from the RHS
    and absorbed by the coarsest level's pinv cutoff."""
    z = torch.zeros(shape, dtype=dtype)
    ndim = len(shape)
    for corner in range(2 ** ndim):
        idx, sign = [], 1.0
        for d in range(ndim):
            bit = (corner >> d) & 1
            idx.append(shape[d] - 2 + bit)
            sign *= -1.0 if bit else 1.0
        z[tuple(idx)] = sign
    return (z / torch.linalg.vector_norm(z)).to(device)


def _deflate(q: torch.Tensor, z: torch.Tensor | None) -> torch.Tensor:
    """``q [S, *shape]`` minus each scene's component along ``z``."""
    if z is None:
        return q
    dims = tuple(range(1, q.dim()))
    return q - (z * q).sum(dim=dims, keepdim=True) * z


def _coarsenable(shape: tuple[int, ...], min_cells: int) -> bool:
    cells = 1
    for n in shape:
        cells *= n // 2
    return all(n % 2 == 0 and n >= 6 for n in shape) and cells >= min_cells


def _chunked_probe(Afn, shape, dtype, chunk: int = 64,
                   device: str | torch.device = "cpu") -> torch.Tensor:
    """Dense matrix of a linear operator on ``shape`` (column probing,
    batched in chunks to bound the transient footprint)."""
    n = 1
    for s_ in shape:
        n *= s_
    rows = []
    for i in range(0, n, chunk):
        k = min(chunk, n - i)
        e = torch.zeros((k, n), dtype=dtype, device=device)
        e[torch.arange(k), i + torch.arange(k)] = 1.0
        rows.append(Afn(e.reshape(k, *shape)).reshape(k, n))
    return torch.cat(rows, dim=0).T.contiguous()


def _prolong_matrix(n_fine: int, n_coarse: int, dtype,
                    device: str | torch.device = "cpu") -> torch.Tensor:
    """``[n_fine, n_coarse]`` weights of a linear resize with half-pixel
    centres: fine sample i sits at coarse coordinate ``(i + 0.5) *
    n_coarse / n_fine - 0.5`` and takes the triangle weights of its two
    neighbours; a tap outside the grid is dropped and the row renormalized
    (for a factor 2 that is a clamp to the edge)."""
    at = (torch.arange(n_fine, dtype=torch.float64) + 0.5) * (
        n_coarse / n_fine) - 0.5
    taps = torch.arange(n_coarse, dtype=torch.float64)
    w = (1.0 - (at[:, None] - taps[None, :]).abs()).clamp_(min=0.0)
    w = w / w.sum(dim=1, keepdim=True)
    return w.to(dtype).to(device)


def _apply_axis(x: torch.Tensor, mat: torch.Tensor, axis: int
                ) -> torch.Tensor:
    """``mat [n_out, n_in]`` applied along ``axis`` (negative) of ``x``."""
    if axis == -1:
        return x @ mat.T
    lead, trail = x.shape[:axis], x.shape[axis + 1:]
    out = mat @ x.reshape(-1, x.shape[axis], trail.numel())
    return out.reshape(*lead, mat.shape[0], *trail)


# Registered fine-grid operators the MG core can solve.
# name -> (factory(shape, dtype, device) -> A_fn, has_corner_null,
#          has_channel_axis)
# has_channel_axis: the last axis is a component axis (3D vector
# potential), never coarsened, colored densely in the diag probe.
_OPERATORS = {
    "div_lap": (lambda shape, dtype, device:
                (lambda p: matched_laplacian(p, len(shape))), True, False),
    "curl_ls": (curl_ls_operator, False, False),
    "curl3_ls": (curl3_ls_operator, False, True),
}


def _mg_setup(op_name: str, shape: tuple[int, ...], dtype: torch.dtype,
              device: str | torch.device = "cpu",
              min_coarse_cells: int = 128) -> dict:
    """Build the variational hierarchy for a registered operator on
    ``shape``: built once on ``device`` with batched probes and cached per
    (operator, shape, dtype, device); the products (per-level diagonals,
    the damping factors, the coarsest pinv, the null vector, the
    prolongation matrices) stay there as tensors."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _mg_setup_cached(op_name, tuple(shape), dtype, str(device),
                            min_coarse_cells)


@functools.cache
def _mg_setup_cached(op_name, shape, dtype, device, min_coarse_cells
                     ) -> dict:
    factory, has_null, has_chan = _OPERATORS[op_name]
    with torch.no_grad():
        A0 = factory(shape, dtype, device)

        def coarsen(sh):
            sp = sh[:-1] if has_chan else sh
            if not _coarsenable(sp, min_coarse_cells):
                return None
            sp = tuple(n // 2 for n in sp)
            return sp + (sh[-1],) if has_chan else sp

        shapes = [shape]
        while (nxt := coarsen(shapes[-1])) is not None:
            shapes.append(nxt)
        return _mg_build(shape, dtype, device, has_null, has_chan, A0, shapes)


def _mg_build(shape, dtype, device, has_null, has_chan, A0, shapes):
    nsp = len(shape) - 1 if has_chan else len(shape)
    # spatial axes, counted from the end (the channel axis stays last)
    axes = [ax - (1 if has_chan else 0) for ax in range(-nsp, 0)]
    # prolong[lv][k]: [n_fine, n_coarse] along spatial axis k, level lv ->
    # lv - 1.  The restriction is the same matrices transposed.
    prolong = [None] + [
        [_prolong_matrix(shapes[lv - 1][k], shapes[lv][k], dtype, device)
         for k in range(nsp)] for lv in range(1, len(shapes))]

    def up(e, lv):
        for k, ax in enumerate(axes):
            e = _apply_axis(e, prolong[lv][k], ax)
        return e

    def down(r, lv):
        for k, ax in enumerate(axes):
            r = _apply_axis(r, prolong[lv][k].T, ax)
        return r

    def make_A(level):
        def A(e):
            # prolong through every finer level, apply the fine operator,
            # restrict back down: A_k = P_1^T...P_k^T A P_k...P_1  (exact
            # Galerkin)
            for lv in range(level, 0, -1):
                e = up(e, lv)
            e = A0(e)
            for lv in range(1, level + 1):
                e = down(e, lv)
            return e
        return A

    A_fns = [make_A(lv) for lv in range(len(shapes))]

    def strides_for(sh):
        if not has_chan:
            return (4,) * len(sh)
        return (4,) * (len(sh) - 1) + (sh[-1],)

    fine_cells = 1
    for n in shape:
        fine_cells *= n
    chunk = _probe_chunk(fine_cells)
    diags = [_op_diag(A_fns[lv], shapes[lv], dtype, strides_for(shapes[lv]),
                      device=device, chunk=chunk)
             for lv in range(len(shapes) - 1)]

    # Per-level damping from a measured lambda_max of diag^-1 A: the safe
    # bound is omega < 2/lambda_max, and lambda_max is operator- and
    # dimension-dependent (2.41 for the 2D operators, 2.96 for the 3D curl
    # normal operator: a fixed 0.7/0.8 diverges there).  The start vector
    # is numpy's stream, as in the JAX package.
    def _lambda_max(Afn, diag, sh):
        x = torch.as_tensor(np.random.default_rng(0).standard_normal(sh)
                            ).to(dtype).to(device)[None]
        for _ in range(60):
            x = Afn(x) / diag
            x = x / torch.linalg.vector_norm(x)
        return float((x * (Afn(x) / diag)).sum())

    omegas = [min(0.9, 1.5 / _lambda_max(A_fns[lv], diags[lv], shapes[lv]))
              for lv in range(len(shapes) - 1)]
    dense = _chunked_probe(A_fns[-1], shapes[-1], dtype, chunk=chunk,
                           device=device)
    pinv = torch.linalg.pinv(dense, rtol=1e-6)
    return {"shapes": shapes, "A_fns": A_fns, "diags": diags, "pinv": pinv,
            "omegas": omegas, "up": up, "down": down,
            "null": _null_vector(shape, dtype, device) if has_null else None}


def _vcycle(b: torch.Tensor, x: torch.Tensor, setup: dict, level: int,
            nu: int = 2) -> torch.Tensor:
    """One V(nu,nu)-cycle on the variational hierarchy for ``[S, *shape]``
    right-hand sides (coarsest level solved exactly via the probed
    pinv)."""
    shapes, A = setup["shapes"], setup["A_fns"][level]

    if level == len(shapes) - 1:
        e = (b.reshape(b.shape[0], -1) @ setup["pinv"].T).reshape(b.shape)
        return x + e

    diag = setup["diags"][level]
    omega = setup["omegas"][level]

    def smooth(x, n):
        for _ in range(n):
            x = x + omega * (b - A(x)) / diag
        return x

    x = smooth(x, nu)
    rc = setup["down"](b - A(x), level + 1)
    ec = _vcycle(rc, torch.zeros_like(rc), setup, level + 1, nu)
    x = x + setup["up"](ec, level + 1)
    return smooth(x, nu)


def _mg_solve(op_name: str, b: torch.Tensor, cycles: int,
              shape: tuple[int, ...] | None = None) -> torch.Tensor:
    """``cycles`` V-cycles on ``b [*B, *shape]`` from a zero start;
    ``shape`` (default: all of ``b``) are the operator's axes, anything in
    front of them is batch."""
    shape = tuple(b.shape) if shape is None else tuple(shape)
    _through_kernels(b)                  # float32 or float64, else raises
    setup = _mg_setup(op_name, shape, b.dtype, b.device)
    rhs = _deflate(b.reshape(-1, *shape), setup["null"])
    x = torch.zeros_like(rhs)
    for _ in range(cycles):
        x = _vcycle(rhs, x, setup, 0)
    return x.reshape(b.shape)


# ---------------------------------------------------------------------------
# Public projections
# ---------------------------------------------------------------------------

@torch.no_grad()
def solve_matched(b: torch.Tensor, cycles: int = 10,
                  ndim: int | None = None) -> torch.Tensor:
    """Approximately solve (D D^T) p = b with ``cycles`` V-cycles; the
    last ``ndim`` axes of ``b`` (default: all) are the grid's."""
    shape = b.shape if ndim is None else b.shape[b.dim() - ndim:]
    return _mg_solve("div_lap", b, cycles, shape)


@torch.no_grad()
def project_matched(vel: torch.Tensor, cycles: int = 10) -> torch.Tensor:
    """Orthogonal projection of vel [..., *S, ndim] onto ker(div_f).  Does
    NOT constrain wall-normal flow: pair with external wall BCs (which
    knock the result slightly off-manifold); prefer :func:`project_curl2d`
    for dataset generation."""
    ndim = vel.shape[-1]
    p = solve_matched(div_f(vel), cycles=cycles, ndim=ndim)
    return vel - div_f_adj(p, ndim)


@torch.no_grad()
def project_curl3d(vel: torch.Tensor, cycles: int = 10,
                   return_psi: bool = False):
    """3D discrete Leray projection of vel [..., D, H, W, 3]: least-squares
    fit of a vector potential with Psi = 0 on the boundary shell, returning
    curl3d(Psi), exactly on the 3D generator's manifold with zero wall
    through-flow (see :func:`curl3_ls_operator` for the gauge story)."""
    shape = tuple(vel.shape[-4:])
    m = _ring_mask(shape[:-1], vel.dtype, vel.device)[..., None]
    b = m * _curl3_adj(vel)
    psi = m * _mg_solve("curl3_ls", b, cycles, shape)
    out = _curl3(psi)
    return (out, psi) if return_psi else out


@torch.no_grad()
def project_curl2d(vel: torch.Tensor, cycles: int = 10,
                   return_psi: bool = False):
    """Discrete Leray projection of vel [..., H, W, 2] for the closed box:
    least-squares fit of a stream function with psi = 0 on the boundary,
    returning curl(psi), EXACTLY on the generator's manifold (range of
    ``ops.fd.curl2d``) and with exactly zero wall through-flow, so no
    trailing wall BC is needed (or wanted: it would leave the manifold)."""
    shape = tuple(vel.shape[-3:-1])
    m = _ring_mask(shape, vel.dtype, vel.device)
    b = m * _curl_adj(vel)
    psi = m * _mg_solve("curl_ls", b, cycles, shape)
    out = _curl(psi)
    return (out, psi) if return_psi else out
