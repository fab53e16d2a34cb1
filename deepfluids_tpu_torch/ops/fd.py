"""Finite-difference differential operators in plain PyTorch (2D and 3D).

Counterpart of :mod:`deepfluids_tpu.ops.fd`, with the same discretization
and the same channels-last layouts, ``[..., H, W, C]`` in 2D and
``[..., D, H, W, C]`` in 3D (D = z, H = y, W = x):

  * every derivative is a FORWARD difference, ``d[i] = x[i+1] - x[i]``;
  * the lost last sample along the differenced axis is restored by edge
    replication of the final derivative, ``d[n-1] = d[n-2]``.

The backward functions (:func:`fdt`, :func:`curl2d_bwd`,
:func:`jacobian2d_bwd`, :func:`curl3d_bwd`, :func:`jacobian3d_bwd`) apply
the TRANSPOSED stencil, as ``pallas_fd._fdt`` / ``_fdt_z`` do, and need
every differenced extent >= 3.

These functions are the CPU path of every kernel wrapper in
:mod:`deepfluids_tpu_torch.ops.cuda_fd` and the reference the kernels are
held against on the card.  The forward ones are differentiable by autograd.
"""

from __future__ import annotations

import torch


def _fdiff(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Forward difference along ``dim``, keeping shape via edge replication."""
    d = torch.diff(x, dim=dim)
    return torch.cat([d, d.narrow(dim, d.shape[dim] - 1, 1)], dim=dim)


def fdt(d: torch.Tensor, dim: int) -> torch.Tensor:
    """Transpose of :func:`_fdiff` along ``dim`` (the cotangent of its input).

    With n the extent of ``dim`` (n >= 3):

      x[j]   = d[j-1] - d[j]              (interior)
      x[0]   = -d[0]
      x[n-2] = d[n-3] - d[n-2] - d[n-1]
      x[n-1] = d[n-2] + d[n-1]
    """
    n = d.shape[dim]
    if n < 3:
        raise ValueError(f"fdt needs an extent >= 3 along dim {dim}, got {n}")

    def at(j: int, length: int = 1) -> torch.Tensor:
        return d.narrow(dim, j, length)

    return torch.cat([-at(0),
                      at(0, n - 3) - at(1, n - 3),
                      at(n - 3) - at(n - 2) - at(n - 1),
                      at(n - 2) + at(n - 1)], dim=dim)


def curl2d(psi: torch.Tensor) -> torch.Tensor:
    """2D curl of a stream function: ``u = dpsi/dy``, ``v = -dpsi/dx``.

    Args:
      psi: ``[..., H, W, 1]`` stream function.
    Returns:
      ``[..., H, W, 2]`` velocity, divergence-free under
      :func:`divergence2d` away from the replicated edge.
    """
    p = psi[..., 0]
    return torch.stack([_fdiff(p, -2), -_fdiff(p, -1)], dim=-1)


def jacobian2d(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """All first derivatives of ``[..., H, W, 2]`` velocity, plus vorticity.

    Returns ``(J, w)``: J ``[..., H, W, 4]`` = ``(dudx, dudy, dvdx, dvdy)``
    and w ``[..., H, W, 1]`` = ``dvdx - dudy``.
    """
    u, v = x[..., 0], x[..., 1]
    dudx, dudy = _fdiff(u, -1), _fdiff(u, -2)
    dvdx, dvdy = _fdiff(v, -1), _fdiff(v, -2)
    j = torch.stack([dudx, dudy, dvdx, dvdy], dim=-1)
    return j, (dvdx - dudy)[..., None]


def curl2d_bwd(g: torch.Tensor) -> torch.Tensor:
    """VJP of :func:`curl2d`: velocity cotangent ``[..., H, W, 2]`` ->
    stream-function cotangent ``[..., H, W, 1]``,
    ``psi_bar = fdt_y(u_bar) - fdt_x(v_bar)``."""
    return (fdt(g[..., 0], -2) - fdt(g[..., 1], -1))[..., None]


def jacobian2d_bwd(gj: torch.Tensor, gw: torch.Tensor) -> torch.Tensor:
    """VJP of :func:`jacobian2d`: cotangents of J ``[..., H, W, 4]`` and of
    the vorticity ``[..., H, W, 1]`` -> velocity cotangent ``[..., H, W, 2]``:

      u_bar = fdt_x(J0) + fdt_y(J1) - fdt_y(w_bar)
      v_bar = fdt_x(J2) + fdt_y(J3) + fdt_x(w_bar)
    """
    w = gw[..., 0]
    u = fdt(gj[..., 0], -1) + fdt(gj[..., 1], -2) - fdt(w, -2)
    v = fdt(gj[..., 2], -1) + fdt(gj[..., 3], -2) + fdt(w, -1)
    return torch.stack([u, v], dim=-1)


def vorticity2d(x: torch.Tensor) -> torch.Tensor:
    """Scalar vorticity ``dvdx - dudy`` of ``[..., H, W, 2]``."""
    return (_fdiff(x[..., 1], -1) - _fdiff(x[..., 0], -2))[..., None]


def divergence2d(x: torch.Tensor) -> torch.Tensor:
    """Forward-difference divergence ``dudx + dvdy`` of ``[..., H, W, 2]``,
    matched to :func:`curl2d` so ``divergence2d(curl2d(psi))`` is zero in
    the interior."""
    return (_fdiff(x[..., 0], -1) + _fdiff(x[..., 1], -2))[..., None]


# 3D: axes of [..., D, H, W]: z = -3, y = -2, x = -1.

def curl3d(psi: torch.Tensor) -> torch.Tensor:
    """3D curl of a vector potential ``(a, b, c)``:
    ``u = dc/dy - db/dz``, ``v = da/dz - dc/dx``, ``w = db/dx - da/dy``.

    Args:
      psi: ``[..., D, H, W, 3]`` vector potential.
    Returns:
      ``[..., D, H, W, 3]`` velocity ``(u, v, w)``, divergence-free under
      :func:`divergence3d` away from the replicated edge.
    """
    a, b, c = psi[..., 0], psi[..., 1], psi[..., 2]
    u = _fdiff(c, -2) - _fdiff(b, -3)
    v = _fdiff(a, -3) - _fdiff(c, -1)
    w = _fdiff(b, -1) - _fdiff(a, -2)
    return torch.stack([u, v, w], dim=-1)


def jacobian3d(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """All 9 first derivatives of ``[..., D, H, W, 3]`` velocity, plus the
    vorticity vector.

    Returns ``(J, vort)``: J ``[..., D, H, W, 9]`` = ``(dudx, dudy, dudz,
    dvdx, dvdy, dvdz, dwdx, dwdy, dwdz)`` and vort ``[..., D, H, W, 3]`` =
    ``(dwdy - dvdz, dudz - dwdx, dvdx - dudy)``.
    """
    du = [_fdiff(x[..., 0], d) for d in (-1, -2, -3)]
    dv = [_fdiff(x[..., 1], d) for d in (-1, -2, -3)]
    dw = [_fdiff(x[..., 2], d) for d in (-1, -2, -3)]
    j = torch.stack(du + dv + dw, dim=-1)
    vort = torch.stack([dw[1] - dv[2], du[2] - dw[0], dv[0] - du[1]], dim=-1)
    return j, vort


def curl3d_bwd(g: torch.Tensor) -> torch.Tensor:
    """VJP of :func:`curl3d`: velocity cotangent ``[..., D, H, W, 3]`` ->
    vector-potential cotangent ``[..., D, H, W, 3]``:

      a_bar = fdt_z(v_bar) - fdt_y(w_bar)
      b_bar = fdt_x(w_bar) - fdt_z(u_bar)
      c_bar = fdt_y(u_bar) - fdt_x(v_bar)
    """
    gu, gv, gw = g[..., 0], g[..., 1], g[..., 2]
    return torch.stack([fdt(gv, -3) - fdt(gw, -2),
                        fdt(gw, -1) - fdt(gu, -3),
                        fdt(gu, -2) - fdt(gv, -1)], dim=-1)


def jacobian3d_bwd(gj: torch.Tensor, gv: torch.Tensor) -> torch.Tensor:
    """VJP of :func:`jacobian3d`: cotangents of J ``[..., D, H, W, 9]`` and
    of the vorticity ``[..., D, H, W, 3]`` -> velocity cotangent
    ``[..., D, H, W, 3]``.

    The vorticity is linear in J, so its cotangent is folded into J's first
    (J7 += v0, J5 -= v0, J2 += v1, J6 -= v1, J3 += v2, J1 -= v2, as
    ``pallas_fd._jacobian3d_p_bwd`` does); then each source channel k gets
    ``fdt_x(J[3k]) + fdt_y(J[3k+1]) + fdt_z(J[3k+2])``.
    """
    g = list(gj.unbind(-1))
    v0, v1, v2 = gv.unbind(-1)
    g[7], g[5] = g[7] + v0, g[5] - v0
    g[2], g[6] = g[2] + v1, g[6] - v1
    g[3], g[1] = g[3] + v2, g[1] - v2
    return torch.stack([fdt(g[3 * k], -1) + fdt(g[3 * k + 1], -2)
                        + fdt(g[3 * k + 2], -3) for k in range(3)], dim=-1)


def vorticity3d(x: torch.Tensor) -> torch.Tensor:
    """Vorticity vector of ``[..., D, H, W, 3]`` velocity."""
    return jacobian3d(x)[1]


def divergence3d(x: torch.Tensor) -> torch.Tensor:
    """Forward-difference divergence of ``[..., D, H, W, 3]``, matched to
    :func:`curl3d`."""
    return (_fdiff(x[..., 0], -1) + _fdiff(x[..., 1], -2)
            + _fdiff(x[..., 2], -3))[..., None]
