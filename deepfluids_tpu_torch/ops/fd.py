"""Finite-difference differential operators in plain PyTorch (2D).

Counterpart of :mod:`deepfluids_tpu.ops.fd`, with the same discretization
and the same channels-last layout ``[..., H, W, C]`` (H = y, W = x):

  * every derivative is a FORWARD difference, ``d[i] = x[i+1] - x[i]``;
  * the lost last sample along the differenced axis is restored by edge
    replication of the final derivative, ``d[n-1] = d[n-2]``.

These functions are the CPU path of every kernel wrapper in
:mod:`deepfluids_tpu_torch.ops.cuda_fd` and the reference the kernels are
held against on the card.  They are differentiable by autograd.
"""

from __future__ import annotations

import torch


def _fdiff(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Forward difference along ``dim``, keeping shape via edge replication."""
    d = torch.diff(x, dim=dim)
    return torch.cat([d, d.narrow(dim, d.shape[dim] - 1, 1)], dim=dim)


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


def vorticity2d(x: torch.Tensor) -> torch.Tensor:
    """Scalar vorticity ``dvdx - dudy`` of ``[..., H, W, 2]``."""
    return (_fdiff(x[..., 1], -1) - _fdiff(x[..., 0], -2))[..., None]


def divergence2d(x: torch.Tensor) -> torch.Tensor:
    """Forward-difference divergence ``dudx + dvdy`` of ``[..., H, W, 2]``,
    matched to :func:`curl2d` so ``divergence2d(curl2d(psi))`` is zero in
    the interior."""
    return (_fdiff(x[..., 0], -1) + _fdiff(x[..., 1], -2))[..., None]
