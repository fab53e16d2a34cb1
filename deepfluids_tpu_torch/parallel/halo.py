"""Spatially sharded finite differences with halo rows.

Counterpart of :mod:`deepfluids_tpu.parallel.halo`.  Under
``--spatial_shard`` a field's axis 1 (H of ``[B, H, W, C]``, D of ``[B, D,
H, W, C]``) is split into equal blocks of rows, one per rank of the data
group (a :class:`.comm.Shard`).  The forward difference ``d[j] = x[j+1] -
x[j]`` of a block's last row needs the successor's first row, and the
global last row (the edge-replicated ``d[n-1] = d[n-2]``) needs the row
before it, which lies on the predecessor when a block holds one row.

Each stencil runs the existing kernel (:mod:`..ops.cuda_fd`; its plain
version on the CPU) on the haloed block and keeps the block's rows:

  * forward: ``cat([block, successor's first row])`` (the global last block
    uses the kernel's own edge replication, after ``cat([predecessor's last
    row, block])`` when it holds one row);
  * backward: the transposed stencil reads the cotangent at ``j - 1``, so
    the backward kernel runs on ``cat([predecessor's last cotangent row,
    block, tail])``, with ``tail`` the successor's first cotangent row when
    that row is the global last one (``fdt`` at ``n - 2`` reads ``n - 1``)
    and zero rows otherwise.

Each kept row then meets the same case of the stencil, with the same
operands, as in the whole field, so the result is bit for bit the
whole-field kernel's, forward and backward, at any number of blocks down
to one row each.  The exchange of each direction is one collective
(:func:`neighbour_rows`).  ``grad_scalar`` and ``divergence`` are plain
torch, as they are jnp in the reference.
"""

from __future__ import annotations

from typing import Callable

import torch

from deepfluids_tpu_torch.ops import cuda_fd, fd
from deepfluids_tpu_torch.parallel.comm import Shard, gather_slots

Rows = tuple[torch.Tensor | None, torch.Tensor | None]


def neighbour_rows(x: torch.Tensor, shard: Shard, dim: int = 1) -> Rows:
    """``(predecessor's last row, successor's first row)`` of ``x`` along
    ``dim``, each keeping ``dim`` with extent 1; None at the global
    edges.  One collective over ``shard``."""
    if not shard.active:
        return None, None
    last = x.shape[dim] - 1
    edges = torch.stack([x.narrow(dim, 0, 1), x.narrow(dim, last, 1)])
    slots = gather_slots(edges, shard)                # [n, 2, ...]
    i, n = shard.index, shard.size
    return (slots[i - 1, 1] if i > 0 else None,
            slots[i + 1, 0] if i < n - 1 else None)


def halo_forward(fwd: Callable, x: torch.Tensor, rows: Rows, index: int,
                 size: int):
    """``fwd`` (a forward kernel) on block ``index`` of ``size`` along axis
    1, given its neighbours' boundary ``rows`` (:func:`neighbour_rows`);
    the outputs kept to the block's rows."""
    h, (prev, nxt) = x.shape[1], rows
    front = size > 1 and index == size - 1 and h == 1  # last, one row
    parts = ([prev] if front else []) + [x] + (
        [nxt] if index < size - 1 else [])
    out = fwd(torch.cat(parts, dim=1))
    if isinstance(out, tuple):
        return tuple(_keep(o, int(front), h) for o in out)
    return _keep(out, int(front), h)


def halo_backward(bwd: Callable, gs: list[torch.Tensor | None],
                  rows: list[Rows], index: int, size: int) -> torch.Tensor:
    """``bwd`` (a backward kernel) on the cotangents ``gs`` of block
    ``index`` of ``size``, given each one's neighbour ``rows``; the result
    kept to the block's rows (see the module docstring)."""
    g0 = next(g for g in gs if g is not None)
    i, n, h = index, size, g0.shape[1]
    last_one = n > 1 and i == n - 1 and h == 1
    ext = []
    for g, (prev, nxt) in zip(gs, rows):
        if g is None:
            ext.append(None)
            continue
        zero = torch.zeros_like(g.narrow(1, 0, 1))
        # a block of one row at the end: the kernel wants >= 3 rows
        front = ([zero] if last_one else []) + ([] if i == 0 else [prev])
        tail = ([] if i == n - 1 else [nxt] if i == n - 2 and h == 1
                else [zero, zero])
        ext.append(torch.cat(front + [g] + tail, dim=1))
    start = (0 if i == 0 else 1) + int(last_one)
    return _keep(bwd(*ext), start, h)


def _keep(t: torch.Tensor, start: int, h: int) -> torch.Tensor:
    return t.narrow(1, start, h).contiguous()


class _Haloed(torch.autograd.Function):
    """``fwd`` on the haloed block, and ``bwd`` on the haloed cotangents in
    the backward, the neighbours' rows fetched over ``shard``."""

    @staticmethod
    def forward(ctx, x, shard, fwd, bwd):
        ctx.set_materialize_grads(False)
        ctx.shard, ctx.bwd = shard, bwd
        return halo_forward(fwd, x, neighbour_rows(x, shard), shard.index,
                            shard.size)

    @staticmethod
    def backward(ctx, *gs):
        if all(g is None for g in gs):
            return None, None, None, None
        gs = [None if g is None else g.contiguous() for g in gs]
        rows = [(None, None) if g is None else neighbour_rows(g, ctx.shard)
                for g in gs]
        return (halo_backward(ctx.bwd, gs, rows, ctx.shard.index,
                              ctx.shard.size), None, None, None)


def _stencil(x: torch.Tensor, shard: Shard | None, whole: Callable,
             fwd: Callable, bwd: Callable, name: str):
    """``whole(x)`` (the kernel's autograd wrapper) on one rank; else the
    haloed kernels, checking the global extents the backward needs."""
    if shard is None or not shard.active:
        return whole(x)
    if x.requires_grad and torch.is_grad_enabled():
        spatial = (x.shape[1] * shard.size,) + tuple(x.shape[2:-1])
        if min(spatial) < 3:
            raise ValueError(f"{name}: spatial dims {spatial} must all be "
                             ">= 3 (the transposed stencil)")
    return _Haloed.apply(x, shard, fwd, bwd)


def _jac2d_bwd(gj, gw):
    if gj is None:
        gj = gw.new_zeros(gw.shape[:-1] + (4,))
    return cuda_fd.jacobian2d_bwd(gj, gw)


def _jac3d_bwd(gj, gv):
    if gj is None:
        gj = gv.new_zeros(gv.shape[:-1] + (9,))
    return cuda_fd.jacobian3d_bwd(gj, gv)


def curl2d_sharded(psi: torch.Tensor, shard: Shard | None) -> torch.Tensor:
    """H-sharded curl: ``[B, H/n, W, 1]`` -> ``[B, H/n, W, 2]`` through the
    ``curl2d`` kernels (:func:`cuda_fd.curl2d_p` on one rank)."""
    return _stencil(psi.contiguous(), shard, cuda_fd.curl2d_p,
                    cuda_fd.curl2d_fused, cuda_fd.curl2d_bwd,
                    "curl2d_sharded")


def jacobian2d_sharded(x: torch.Tensor, shard: Shard | None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """H-sharded ``(J [B, H/n, W, 4], vort [B, H/n, W, 1])`` through the
    ``jacobian2d`` kernels."""
    return _stencil(x.contiguous(), shard, cuda_fd.jacobian2d_p,
                    cuda_fd.jacobian2d_fused, _jac2d_bwd,
                    "jacobian2d_sharded")


def curl3d_sharded(psi: torch.Tensor, shard: Shard | None) -> torch.Tensor:
    """D-sharded 3D curl ``[B, D/n, H, W, 3]`` through the ``curl3d``
    kernels."""
    return _stencil(psi.contiguous(), shard, cuda_fd.curl3d_p,
                    cuda_fd.curl3d_fused, cuda_fd.curl3d_bwd,
                    "curl3d_sharded")


def jacobian3d_sharded(x: torch.Tensor, shard: Shard | None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """D-sharded ``(J [B, D/n, H, W, 9], vort [B, D/n, H, W, 3])`` through
    the ``jacobian3d`` kernels."""
    return _stencil(x.contiguous(), shard, cuda_fd.jacobian3d_p,
                    cuda_fd.jacobian3d_fused, _jac3d_bwd,
                    "jacobian3d_sharded")


def curl_sharded(psi: torch.Tensor, shard: Shard | None) -> torch.Tensor:
    """2D psi / 3D Psi by rank."""
    return (curl2d_sharded if psi.dim() == 4 else curl3d_sharded)(psi, shard)


def jacobian_sharded(x: torch.Tensor, shard: Shard | None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """2D / 3D sharded jacobian (and vorticity) by rank."""
    return (jacobian2d_sharded if x.dim() == 4 else jacobian3d_sharded)(
        x, shard)


class _RowHalo(torch.autograd.Function):
    """``cat([predecessor's last row, x, successor's first row])`` along
    ``dim`` (zero rows at the global edges; ``before`` / ``after`` pick
    the sides); the backward adds each halo row's cotangent into the row
    it came from, on the rank that holds it."""

    @staticmethod
    def forward(ctx, x, shard, dim, before, after):
        ctx.shard, ctx.dim, ctx.before, ctx.after = shard, dim, before, after
        prev, nxt = neighbour_rows(x, shard, dim)
        zero = torch.zeros_like(x.narrow(dim, 0, 1))
        parts = (([zero if prev is None else prev] if before else []) + [x]
                 + ([zero if nxt is None else nxt] if after else []))
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        shard, dim = ctx.shard, ctx.dim
        b, a = int(ctx.before), int(ctx.after)
        h = g.shape[dim] - b - a
        zero = torch.zeros_like(g.narrow(dim, 0, 1))
        # what goes back: [cotangent of my predecessor's last row, of my
        # successor's first row]
        back = torch.stack([g.narrow(dim, 0, 1) if b else zero,
                            g.narrow(dim, b + h, 1) if a else zero])
        slots = gather_slots(back, shard)
        out = g.narrow(dim, b, h).contiguous().clone()
        i, n = shard.index, shard.size
        if a and i > 0:
            out.narrow(dim, 0, 1).add_(slots[i - 1, 1])
        if b and i < n - 1:
            out.narrow(dim, h - 1, 1).add_(slots[i + 1, 0])
        return out, None, None, None, None


def row_halo(x: torch.Tensor, shard: Shard, dim: int, before: bool = True,
             after: bool = True) -> torch.Tensor:
    """``x`` with its neighbours' boundary rows along ``dim`` (zeros at the
    global edges), differentiable across ranks."""
    return _RowHalo.apply(x, shard, dim, before, after)


# -- plain torch, as jnp in the reference ---------------------------------

def _fdiff_sharded(x: torch.Tensor, shard: Shard | None) -> torch.Tensor:
    """Forward difference along sharded axis 1 with edge replication at
    the global end (plain torch, differentiable through :func:`row_halo`).
    """
    if shard is None or not shard.active:
        return fd._fdiff(x, 1)
    i, n, h = shard.index, shard.size, x.shape[1]
    ext = row_halo(x, shard, 1, before=True, after=True)  # [B, h + 2, ...]
    fwd = ext[:, 2:] - ext[:, 1:-1]                     # x[j+1] - x[j]
    if i < n - 1:
        return fwd
    bwd = ext[:, h:h + 1] - ext[:, h - 1:h]             # x[-1] - x[-2]
    return torch.cat([fwd[:, :-1], bwd], dim=1)


def divergence2d_sharded(x: torch.Tensor, shard: Shard | None
                         ) -> torch.Tensor:
    """H-sharded forward-difference divergence of ``[B, H/n, W, 2]``."""
    return (fd._fdiff(x[..., 0], -1)
            + _fdiff_sharded(x[..., 1], shard))[..., None]


def divergence3d_sharded(x: torch.Tensor, shard: Shard | None
                         ) -> torch.Tensor:
    """D-sharded forward-difference divergence of ``[B, D/n, H, W, 3]``."""
    return (fd._fdiff(x[..., 0], -1) + fd._fdiff(x[..., 1], -2)
            + _fdiff_sharded(x[..., 2], shard))[..., None]


def grad_scalar_sharded(x: torch.Tensor, shard: Shard | None
                        ) -> torch.Tensor:
    """Sharded spatial gradient of a scalar field: 2D ``[B, H/n, W, 1]`` ->
    ``[B, H/n, W, 2]`` (d/dx, d/dy); 3D ``[B, D/n, H, W, 1]`` -> ``[B, D/n,
    H, W, 3]`` (x, y, z), the component order of ``losses._grad_scalar``."""
    s = x[..., 0]
    inplane = [fd._fdiff(s, -(k + 1)) for k in range(x.dim() - 3)]
    return torch.stack(inplane + [_fdiff_sharded(s, shard)], dim=-1)
