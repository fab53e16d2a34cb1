"""Collectives of the parallel layer, over ``torch.distributed``.

One axis of the layout (:mod:`.mesh`) is a :class:`Shard`: the process
group of the ranks on it, this rank's index there and the axis size.  A
shard of one rank (no group) makes every function here the identity.

Transport.  Every exchange of rows or channels goes through
:func:`gather_slots`, which collects one tensor from each rank of a group:
``all_gather_into_tensor`` under NCCL; under gloo an ``all_reduce`` of a
zero buffer with one slot per rank, each rank filling its own, because
gloo's ``all_gather`` does not take CUDA tensors while its ``all_reduce``
does.  A value summed with zeros is itself, so both give the same bits (a
``-0.0`` comes back as ``0.0``).  Under gloo a bfloat16 or float16 tensor
travels as float32, which it converts to and from exactly.  Either way the
kernels and layers still run on the rank's own device: gloo carries the
bytes, it computes nothing of the model.

The autograd Functions encode two rules for a replicated tensor downstream
of a collective:

  * under ``--spatial_shard`` each rank backpropagates only its own share
    of the loss, so the cotangent of a replicated tensor is a partial sum
    on each rank and the total over the group: :func:`gather_rows` and
    :func:`all_reduce_sum` sum cotangents in their backward;
  * under ``--num_model_shards`` every rank of a model group computes the
    same loss, so the cotangent of a replicated tensor is the whole of it
    on every rank: :func:`gather_channels` keeps the rank's own slice of it
    (``torch.distributed.nn.functional.all_gather`` would sum the slices,
    giving m times the gradient), and :func:`copy_to_model` sums the
    partial input cotangents of a channel-sharded layer.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

_WIRE_DTYPES = (torch.float32, torch.float64)


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's place on one axis of the layout: the process ``group``
    (None when the axis has one rank), the rank's ``index`` on it and the
    axis ``size``."""
    group: Any = None
    index: int = 0
    size: int = 1

    @property
    def active(self) -> bool:
        return self.size > 1


SINGLE = Shard()


def _backend(shard: Shard) -> str:
    return dist.get_backend(shard.group)


def gather_slots(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """``[size, *t.shape]``: ``t`` of every rank of ``shard``, in rank
    order (the same on every rank)."""
    t = t.contiguous()
    if not shard.active:
        return t[None]
    if _backend(shard) == "nccl":
        out = t.new_empty((shard.size,) + tuple(t.shape))
        dist.all_gather_into_tensor(out, t, group=shard.group)
        return out
    wire = t if t.dtype in _WIRE_DTYPES else t.float()
    out = wire.new_zeros((shard.size,) + tuple(t.shape))
    out[shard.index] = wire
    dist.all_reduce(out, group=shard.group)
    return out.to(t.dtype)


def all_reduce_(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """Sum ``t`` over ``shard``'s ranks, in place; returns ``t``."""
    if not shard.active:
        return t
    if _backend(shard) == "nccl" or t.dtype in _WIRE_DTYPES:
        dist.all_reduce(t, group=shard.group)
        return t
    wire = t.float()
    dist.all_reduce(wire, group=shard.group)
    return t.copy_(wire)


def _cat_slots(slots: torch.Tensor, dim: int) -> torch.Tensor:
    """``[n, *shape]`` -> the n pieces concatenated along ``dim``."""
    return slots.movedim(0, dim).flatten(dim, dim + 1)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return all_reduce_(x.clone(), shard)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.shard), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim, ctx.rows = shard, dim, x.shape[dim]
        return _cat_slots(gather_slots(x, shard), dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.shard)
        return (g.narrow(ctx.dim, ctx.shard.index * ctx.rows,
                         ctx.rows).contiguous(), None, None)


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim, ctx.width = shard, dim, x.shape[dim]
        return _cat_slots(gather_slots(x, shard), dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.shard.index * ctx.width,
                         ctx.width).contiguous(), None, None)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.shard), None


def all_reduce_sum(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The sum of ``x`` over ``shard``; its backward sums the cotangents
    (spatial rule: each rank holds a part of the total's cotangent)."""
    return _AllReduceSum.apply(x, shard) if shard.active else x


def split_rows(x: torch.Tensor, shard: Shard, dim: int) -> torch.Tensor:
    """This rank's block of rows of a replicated ``x`` along ``dim`` (its
    backward places the rows' cotangent in zeros)."""
    if not shard.active:
        return x
    rows = x.shape[dim] // shard.size
    return x.narrow(dim, shard.index * rows, rows)


def gather_rows(x: torch.Tensor, shard: Shard, dim: int) -> torch.Tensor:
    """The rows of every rank concatenated along ``dim`` (the inverse of
    :func:`split_rows`); its backward sums the partial cotangents over the
    group and keeps the rank's rows (spatial rule)."""
    return _GatherRows.apply(x, shard, dim) if shard.active else x


def gather_channels(x: torch.Tensor, shard: Shard,
                    dim: int = 1) -> torch.Tensor:
    """The channel slices of every rank concatenated along ``dim``; its
    backward keeps the rank's slice of the (identical) cotangent (tensor
    parallel rule)."""
    return _GatherChannels.apply(x, shard, dim) if shard.active else x


def copy_to_model(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """``x`` itself; its backward sums the cotangents of the model group's
    ranks, each of which holds the part its output channels gave."""
    return _CopyToModel.apply(x, shard) if shard.active else x


def global_mean(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The mean of ``t`` over every rank's copy (equal sizes), without
    autograd: the mean of a global batch split over ``shard``."""
    if not shard.active:
        return torch.mean(t)
    s = all_reduce_(torch.sum(t.detach()).reshape(1), shard)[0]
    return s / (t.numel() * shard.size)
