"""The model layers under a layout: convolutions over row-sharded feature
maps (``--spatial_shard``) and over channel-sharded weights
(``--num_model_shards``), and the dense layer that reads a row-sharded map.

Feature maps are indexed NC(D)HW and their sharded axis is dim 2 (H in 2D,
D in 3D), the axis 1 of the channels-last fields.  In memory the
generator's maps are channels-last (:func:`memory_format`), the layout of
cuDNN's tensor-core convs; a sharded map's halo and gathers make it
contiguous NC(D)HW, which the convs also take.  A map is sharded when that
extent divides by the group size (:func:`sharded`), otherwise replicated,
as the reference's ``spatial_constraint`` decides; the coarse maps of a
deep network are replicated, and a replicated map becomes sharded by
keeping the rank's rows (:func:`.comm.split_rows`).

A layer whose ``weight`` was cut on its output channels
(:func:`.mesh.shard_channels_`) carries ``tp_shard``: it computes its
channels from the whole input and gathers the others' (the bias is added
after the gather, so it stays replicated).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from deepfluids_tpu_torch.parallel.comm import (
    Shard,
    all_reduce_sum,
    copy_to_model,
    gather_channels,
    gather_rows,
    split_rows,
)
from deepfluids_tpu_torch.parallel.halo import row_halo

ROW_DIM = 2

# ``conv`` calls by the memory layout of their input: plain integers,
# counted where the Python runs (a captured CUDA graph counts once, at its
# capture), so a test can show the conv stack stays channels-last.
layout_counts: dict[str, int] = {"channels_last": 0, "other": 0}


def memory_format(ndim: int) -> torch.memory_format:
    """The channels-last format of a map (or conv weight) of ``ndim``
    dims: NHWC for 4, NDHWC for 5."""
    return torch.channels_last if ndim == 4 else torch.channels_last_3d


def is_channels_last(x: torch.Tensor) -> bool:
    return x.is_contiguous(memory_format=memory_format(x.dim()))


def sharded(extent: int, shard: Shard | None) -> bool:
    """Whether a map of ``extent`` rows is sharded over ``shard``."""
    return shard is not None and shard.active and extent % shard.size == 0


def enter(x: torch.Tensor, shard: Shard | None) -> torch.Tensor:
    """A replicated map -> the rank's rows when it is to be sharded."""
    return split_rows(x, shard, ROW_DIM) if sharded(x.shape[ROW_DIM],
                                                     shard) else x


def conv(x: torch.Tensor, layer: torch.nn.Module, dtype: torch.dtype,
         conv_fn: Callable, *, row_shard: Shard | None = None,
         stride: int = 1, padding: int | Sequence[int] = 1,
         bias: bool = True) -> torch.Tensor:
    """``conv_fn(x, layer.weight, layer.bias)`` in ``dtype``.

    ``row_shard``: ``x`` holds the rank's rows; a stride-1 conv of padding
    1 reads one halo row on each side (zeros at the global edges) and pads
    the other axes only.  A layer with ``tp_shard`` computes its output
    channels and gathers the rest.  ``bias=False`` leaves the bias out: a
    layer without one, or a conv whose bias the pass after it adds (the
    models' :func:`..models.activation.bias_leaky_relu`, given
    ``layer.bias.to(dtype)``).  Each call is counted in
    :data:`layout_counts` by its input's layout.
    """
    if row_shard is not None and row_shard.active:
        x = row_halo(x, row_shard, ROW_DIM)
        nd = x.dim() - 2
        padding = (0,) + (1,) * (nd - 1)
    layout_counts["channels_last" if is_channels_last(x) else "other"] += 1
    w = layer.weight.to(dtype)
    b = layer.bias.to(dtype) if bias and layer.bias is not None else None
    tp = getattr(layer, "tp_shard", None)
    if tp is None or not tp.active:
        return conv_fn(x, w, b, stride=stride, padding=padding)
    y = conv_fn(copy_to_model(x, tp), w, None, stride=stride,
                padding=padding)
    y = gather_channels(y, tp, 1)
    return y if b is None else y + b.view((1, -1) + (1,) * (y.dim() - 2))


def conv_down(x: torch.Tensor, layer: torch.nn.Module, dtype: torch.dtype,
              conv_fn: Callable, pads: Sequence[int],
              row_shard: Shard | None = None) -> tuple[torch.Tensor, bool]:
    """The encoder's stride-2 'SAME' conv (``F.pad`` widths ``pads``, last
    axis first) without its bias, which the activation after it adds ->
    ``(output, output is sharded)``.

    On a sharded map of an even number of rows a rank's output rows read
    its own and the successor's first row (the sharded axis pads ``(0,
    1)``), so it needs that row only; otherwise the map is gathered and the
    conv runs on every rank."""
    if row_shard is not None and row_shard.active:
        h = x.shape[ROW_DIM]
        if h % 2 == 0:
            x = row_halo(x, row_shard, ROW_DIM, before=False, after=True)
            pads = tuple(pads[:-2]) + (0, 0)
            out = conv(F.pad(x, pads), layer, dtype, conv_fn, stride=2,
                       padding=0, bias=False)
            return out, True
        x = gather_rows(x, row_shard, ROW_DIM)
    return conv(F.pad(x, tuple(pads)), layer, dtype, conv_fn, stride=2,
                padding=0, bias=False), False


def dense_rows(h: torch.Tensor, layer: torch.nn.Linear, dtype: torch.dtype,
               row_shard: Shard | None) -> torch.Tensor:
    """``layer`` on the channels-last flatten of a map ``[B, C, *spatial]``
    whose rows may be sharded: each rank multiplies its rows by their
    block of the weight's columns and the partial products are summed over
    the group before the bias is added."""
    flat = h.permute(0, *range(2, h.dim()), 1).reshape(h.shape[0], -1)
    w = layer.weight.to(dtype)
    b = layer.bias.to(dtype)
    if row_shard is None or not row_shard.active:
        return F.linear(flat, w, b)
    width = flat.shape[1]
    part = F.linear(flat, w.narrow(1, row_shard.index * width, width))
    return all_reduce_sum(part, row_shard) + b
