"""Flax parameters <-> this port's ``state_dict``.

Takes the flat ``{"<module>/<kernel|bias>": array}`` form of
``tools/weights_io.flatten_params`` (or an ``.npz`` of it, as
``weights_io.export_npz`` writes) and converts it by name.  A tensor's
layout follows its role, which its torch name gives:

  * a layer's ``weight``: a Linear's ``(out, in)`` is a Dense kernel
    ``(in, out)``; a Conv2d's OIHW / Conv3d's OIDHW is a Conv kernel HWIO /
    DHWIO;
  * a layer's ``bias``, as it is;
  * any other parameter is a raw table (the parameter grid's
    ``param_grid/grid_{l}``, the spectral gains ``spectral_{s}/gain_re``,
    the grid decoder's top-level ``basis_{s}``), kept in the Flax layout
    under its own name.

Like ``weights_io.import_npz(mode="exact")`` it raises on a missing, extra
or mis-shaped tensor, so a transposed kernel cannot load silently.
:func:`state_dict_to_flax` and :func:`save_flax_npz` go the other way, so a
run the port trains writes a ``weights.npz`` that the port's serving path
and ``weights_io.import_npz`` both read.
"""

from __future__ import annotations

import os
import tempfile
from typing import Mapping

import numpy as np
import torch
from torch import nn


def _flax_key(torch_key: str) -> str:
    """``a.b.weight`` -> ``a/b/kernel``, ``a.bias`` -> ``a/bias``, a raw
    table ``a.grid_0`` -> ``a/grid_0`` and a top-level ``basis_0`` ->
    ``basis_0``."""
    module, _, leaf = torch_key.rpartition(".")
    leaf = {"weight": "kernel"}.get(leaf, leaf)
    return f"{module.replace('.', '/')}/{leaf}" if module else leaf


def _layer_kernel(torch_key: str) -> bool:
    """Whether ``torch_key`` names a Linear or Conv weight (every other
    tensor keeps its layout)."""
    return torch_key.rpartition(".")[2] == "weight"


def _to_torch_layout(arr: np.ndarray, torch_key: str) -> np.ndarray:
    if not _layer_kernel(torch_key):
        return arr
    if arr.ndim == 2:      # Dense (in, out) -> Linear (out, in)
        return arr.T
    # Conv (*kernel, I, O) -> (O, I, *kernel)
    return arr.transpose(arr.ndim - 1, arr.ndim - 2, *range(arr.ndim - 2))


def _to_flax_layout(arr: np.ndarray, torch_key: str) -> np.ndarray:
    if not _layer_kernel(torch_key):
        return arr
    if arr.ndim == 2:      # Linear (out, in) -> Dense (in, out)
        return arr.T
    # Conv (O, I, *kernel) -> (*kernel, I, O)
    return arr.transpose(*range(2, arr.ndim), 1, 0)


def _template(model: nn.Module | Mapping[str, torch.Tensor]
              ) -> Mapping[str, torch.Tensor]:
    return model if isinstance(model, Mapping) else model.state_dict()


def flax_shapes(model: nn.Module | Mapping[str, torch.Tensor]
                ) -> dict[str, tuple[int, ...]]:
    """The flat Flax keys and shapes ``model`` (or a ``state_dict``
    template) expects, in module order."""
    return {_flax_key(key): _to_flax_layout(np.empty(tuple(t.shape), bool),
                                            key).shape
            for key, t in _template(model).items()}


def flax_to_state_dict(flat: Mapping[str, np.ndarray],
                       model: nn.Module | Mapping[str, torch.Tensor]
                       ) -> dict[str, torch.Tensor]:
    """Convert flat Flax params to ``model``'s state_dict (float32); a
    ``state_dict`` template (shapes only) may stand for the model."""
    want = flax_shapes(model)
    missing = sorted(set(want) - set(flat))
    if missing:
        raise KeyError(f"Flax params miss {len(missing)} tensors, e.g. "
                       f"{missing[:3]}")
    extra = sorted(set(flat) - set(want))
    if extra:
        raise KeyError(f"Flax params have {len(extra)} tensors the model "
                       f"lacks, e.g. {extra[:3]}")
    bad = [(k, tuple(np.shape(flat[k])), s) for k, s in want.items()
           if tuple(np.shape(flat[k])) != s]
    if bad:
        k, got, shape = bad[0]
        raise ValueError(f"{len(bad)} shape mismatches, e.g. {k}: got "
                         f"{got}, model wants {shape} (Flax layout)")
    return {key: torch.from_numpy(np.array(_to_torch_layout(
                np.asarray(flat[_flax_key(key)], np.float32), key),
                order="C"))
            for key in _template(model)}


def load_flax_npz(path: str, model: nn.Module) -> nn.Module:
    """Load a ``weights_io.export_npz`` file into ``model`` in place."""
    with np.load(path) as d:
        flat = {k: d[k] for k in d.files}
    model.load_state_dict(flax_to_state_dict(flat, model))
    return model


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]
                       ) -> dict[str, np.ndarray]:
    """The inverse of :func:`flax_to_state_dict`: a state_dict as flat Flax
    params (float32 numpy, Flax layout, module order)."""
    return {_flax_key(key): np.ascontiguousarray(_to_flax_layout(
                t.detach().float().cpu().numpy(), key))
            for key, t in state_dict.items()}


def save_flax_npz(model: nn.Module, path: str,
                  state_dict: Mapping[str, torch.Tensor] | None = None) -> str:
    """Write ``model``'s weights (or ``state_dict``, the whole of a model
    whose layers are cut over ranks) as a ``weights_io.export_npz`` file;
    the file is replaced in one rename, so a reader never sees half of
    it."""
    if state_dict is None:
        state_dict = model.state_dict()
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(suffix=".npz", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **state_dict_to_flax(state_dict))
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    return path
