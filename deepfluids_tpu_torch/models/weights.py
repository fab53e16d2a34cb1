"""Flax parameters <-> this port's ``state_dict``.

Takes the flat ``{"<module>/<kernel|bias>": array}`` form of
``tools/weights_io.flatten_params`` (or an ``.npz`` of it, as
``weights_io.export_npz`` writes) and converts it by name:

  * Dense kernel ``(in, out)`` -> Linear weight ``(out, in)``;
  * Conv kernel HWIO -> Conv2d weight OIHW, DHWIO -> Conv3d weight OIDHW;
  * biases as they are.

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
    module, leaf = torch_key.rsplit(".", 1)
    leaf = "kernel" if leaf == "weight" else "bias"
    return f"{module.replace('.', '/')}/{leaf}"


def _to_torch_layout(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 2:      # Dense (in, out) -> (out, in)
        return arr.T
    if arr.ndim == 4:      # Conv HWIO -> OIHW
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 5:      # Conv DHWIO -> OIDHW
        return arr.transpose(4, 3, 0, 1, 2)
    return arr


def flax_shapes(model: nn.Module) -> dict[str, tuple[int, ...]]:
    """The flat Flax keys and shapes ``model`` expects, in module order."""
    out = {}
    for key, t in model.state_dict().items():
        shape = tuple(t.shape)
        if t.dim() == 2:
            shape = shape[::-1]
        elif t.dim() >= 4:     # (O, I, *kernel) -> (*kernel, I, O)
            shape = shape[2:] + (shape[1], shape[0])
        out[_flax_key(key)] = shape
    return out


def flax_to_state_dict(flat: Mapping[str, np.ndarray],
                       model: nn.Module) -> dict[str, torch.Tensor]:
    """Convert flat Flax params to ``model``'s state_dict (float32)."""
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
                np.asarray(flat[_flax_key(key)], np.float32)), order="C"))
            for key in model.state_dict()}


def load_flax_npz(path: str, model: nn.Module) -> nn.Module:
    """Load a ``weights_io.export_npz`` file into ``model`` in place."""
    with np.load(path) as d:
        flat = {k: d[k] for k in d.files}
    model.load_state_dict(flax_to_state_dict(flat, model))
    return model


def _to_flax_layout(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 2:      # Linear (out, in) -> Dense (in, out)
        return arr.T
    if arr.ndim == 4:      # Conv OIHW -> HWIO
        return arr.transpose(2, 3, 1, 0)
    if arr.ndim == 5:      # Conv OIDHW -> DHWIO
        return arr.transpose(2, 3, 4, 1, 0)
    return arr


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]
                       ) -> dict[str, np.ndarray]:
    """The inverse of :func:`flax_to_state_dict`: a state_dict as flat Flax
    params (float32 numpy, Flax layout, module order)."""
    return {_flax_key(key): np.ascontiguousarray(_to_flax_layout(
                t.detach().float().cpu().numpy()))
            for key, t in state_dict.items()}


def save_flax_npz(model: nn.Module, path: str) -> str:
    """Write ``model``'s weights as a ``weights_io.export_npz`` file; the
    file is replaced in one rename, so a reader never sees half of it."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(suffix=".npz", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **state_dict_to_flax(model.state_dict()))
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    return path
