"""Inputs the benchmark makes from ``--seed``: weights, training fields and
parameter draws.  Both the measured program and the reference are handed
these same inputs; nothing here imports the program.

Weights and fields are made on the device in a few large calls with a
``torch.Generator`` seeded from ``--seed``, in float32 (the type the
program keeps its parameters in).  The same seed gives the same inputs on
the same kind of card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Seeds of the streams drawn from one --seed; any large odd constants.
_WEIGHTS, _FIELDS = 0x9E3779B1, 0x85EBCA77
_MASK = (1 << 63) - 1


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of one stream of ``seed`` (any whole number)."""
    return (int(seed) * 0x100000001B3 + stream) & _MASK


def weights(shapes: dict[str, tuple[int, ...]], seed: int,
            device) -> dict[str, torch.Tensor]:
    """A weight of ``(out, in, *kernel)`` is normal with deviation
    ``1/sqrt(in * kernel volume)``; a bias normal with deviation 0.01.  One
    normal draw for all of them, cut into leaves."""
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, _WEIGHTS))
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape)
        at += n
        scale = (0.01 if name.endswith(".bias")
                 else 1.0 / math.sqrt(math.prod(shape[1:])))
        out[name] = (leaf * scale).contiguous()
    return out


def grid_axes(cfg: dict, frames: int) -> list[np.ndarray]:
    """Raw values of each parameter over the published grid: every
    non-frame parameter at its ``param_counts`` points of its range, the
    frame at ``frames`` points of its range."""
    axes = [np.linspace(lo, hi, n) for (lo, hi), n in
            zip(cfg["param_ranges"][:-1], cfg["param_counts"])]
    lo, hi = cfg["param_ranges"][-1]
    axes.append(np.linspace(lo, hi, frames))
    return axes


def param_grid(cfg: dict, frames: int) -> np.ndarray:
    """``[scenes * frames, P]`` float32 raw parameters, scene by scene (the
    first parameter slowest), each scene's frames contiguous."""
    mesh = np.meshgrid(*grid_axes(cfg, frames), indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=1).astype(np.float32)


def normalize(p: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Raw parameters -> [-1, 1] over each parameter's range."""
    lo = torch.tensor([r[0] for r in cfg["param_ranges"]], dtype=p.dtype,
                      device=p.device)
    hi = torch.tensor([r[1] for r in cfg["param_ranges"]], dtype=p.dtype,
                      device=p.device)
    return (p - lo) / (hi - lo) * 2.0 - 1.0


def _fdiff(x: torch.Tensor, dim: int) -> torch.Tensor:
    d = torch.diff(x, dim=dim)
    return torch.cat([d, d.narrow(dim, d.shape[dim] - 1, 1)], dim=dim)


def blob_fields(cfg: dict, seed: int, device,
                chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """The training set's distinct fields: ``(fields [N, *res, C], raw
    params [N, P])`` on the device, N = scenes x ``distinct_frames``.  Each field is the curl of a
    Gaussian blob whose centre, width and height follow the scene's two
    parameters and the frame (a rising plume), its strength and a small
    drift drawn from the seed per scene, so the set is learnable and
    differs from seed to seed."""
    res = tuple(cfg["resolution"])
    raw = torch.from_numpy(param_grid(cfg, cfg["distinct_frames"])).to(
        device)
    scenes = raw.shape[0] // cfg["distinct_frames"]
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, _FIELDS))
    jitter = torch.rand((scenes, 2), generator=gen, device=device)
    unit = (raw - raw.amin(0)) / (raw.amax(0) - raw.amin(0)).clamp_min(1e-12)
    # every axis in units of the height (y runs over [0, 1])
    coords = torch.meshgrid(*[torch.linspace(0.0, n / res[-2], n,
                                             device=device) for n in res],
                            indexing="ij")
    out = []
    for at in range(0, raw.shape[0], chunk):
        u = unit[at:at + chunk]
        j = jitter[torch.arange(at, at + u.shape[0], device=device)
                   // cfg["distinct_frames"]]
        shape = (-1,) + (1,) * len(res)
        cx = (0.2 + 0.6 * u[:, 0] + 0.05 * j[:, 1]).view(shape) * (
            res[-1] / res[-2])   # a share of the width
        cy = (0.1 + 0.8 * u[:, -1]).view(shape)
        r = (0.06 + 0.08 * u[:, 1]).view(shape)
        amp = (0.5 + j[:, 0]).view(shape)
        d2 = (coords[-1] - cx) ** 2 + (coords[-2] - cy) ** 2
        if len(res) == 3:
            d2 = d2 + (coords[0] - coords[0].mean()) ** 2
        blob = amp * torch.exp(-d2 / (2 * r * r))
        if len(res) == 2:
            s = blob
            v = torch.stack([_fdiff(s, -2), -_fdiff(s, -1)], -1)
        else:
            a, b, c = 0.5 * blob, blob, -0.7 * blob
            v = torch.stack([_fdiff(c, -2) - _fdiff(b, -3),
                             _fdiff(a, -3) - _fdiff(c, -1),
                             _fdiff(b, -1) - _fdiff(a, -2)], -1)
        out.append(v * res[-2])
    return torch.cat(out), raw


def staged_rows(cfg: dict) -> np.ndarray:
    """The distinct field (a row of :func:`blob_fields`) that each row of
    the staged training set holds: every scene's ``num_frames`` frames,
    frame ``f`` the scene's distinct frame ``f * distinct_frames //
    num_frames``."""
    frames, distinct = cfg["num_frames"], cfg["distinct_frames"]
    scenes = math.prod(cfg["param_counts"])
    f = np.arange(frames) * distinct // frames
    return (np.arange(scenes)[:, None] * distinct + f).ravel()


def distinct_rows_seed(seed: int, rows_of: np.ndarray, batch: int,
                       steps: int) -> int:
    """The first ``seed + j`` (j >= 0) whose batch rows of steps 1..``steps``
    hold fields that are all different (``rows_of``: the distinct field of
    each row of the set), under the program's documented data order: step
    ``s`` draws ``default_rng((seed, s)).integers(0, len(rows_of),
    batch)``."""
    if len(np.unique(rows_of)) < batch * steps:
        raise ValueError(f"{len(np.unique(rows_of))} fields cannot give "
                         f"{steps} batches of {batch} different fields")
    j = 0
    while len(np.unique(np.concatenate(
            [rows_of[batch_rows(seed + j, s, len(rows_of), batch)]
             for s in range(1, steps + 1)]))) < batch * steps:
        j += 1
    return seed + j


def batch_rows(seed: int, step: int, pool: int, batch: int) -> np.ndarray:
    """The rows of step ``step`` (1 for the first update) of a cached
    training run of seed ``seed``."""
    return np.random.default_rng((seed, step)).integers(0, pool, size=batch)
