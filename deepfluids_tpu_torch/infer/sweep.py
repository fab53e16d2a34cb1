"""Batched parameter-grid sweeps for the generator (arch "de").

Counterpart of :mod:`deepfluids_tpu.infer.sweep` (``param_grid``,
``sweep_generator``, ``_write_npz``, ``run_test_sweep``), with the same
artifact contract: ``<out_dir>/<scene>_<frame>.npz`` holding ``x`` (the
raw-unit field) and ``y`` (raw params), vorticity PNGs every
``save_png_every`` frames and a GIF of the first scene.
"""

from __future__ import annotations

import concurrent.futures as cf
import io
import os
import zipfile
from collections import deque
from typing import Callable, Iterator, Sequence

import numpy as np
import torch
from numpy.lib import format as npfmt

from deepfluids_tpu_torch.data import Manifest
from deepfluids_tpu_torch.utils.images import save_field_image, save_gif

_WRITE_WORKERS = 16


def param_grid(manifest: Manifest, counts: Sequence[int],
               num_frames: int | None = None) -> np.ndarray:
    """Full parameter grid in RAW units, frame param last.

    Returns ``[prod(counts) * num_frames, num_param]`` float32, scene by
    scene with frames contiguous (the reference's dump order).  A count of
    1 means the range midpoint.
    """
    t = num_frames or manifest.num_frames
    if len(counts) != manifest.num_param - 1:
        raise ValueError(
            f"counts has {len(counts)} entries but dataset has "
            f"{manifest.num_param - 1} non-frame parameters "
            f"({manifest.param_names[:-1]})")
    axes = [np.array([(r[0] + r[1]) / 2.0]) if n == 1
            else np.linspace(r[0], r[1], n)
            for r, n in zip(manifest.param_ranges[:-1], counts)]
    frames = np.arange(t, dtype=np.float64)
    mesh = np.meshgrid(*axes, indexing="ij")
    scene_params = np.stack([m.ravel() for m in mesh], axis=1)
    out = np.concatenate(
        [np.concatenate(
            [np.repeat(sp[None], t, axis=0), frames[:, None]], axis=1)
         for sp in scene_params], axis=0)
    return out.astype(np.float32)


def sweep_generator(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    manifest: Manifest,
    raw_params: np.ndarray,
    batch_size: int = 32,
    device: str | torch.device = "cpu",
) -> Iterator[np.ndarray]:
    """Yield generated fields for a raw-parameter list, batch by batch.

    ``apply_fn`` maps normalized params ``[B, P]`` on ``device`` to fields
    ``[B, *res, C]`` (curl applied, normalized units); fields come back in
    raw units.  The last partial batch is padded to ``batch_size``, so
    every call sees one shape, and the padding rows are dropped.  Runs
    under ``torch.inference_mode``.
    """
    n = raw_params.shape[0]
    p_norm = manifest.normalize_params(raw_params)
    for i in range(0, n, batch_size):
        chunk = p_norm[i:i + batch_size]
        pad = batch_size - chunk.shape[0]
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
        with torch.inference_mode():
            out = apply_fn(torch.from_numpy(chunk).to(device))
            out = out.float().cpu().numpy()
        if pad:
            out = out[:-pad]
        yield manifest.denormalize_field(out)


def _write_npz(path: str, **arrays) -> None:
    """``np.savez_compressed``-compatible writer at deflate level 1, several
    times faster than numpy's default level and read back the same."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED,
                         compresslevel=1) as zf:
        for name, arr in arrays.items():
            buf = io.BytesIO()
            npfmt.write_array(buf, np.asarray(arr), allow_pickle=False)
            zf.writestr(f"{name}.npy", buf.getvalue())


def run_test_sweep(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    manifest: Manifest,
    out_dir: str,
    counts: Sequence[int],
    num_frames: int | None = None,
    batch_size: int = 32,
    save_png_every: int = 0,
    device: str | torch.device = "cpu",
) -> dict:
    """Full parameter-grid sweep writing ``.npz`` fields, a vorticity PNG
    every ``save_png_every`` frames and a GIF of the first scene.

    Artifact encoding runs on a thread pool (zlib releases the GIL)
    overlapped with the device sweep; a bounded in-flight queue caps host
    memory at a few hundred frames.  Returns ``{"num_fields", "out_dir"}``.
    """
    os.makedirs(out_dir, exist_ok=True)
    t = num_frames or manifest.num_frames
    raw = param_grid(manifest, counts, t)
    n = raw.shape[0]
    mode = "levelset" if manifest.num_channels == 1 else "vorticity"

    pool = cf.ThreadPoolExecutor(max_workers=_WRITE_WORKERS)
    pending: deque = deque()

    def submit(fn, *a, **kw):
        pending.append(pool.submit(fn, *a, **kw))
        while len(pending) > 8 * _WRITE_WORKERS:
            pending.popleft().result()

    gif_frames: list[np.ndarray] = []
    idx = 0
    try:
        for batch in sweep_generator(apply_fn, manifest, raw, batch_size,
                                     device=device):
            for f in batch:
                scene, frame = divmod(idx, t)
                submit(_write_npz,
                       os.path.join(out_dir, f"{scene}_{frame}.npz"),
                       x=f.astype(np.float32), y=raw[idx])
                if save_png_every and frame % save_png_every == 0:
                    submit(save_field_image,
                           os.path.join(out_dir, f"{scene}_{frame}.png"),
                           f, mode)
                if scene == 0:
                    gif_frames.append(f)
                idx += 1
        submit(save_gif, os.path.join(out_dir, "scene0.gif"), gif_frames,
               mode)
        while pending:
            pending.popleft().result()
    finally:
        pool.shutdown(wait=True)
    return {"num_fields": n, "out_dir": out_dir}
