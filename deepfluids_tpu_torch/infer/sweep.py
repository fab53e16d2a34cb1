"""Batched parameter-grid sweeps for the generator (arch "de").

Counterpart of :mod:`deepfluids_tpu.infer.sweep` (``param_grid``,
``sweep_generator``, ``sweep_on_device``, ``_write_npz``,
``run_test_sweep``), with the same artifact contract:
``<out_dir>/<scene>_<frame>.npz`` holding ``x`` (the raw-unit field) and
``y`` (raw params), vorticity (or levelset) PNGs every ``save_png_every``
frames and a GIF of each of the first ``gif_scenes`` scenes.
"""

from __future__ import annotations

import concurrent.futures as cf
import io
import math
import os
import zipfile
from collections import deque
from typing import Callable, Iterator, Sequence

import numpy as np
import torch
from numpy.lib import format as npfmt

from deepfluids_tpu_torch import spans
from deepfluids_tpu_torch.data import Manifest
from deepfluids_tpu_torch.utils.images import save_field_image, save_gif


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
    denormalize: bool = True,
    device: str | torch.device = "cuda",
) -> Iterator[np.ndarray]:
    """Yield generated fields for a raw-parameter list, batch by batch.

    ``apply_fn`` maps normalized params ``[B, P]`` on ``device`` to fields
    ``[B, *res, C]`` (curl applied, normalized units); fields come back in
    raw units (normalized with ``denormalize=False``).  The last partial
    batch is padded to ``batch_size``, so every call sees one shape, and
    the padding rows are dropped.  Runs under ``torch.inference_mode``.
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
        yield manifest.denormalize_field(out) if denormalize else out


# Page-locked batch slots that ``sweep_on_device`` copies the fields back
# through: while the host copies one slot into the output array, the card
# computes the batches queued behind it.
RING_SLOTS = 3

# ``sweep_on_device``'s copies out of a ring slot, by whether the card still
# had queued work when the copy began (``overlapped``) or none
# (``exposed``); plain integers, as ``ops.cuda_fd.launch_counts``.
overlap_counts: dict[str, int] = {"overlapped": 0, "exposed": 0}


def sweep_on_device(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    manifest: Manifest,
    raw_params: np.ndarray,
    batch_size: int = 512,
    max_out_bytes: int = 1 << 30,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """The whole sweep on the device, returned once: fields ``[N, *res,
    C]`` in raw units (float32).

    The grid runs in padded batches of ``batch_size``, each scaled to raw
    units on the device.  A grid whose fields fit in ``max_out_bytes`` is
    copied batch by batch straight into one pinned array (pageable memory
    on a CPU device), which is returned.  A larger one (the full 2D grid, 21 000 fields, 2.06 GB at batch 512; the 3D
    grid, 10.3 GB) is copied back through a ring of ``RING_SLOTS`` pinned
    batch slots into a pageable array: the host copies batch ``j`` out of
    its slot, the span ``sweep.host_copy`` (:mod:`..spans`), while the card
    computes batches ``j + 1 .. j + RING_SLOTS - 1``, and counts each such
    copy in :data:`overlap_counts`.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    n = raw_params.shape[0]
    p_norm = np.asarray(manifest.normalize_params(raw_params), np.float32)
    num_batches = -(-n // batch_size)
    pad = num_batches * batch_size - n
    if pad:
        p_norm = np.concatenate([p_norm, np.repeat(p_norm[-1:], pad, 0)])
    shape = tuple(manifest.field_shape)
    whole = n * 4 * math.prod(shape) <= max_out_bytes

    def rows(j: int) -> slice:
        return slice(j * batch_size, min(n, (j + 1) * batch_size))

    with torch.inference_mode():
        params = torch.from_numpy(p_norm).to(device).view(
            num_batches, batch_size, -1)

        def field(j: int) -> torch.Tensor:        # raw units, float32
            return apply_fn(params[j]).to(torch.float32, copy=True).mul_(
                manifest.v_scale)

        if whole:
            out = torch.empty((n,) + shape, dtype=torch.float32,
                              pin_memory=cuda)
            for j in range(num_batches):
                r = rows(j)
                out[r].copy_(field(j)[:r.stop - r.start], non_blocking=True)
            if cuda:
                torch.cuda.current_stream(device).synchronize()
            return out.numpy()

        slots = min(RING_SLOTS, num_batches)
        ring = [torch.empty((batch_size,) + shape, dtype=torch.float32,
                            pin_memory=cuda) for _ in range(slots)]
        done = [torch.cuda.Event() for _ in range(slots)] if cuda else None
        out = np.empty((n,) + shape, np.float32)

        def copy_out(j: int, newest: int) -> None:
            """Batch ``j`` from its slot into ``out`` once the card has
            copied it there; ``newest`` is the last batch enqueued."""
            s, r = j % slots, rows(j)
            busy = False
            if cuda:
                done[s].synchronize()
                busy = not done[newest % slots].query()
            overlap_counts["overlapped" if busy else "exposed"] += 1
            with spans.span("sweep.host_copy"):
                out[r] = ring[s].numpy()[:r.stop - r.start]

        for j in range(num_batches):
            if j >= slots:                     # slot j % slots holds j - slots
                copy_out(j - slots, j - 1)
            ring[j % slots].copy_(field(j), non_blocking=True)
            if cuda:
                done[j % slots].record()
        for j in range(num_batches - slots, num_batches):
            copy_out(j, num_batches - 1)
    return out


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
    counts: Sequence[int] | None = None,
    num_frames: int | None = None,
    batch_size: int = 32,
    save_npz: bool = True,
    save_png_every: int = 0,
    gif_scenes: int = 1,
    write_workers: int = 16,
    device: str | torch.device = "cuda",
) -> dict:
    """Full parameter-grid sweep writing ``.npz`` fields (``save_npz``), a
    vorticity (levelset) PNG every ``save_png_every`` frames and a GIF of
    each of the first ``gif_scenes`` scenes (at most the scenes swept).
    ``counts`` None sweeps one value per non-frame parameter, its range's
    midpoint.

    Artifact encoding runs on a ``write_workers``-thread pool (zlib
    releases the GIL) overlapped with the device sweep; a bounded in-flight
    queue caps host memory at a few hundred frames.  Returns
    ``{"num_fields", "out_dir"}``.
    """
    os.makedirs(out_dir, exist_ok=True)
    if counts is None:
        counts = [1] * (manifest.num_param - 1)
    t = num_frames or manifest.num_frames
    raw = param_grid(manifest, counts, t)
    n = raw.shape[0]
    gif_scenes = min(gif_scenes, n // t)
    mode = "levelset" if manifest.num_channels == 1 else "vorticity"

    pool = cf.ThreadPoolExecutor(max_workers=max(1, write_workers))
    pending: deque = deque()

    def submit(fn, *a, **kw):
        pending.append(pool.submit(fn, *a, **kw))
        while len(pending) > 8 * write_workers:
            pending.popleft().result()

    gif_frames: list[np.ndarray] = []
    idx = 0
    try:
        for batch in sweep_generator(apply_fn, manifest, raw, batch_size,
                                     device=device):
            for f in batch:
                scene, frame = divmod(idx, t)
                if save_npz:
                    submit(_write_npz,
                           os.path.join(out_dir, f"{scene}_{frame}.npz"),
                           x=f.astype(np.float32), y=raw[idx])
                if save_png_every and frame % save_png_every == 0:
                    submit(save_field_image,
                           os.path.join(out_dir, f"{scene}_{frame}.png"),
                           f, mode)
                if scene < gif_scenes:
                    gif_frames.append(f)
                idx += 1
        for s in range(gif_scenes):
            submit(save_gif, os.path.join(out_dir, f"scene{s}.gif"),
                   gif_frames[s * t:(s + 1) * t], mode)
        while pending:
            pending.popleft().result()
    finally:
        pool.shutdown(wait=True)
    return {"num_fields": n, "out_dir": out_dir}
