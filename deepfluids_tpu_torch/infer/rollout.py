"""AE dataset encoding and the latent rollout (archs "ae" + "nn").

Counterpart of :mod:`deepfluids_tpu.infer.rollout`: the encode pass after
AE training writes the dataset's latent codes (the set arch "nn" trains
on), and the test-time rollout advances a code with the integrator and
decodes every step.  The rollout runs on the device and decodes there in
batches of one shape; only the decoded fields come back to the host.
"""

from __future__ import annotations

import glob
import os
import re
import warnings
from collections import defaultdict
from typing import Callable

import numpy as np
import torch

from deepfluids_tpu_torch.data import Manifest, load_manifest
from deepfluids_tpu_torch.models import rollout as latent_rollout


def encode_dataset(
    encode_fn: Callable[[np.ndarray], np.ndarray],
    dataset_dir: str,
    z_num: int,
    batch_size: int = 32,
    field_key: str = "v",
    suffix: str = "",
) -> str:
    """Encode every frame of a dataset into per-scene code sequences.

    Writes ``<dataset_dir>/code<z_num><suffix>/<scene>.npz`` with ``z``
    (``[T, z_num]``, the AE code, front dims ~ normalized params) and ``p``
    (``[T, num_param]``, RAW params): the contract ``CodeDataset`` reads.
    The trailing batch of a scene is padded to ``batch_size``, so
    ``encode_fn`` (``x [B, *res, C]`` normalized -> ``z [B, z_num]``) sees
    one shape.  Returns the code directory.
    """
    manifest = load_manifest(dataset_dir)
    files = sorted(glob.glob(os.path.join(dataset_dir, field_key, "*.npz")))
    if not files:
        raise FileNotFoundError(f"no fields under {dataset_dir}/{field_key}")
    # Group frames by scene prefix: "<i>_<j>_..._<frame>.npz".
    scenes: dict[str, list[tuple[int, str]]] = defaultdict(list)
    for fp in files:
        m = re.match(r"^(.*)_(\d+)$", os.path.basename(fp)[:-4])
        if m is None:
            warnings.warn(f"skipping {fp}: name does not match the dataset "
                          "contract '<scene>_<frame>.npz'")
            continue
        scenes[m.group(1)].append((int(m.group(2)), fp))

    out_dir = os.path.join(dataset_dir, f"code{z_num}{suffix}")
    os.makedirs(out_dir, exist_ok=True)
    for scene, frames in scenes.items():
        frames.sort()
        xs, ps = [], []
        for _, fp in frames:
            with np.load(fp) as d:
                xs.append(manifest.normalize_field(
                    d["x"].astype(np.float32)))
                ps.append(d["y"].astype(np.float32))
        np.savez_compressed(
            os.path.join(out_dir, f"{scene}.npz"),
            z=padded_chunks(encode_fn, np.stack(xs),
                            batch_size).astype(np.float32),
            p=np.stack(ps).astype(np.float32))
    return out_dir


def padded_chunks(fn: Callable[[np.ndarray], np.ndarray], arr: np.ndarray,
                  bs: int) -> np.ndarray:
    """``fn`` over ``arr`` in chunks of ``bs`` rows, the last one padded
    with copies of the last row (one shape every call), padding dropped."""
    pad = (-len(arr)) % bs
    a = np.concatenate([arr, np.repeat(arr[-1:], pad, 0)]) if pad else arr
    return np.concatenate([fn(a[i:i + bs])
                           for i in range(0, len(a), bs)])[:len(arr)]


def rollout_trajectory(
    integrator: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    decode_fn: Callable[[torch.Tensor], torch.Tensor],
    z0: np.ndarray,
    raw_p_seq: np.ndarray,
    manifest: Manifest,
    decode_batch: int = 32,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Advance ``z0`` through a parameter trajectory and decode every step.

    Args:
      integrator: ``(z_full, dp) -> dz_free`` on ``device`` (a
        ``LatentIntegrator``); see :func:`..models.latent.rollout`.
      decode_fn: codes ``[B, z_num]`` -> fields ``[B, *res, C]`` on
        ``device`` (normalized units, curl applied).
      z0: ``[B, z_num]`` start codes, or ``[H, B, z_num]`` for a history-H
        integrator (the first H encoded codes).
      raw_p_seq: ``[T, num_param]`` raw parameter trajectory (shared across
        the batch) or ``[T, B, num_param]``.
      decode_batch: codes decoded a call; the last call is padded to it.
    Returns:
      ``(z_traj [T, B, z_num], fields [T, B, *res, C])``, fields in RAW
      units.
    """
    batch = z0.shape[1] if z0.ndim == 3 else z0.shape[0]
    p_norm = manifest.normalize_params(raw_p_seq).astype(np.float32)
    if p_norm.ndim == 2:
        p_norm = np.repeat(p_norm[:, None], batch, axis=1)
    with torch.inference_mode():
        z_traj = latent_rollout(
            integrator, torch.from_numpy(np.asarray(z0, np.float32)).to(
                device), torch.from_numpy(p_norm).to(device),
            manifest.num_param,
            history=z0.shape[0] if z0.ndim == 3 else 1)
        t, b = z_traj.shape[:2]
        flat = z_traj.reshape(t * b, -1)
        pad = (-flat.shape[0]) % decode_batch
        if pad:
            flat = torch.cat([flat, flat[-1:].expand(pad, -1)])
        fields = torch.cat([decode_fn(flat[i:i + decode_batch]).float()
                            for i in range(0, flat.shape[0], decode_batch)])
        fields = fields[:t * b].cpu().numpy()
    return (z_traj.cpu().numpy(),
            manifest.denormalize_field(fields.reshape((t, b)
                                                      + fields.shape[1:])))
