"""Scene configs: dataset writers mirroring the reference's four scenes.

Counterpart of :mod:`deepfluids_tpu.datagen.scenes`.  Each function sweeps
its parameter grid, runs the PyTorch solver on a batch of scenes at a
time, and writes the reference's on-disk contract:

    data/<name>/v/<i0>_<i1>_<frame>.npz   (x = field, y = raw params)
    data/<name>/d/...                     (density, smoke scenes)
    data/<name>/args.txt                  (JSON manifest)

Parameter vectors follow the reference convention: last param is frame
time.  Count overrides exist so tests can generate tiny datasets in
seconds; the full-size defaults are the published scenes'.  Every scene
function simulates on the CUDA card and raises without one, unless
``device`` is given.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from deepfluids_tpu_torch.data.manifest import Manifest, save_manifest
from deepfluids_tpu_torch.datagen.grids import resolve_device
from deepfluids_tpu_torch.datagen.liquid2d import (Liquid2DConfig,
                                                   simulate_liquid2d_batch)
from deepfluids_tpu_torch.datagen.smoke2d import (Smoke2DConfig,
                                                  simulate_smoke2d,
                                                  simulate_smoke2d_batch)
from deepfluids_tpu_torch.datagen.smoke3d import (
    Smoke3DConfig, simulate_smoke3d_segment_batch)


def _fresh_field_dirs(out_dir: str, keys: tuple[str, ...]) -> None:
    """Clear stale field dirs before (re)generation: leftover .npz from a
    previous, larger/different-resolution run would silently mix into the
    new dataset (glob picks up every file under v/)."""
    for k in keys:
        d = os.path.join(out_dir, k)
        if os.path.isdir(d):
            shutil.rmtree(d)


def _save_frames(out_dir, key, scene_idx, fields, params_per_frame,
                 frame_offset: int = 0):
    os.makedirs(os.path.join(out_dir, key), exist_ok=True)
    t = fields.shape[0]
    for f in range(t):
        name = "_".join(str(i) for i in scene_idx) + f"_{frame_offset + f}.npz"
        np.savez_compressed(
            os.path.join(out_dir, key, name),
            x=np.asarray(fields[f], np.float32),
            y=np.asarray(params_per_frame[f], np.float32),
        )


def _auto_scene_batch(card_default: int, device: torch.device) -> int:
    """Scenes solved together: mantaflow ran one C++ scene at a time; on
    the card a chunk of scenes shares every launch of the solver's frame
    loop.  1 on the CPU keeps tests light."""
    return card_default if device.type == "cuda" else 1


def _to_host(trajs) -> list[np.ndarray]:
    """Device trajectories -> host arrays: each in one non-blocking copy
    into pinned memory (a copy into pageable memory stalls the stream),
    then one wait for all of them."""
    if not any(t.device.type == "cuda" for t in trajs):
        return [t.numpy() for t in trajs]
    bufs = []
    for t in trajs:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        bufs.append(buf.copy_(t, non_blocking=True))
    torch.cuda.current_stream(trajs[0].device).synchronize()
    return [b.numpy() for b in bufs]


def _run_grid_sweep(out_dir, sim_batch_fn, axis_a, axis_b, num_frames,
                    field_keys, scene_batch):
    """Shared chunked sweep over a 2-param grid of scenes.

    Args:
      sim_batch_fn: ``(a_vec [S], b_vec [S]) -> tuple of [S, T, ...]``
        trajectories, one per entry of ``field_keys``.
      axis_a/axis_b: the two raw parameter axes (np arrays).
      field_keys: output subdir per returned trajectory ("v", "d", "l"...).
    Returns:
      (min, max) over the FIRST returned trajectory (the manifest v_range).
    """
    _fresh_field_dirs(out_dir, field_keys)
    scene_list = [(i, j, float(a), float(b))
                  for i, a in enumerate(axis_a)
                  for j, b in enumerate(axis_b)]
    v_min, v_max = np.inf, -np.inf
    for k in range(0, len(scene_list), scene_batch):
        chunk = scene_list[k:k + scene_batch]
        avec = torch.tensor([c[2] for c in chunk], dtype=torch.float32)
        bvec = torch.tensor([c[3] for c in chunk], dtype=torch.float32)
        trajs = _to_host(sim_batch_fn(avec, bvec))      # [S, T, ...] each
        for n, (i, j, a, b) in enumerate(chunk):
            params = np.stack(
                [np.full(num_frames, a), np.full(num_frames, b),
                 np.arange(num_frames, dtype=np.float64)], axis=1)
            for ki, (key, traj) in enumerate(zip(field_keys, trajs)):
                arr = traj[n]
                if ki == 0:
                    v_min = min(v_min, float(arr.min()))
                    v_max = max(v_max, float(arr.max()))
                _save_frames(out_dir, key, (i, j), arr, params)
    return v_min, v_max


def smoke_pos21_size5(out_root: str, num_pos: int = 21, num_size: int = 5,
                      num_frames: int = 200, height: int = 128,
                      width: int = 96, name: str | None = None,
                      scene_batch: int = 0,
                      projection: str = "jacobi",
                      device: str | torch.device | None = None) -> str:
    """2D smoke plume: source x-position x source radius grid.

    Reference scene smoke_pos21_size5: 21 x 5 x 200 frames on a 128x96
    grid; params p = [pos_x, radius, frame].

    projection="matched" generates frames ON the generator's manifold
    (discrete Leray projection, datagen/projection.py); "jacobi"
    reproduces the legacy datasets.
    """
    device = resolve_device(device)
    name = name or f"smoke_pos{num_pos}_size{num_size}"
    out_dir = os.path.join(out_root, name)
    cfg = Smoke2DConfig(height=height, width=width, num_frames=num_frames,
                        projection=projection)
    positions = np.linspace(0.2, 0.8, num_pos)
    radii = np.linspace(0.04, 0.12, num_size)

    def sim(pv, rv):
        vt, rt = simulate_smoke2d_batch(pv, rv, cfg, device=device)
        return vt, rt[..., None]

    v_min, v_max = _run_grid_sweep(
        out_dir, sim, positions, radii, num_frames, ("v", "d"),
        scene_batch or _auto_scene_batch(15, device))

    save_manifest(Manifest(
        param_names=["src_x_pos", "src_radius", "frame"],
        param_ranges=[[float(positions[0]), float(positions[-1])],
                      [float(radii[0]), float(radii[-1])],
                      [0.0, float(num_frames - 1)]],
        num_scenes=num_pos * num_size,
        num_frames=num_frames,
        resolution=[height, width],
        num_channels=2,
        v_range=[v_min, v_max],
        data_type="velocity",
        param_counts=[num_pos, num_size],
    ), out_dir)
    return out_dir


def smoke_mov(out_root: str, num_scenes: int = 200, num_frames: int = 400,
              height: int = 128, width: int = 96, seed: int = 0,
              name: str | None = None, projection: str = "jacobi",
              device: str | torch.device | None = None) -> str:
    """2D moving-source smoke (reference smoke_mov200_f400).

    Source x-position follows a smooth random walk per scene; params
    p = [pos_x(t), frame]: the temporal dataset for AE + latent
    integration.  The walks' knots are numpy's ``default_rng(seed)``
    stream, as in the JAX package, so both write the same scenes.
    """
    device = resolve_device(device)
    name = name or f"smoke_mov{num_scenes}_f{num_frames}"
    out_dir = os.path.join(out_root, name)
    _fresh_field_dirs(out_dir, ("v", "d"))
    cfg = Smoke2DConfig(height=height, width=width, num_frames=num_frames,
                        projection=projection)
    rng = np.random.default_rng(seed)
    radius = 0.08
    sb = _auto_scene_batch(10, device)

    # Smooth random source trajectories in [0.2, 0.8], one per scene.
    n_knots = max(num_frames // 40, 2)
    all_xs = np.stack([
        np.interp(np.linspace(0, n_knots - 1, num_frames),
                  np.arange(n_knots), rng.uniform(0.2, 0.8, size=n_knots))
        for _ in range(num_scenes)]).astype(np.float32)

    v_min, v_max = np.inf, -np.inf
    for k in range(0, num_scenes, sb):
        chunk = list(range(k, min(k + sb, num_scenes)))
        xs_chunk = torch.from_numpy(all_xs[chunk])             # [S, T]
        vts, rts = _to_host(simulate_smoke2d(
            xs_chunk[:, 0], torch.full((len(chunk),), radius), cfg,
            pos_x_per_frame=xs_chunk, moving=True, device=device))
        for o, s in enumerate(chunk):
            vt = vts[o]
            v_min = min(v_min, float(vt.min()))
            v_max = max(v_max, float(vt.max()))
            params = np.stack(
                [all_xs[s], np.arange(num_frames, dtype=np.float64)], axis=1
            )
            _save_frames(out_dir, "v", (s,), vt, params)
            _save_frames(out_dir, "d", (s,), rts[o][..., None], params)

    save_manifest(Manifest(
        param_names=["src_x_pos", "frame"],
        param_ranges=[[0.2, 0.8], [0.0, float(num_frames - 1)]],
        num_scenes=num_scenes,
        num_frames=num_frames,
        resolution=[height, width],
        num_channels=2,
        v_range=[v_min, v_max],
        data_type="velocity",
    ), out_dir)
    return out_dir


def liquid_pos10_size4(out_root: str, num_pos: int = 10, num_size: int = 4,
                       num_frames: int = 200, height: int = 128,
                       width: int = 96, name: str | None = None,
                       device: str | torch.device | None = None) -> str:
    """2D liquid drop: drop x-position x drop radius; levelset fields.

    Reference scene liquid_pos10_size4, the ``--data_type=levelset`` path;
    also dumps velocity under ``v/``.
    """
    device = resolve_device(device)
    name = name or f"liquid_pos{num_pos}_size{num_size}"
    out_dir = os.path.join(out_root, name)
    cfg = Liquid2DConfig(height=height, width=width, num_frames=num_frames)
    positions = np.linspace(0.25, 0.75, num_pos)
    radii = np.linspace(0.06, 0.15, num_size)

    def sim(pv, rv):
        return simulate_liquid2d_batch(pv, rv, cfg, device=device)

    l_min, l_max = _run_grid_sweep(
        out_dir, sim, positions, radii, num_frames, ("l", "v"),
        _auto_scene_batch(10, device))

    save_manifest(Manifest(
        param_names=["drop_x_pos", "drop_radius", "frame"],
        param_ranges=[[float(positions[0]), float(positions[-1])],
                      [float(radii[0]), float(radii[-1])],
                      [0.0, float(num_frames - 1)]],
        num_scenes=num_pos * num_size,
        num_frames=num_frames,
        resolution=[height, width],
        num_channels=1,
        v_range=[l_min, l_max],
        data_type="levelset",
        param_counts=[num_pos, num_size],
    ), out_dir)
    return out_dir


def smoke3_vel5_buo3(out_root: str, num_vel: int = 5, num_buo: int = 3,
                     num_frames: int = 250, depth: int = 32, height: int = 64,
                     width: int = 112, name: str | None = None,
                     projection: str = "jacobi",
                     device: str | torch.device | None = None) -> str:
    """3D smoke: inflow velocity x buoyancy grid (reference
    smoke3_vel5_buo3_f250); grid [D,H,W] = [32,64,112].

    projection="matched" generates frames ON the 3D generator's manifold
    (datagen/projection.py).
    """
    device = resolve_device(device)
    name = name or f"smoke3_vel{num_vel}_buo{num_buo}"
    out_dir = os.path.join(out_root, name)
    cfg = Smoke3DConfig(depth=depth, height=height, width=width,
                        num_frames=num_frames, projection=projection)
    vels = np.linspace(0.5, 1.5, num_vel)
    buos = np.linspace(0.04, 0.12, num_buo)

    # 3D trajectories are big (250 frames x 112x64x32x3 f32 ~= 690 MB per
    # scene): run the solver in SEGMENTS (state carried across calls,
    # numerically identical to one run), fetching and writing each segment
    # before the next.
    _fresh_field_dirs(out_dir, ("v", "d"))
    sb = _auto_scene_batch(3, device)
    seg = min(50, num_frames)
    scene_list = [(i, j, float(a), float(b))
                  for i, a in enumerate(vels)
                  for j, b in enumerate(buos)]
    v_min, v_max = np.inf, -np.inf
    for k in range(0, len(scene_list), sb):
        chunk = scene_list[k:k + sb]
        avec = torch.tensor([c[2] for c in chunk], dtype=torch.float32)
        bvec = torch.tensor([c[3] for c in chunk], dtype=torch.float32)
        vel = torch.zeros((len(chunk), depth, height, width, 3),
                          dtype=torch.float32, device=device)
        rho = torch.zeros((len(chunk), depth, height, width),
                          dtype=torch.float32, device=device)
        for f0 in range(0, num_frames, seg):
            # Full segments only; surplus frames of the final segment are
            # computed and discarded.
            vel, rho, vt, rt = simulate_smoke3d_segment_batch(
                vel, rho, avec, bvec, cfg, seg)
            keep = min(seg, num_frames - f0)
            vt, rt = _to_host([vt[:, :keep], rt[:, :keep]])
            for n, (i, j, a, b) in enumerate(chunk):
                frames = np.arange(f0, f0 + keep, dtype=np.float64)
                params = np.stack(
                    [np.full(keep, a), np.full(keep, b), frames], axis=1)
                varr = vt[n]
                v_min = min(v_min, float(varr.min()))
                v_max = max(v_max, float(varr.max()))
                _save_frames(out_dir, "v", (i, j), varr, params,
                             frame_offset=f0)
                _save_frames(out_dir, "d", (i, j), rt[n][..., None], params,
                             frame_offset=f0)

    save_manifest(Manifest(
        param_names=["inflow_vel", "buoyancy", "frame"],
        param_ranges=[[float(vels[0]), float(vels[-1])],
                      [float(buos[0]), float(buos[-1])],
                      [0.0, float(num_frames - 1)]],
        num_scenes=num_vel * num_buo,
        num_frames=num_frames,
        resolution=[depth, height, width],
        num_channels=3,
        v_range=[v_min, v_max],
        data_type="velocity",
        param_counts=[num_vel, num_buo],
    ), out_dir)
    return out_dir


SCENES = {
    "smoke_pos21_size5": smoke_pos21_size5,
    "smoke_mov": smoke_mov,
    "liquid_pos10_size4": liquid_pos10_size4,
    "smoke3_vel5_buo3": smoke3_vel5_buo3,
}
