"""Rollout field-space scoring — THE code path for `rollout_field_l2`.

The port's own copy of :mod:`deepfluids_tpu.infer.score` (numpy only).

One implementation of the latent-rollout drift metric (per-frame relative
L2 of a decoded rollout against the simulated ground-truth trajectory,
reported as whole-horizon median plus first/last-quarter medians — the
drift profile tracked since round 2), shared by:

  * ``Trainer.evaluate`` for arch "nn" (via ``--ae_load_path`` or an
    explicit ``decode_fn``) — routine training/eval-time numbers;
  * ``main.py``'s arch-"nn" test path — scores the rollout it just wrote;
  * ``tools/rollout_eval.py`` — scores a saved ``test/rollout.npz``.

Round-3 VERDICT "Next #8": previously the trainer reported latent MAE only
and the field numbers came from a separate reimplementation in the tool —
two half-wired paths to the same metric.
"""

from __future__ import annotations

import glob
import os

import numpy as np


def load_scene_fields(dataset_dir: str, scene: str, field_key: str = "v",
                      max_frames: int | None = None) -> np.ndarray:
    """Load one scene's ground-truth frames ``<scene>_<frame>.npz`` in
    frame order -> [T, *res, C] (RAW units, as written by datagen)."""
    frames = glob.glob(os.path.join(dataset_dir, field_key,
                                    f"{scene}_*.npz"))
    # A scene prefix can be a prefix of another ("1_2" vs "1_22"): keep
    # only files whose stem minus the frame index equals `scene` exactly.
    frames = [f for f in frames
              if os.path.basename(f)[:-4].rsplit("_", 1)[0] == scene]
    if not frames:
        raise FileNotFoundError(
            f"no frames for scene {scene!r} under "
            f"{dataset_dir}/{field_key}")
    frames.sort(key=lambda f: int(os.path.basename(f)[:-4].rsplit("_", 1)[1]))
    if max_frames is not None:
        frames = frames[:max_frames]
    out = []
    for fp in frames:
        with np.load(fp) as z:
            out.append(np.asarray(z["x"], np.float32))
    return np.stack(out)


def field_l2_profile(x_roll: np.ndarray, x_true: np.ndarray) -> dict:
    """Per-frame relative L2 ``||x_roll[t] - x_true[t]|| / ||x_true[t]||``
    over the common horizon; scale-invariant, so raw-vs-raw matches
    normalized-space numbers.

    Returns {"rollout_steps", "l2_median", "l2_firstq_median",
    "l2_lastq_median", "l2_max"} — first/last-quarter medians are the
    drift profile (flat = stable integrator; rising = compounding error).
    """
    t = min(x_roll.shape[0], x_true.shape[0])
    l2 = np.empty(t)
    for i in range(t):
        r = (x_roll[i].astype(np.float64).reshape(-1)
             - x_true[i].astype(np.float64).reshape(-1))
        l2[i] = (np.linalg.norm(r)
                 / max(np.linalg.norm(x_true[i].astype(np.float64)), 1e-12))
    q = max(t // 4, 1)
    return {
        "rollout_steps": int(t),
        "l2_median": round(float(np.median(l2)), 4),
        "l2_firstq_median": round(float(np.median(l2[:q])), 4),
        "l2_lastq_median": round(float(np.median(l2[-q:])), 4),
        "l2_max": round(float(l2.max()), 4),
    }


def score_rollout_vs_sim(x_roll: np.ndarray, dataset_dir: str, scene: str,
                         field_key: str = "v") -> dict:
    """Convenience: load the scene's sim frames and profile the drift."""
    x_true = load_scene_fields(dataset_dir, scene, field_key,
                               max_frames=x_roll.shape[0])
    return {"scene": scene, **field_l2_profile(x_roll, x_true)}
