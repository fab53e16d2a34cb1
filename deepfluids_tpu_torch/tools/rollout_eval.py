"""Score a latent-integrator rollout against the simulated trajectory.

Counterpart of the JAX package's ``tools/rollout_eval.py``.  Reads
``<nn_run>/test/rollout.npz`` (written by the arch-"nn" test path of
``deepfluids_tpu_torch.main``: ``x`` = decoded fields in RAW units) and
compares each frame to the raw ground-truth sim frames of the FIRST code
scene (the scene ``main`` rolls out: the lexicographically-first
``code<z>/<scene>.npz``).  The relative-L2 metric is invariant to the
(pure-scale) field normalization.

Metric: per-frame relative L2  ||x_roll - x_gt|| / ||x_gt||, reported as
median over the whole horizon plus first/last quarter medians (the drift
profile).  The metric math lives in ``deepfluids_tpu_torch.infer.score``,
the SAME code path ``Trainer.evaluate`` (arch nn, with ``--ae_load_path``)
and ``main``'s nn test path report; this tool only adds the
load-a-saved-rollout.npz front end, and touches no device (``--device`` is
accepted and recorded as given, default the card).

Usage: python -m deepfluids_tpu_torch.tools.rollout_eval <nn_run_dir> [note]
           [--device cpu] [--out file.jsonl]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from deepfluids_tpu_torch.tools import _record

# A relative data_dir ("data", the default) resolves against the directory
# that holds the package, not the current one: results must not depend on
# where the tool was started.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def score_run(run_dir: str, note: str = "") -> dict:
    """The ``rollout_field_l2`` record of ``run_dir``'s saved rollout."""
    from deepfluids_tpu_torch.config import load_config
    from deepfluids_tpu_torch.infer.score import score_rollout_vs_sim

    run_dir = run_dir.rstrip("/")
    cfg = load_config(run_dir)
    with np.load(os.path.join(run_dir, "test", "rollout.npz")) as d:
        x_roll = d["x"]                              # [T, *res, C] raw units
    data_dir = (cfg.data_dir if os.path.isabs(cfg.data_dir)
                else os.path.join(ROOT, cfg.data_dir))
    ds_dir = os.path.join(data_dir, cfg.dataset)
    # The rolled-out scene is the first code scene: lexicographically first
    # code file stem (encode_dataset writes one npz per scene prefix).
    code_files = sorted(glob.glob(os.path.join(
        ds_dir, f"code{cfg.z_num}{cfg.code_suffix}", "*.npz")))
    if not code_files:
        raise FileNotFoundError(
            f"no code files under {ds_dir}/code{cfg.z_num}{cfg.code_suffix}")
    scene = os.path.basename(code_files[0])[:-4]
    profile = score_rollout_vs_sim(
        x_roll, ds_dir, scene,
        field_key="l" if cfg.data_type == "levelset" else "v")
    return {"metric": "rollout_field_l2", "run": os.path.basename(run_dir),
            **profile, "note": note}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(
        description="Score <nn_run>/test/rollout.npz against the sim frames")
    ap.add_argument("run_dir")
    ap.add_argument("note", nargs="?", default="")
    _record.add_arguments(ap)
    a = ap.parse_args(argv)
    device = _record.resolve_device(a.device)
    return _record.write(score_run(a.run_dir, a.note), device, a.out)


if __name__ == "__main__":
    main()
