"""Evaluate a trained run directory and record the result.

Counterpart of the JAX package's ``tools/eval_run.py``.  Rebuilds the
Trainer from the run's own persisted params.json, restores the latest
checkpoint, and runs ``Trainer.evaluate()`` (per-arch quality metrics:
de = generated-vs-dataset field L2/rmse, ae = reconstruction + param MSE,
nn = latent rollout error, with the decoded drift profile when the run has
``--ae_load_path``).

Usage: python -m deepfluids_tpu_torch.tools.eval_run <run_dir> [num_samples]
           [note] [--pool train] [--profile_scenes N] [--ae_load_path <run>]
           [--device cpu] [--out file.jsonl]

``--profile_scenes N`` (arch nn): decode + score the rollout drift
profile (and its AE floor) for the first N evaluated scenes instead of
just one, with medians-of-medians aggregated under
``rollout_field_l2_agg``.

``--pool train`` scores the run on its TRAINING pool (the
generalization-gap diagnostic: train-vs-holdout on the same checkpoint).
The run's --eval_holdout_scenes stays in force: held-out scenes are
EXCLUDED from the pool.

``--ae_load_path`` names the autoencoder of an "nn" run whose params.json
does not (the integrator trains on codes and needs no decoder).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from deepfluids_tpu_torch.tools import _record


def evaluate_run(run_dir: str, num_samples: int = 128, note: str = "",
                 pool: str = "auto", profile_scenes: int = 1,
                 ae_load_path: str = "", device=None) -> dict:
    """The ``eval_<arch>`` record of ``run_dir``'s latest checkpoint."""
    from deepfluids_tpu_torch.config import load_config
    from deepfluids_tpu_torch.train.trainer import Trainer

    device = _record.resolve_device(device)
    run_dir = run_dir.rstrip("/")
    cfg = load_config(run_dir)
    if ae_load_path:
        cfg = dataclasses.replace(cfg, ae_load_path=ae_load_path)
    t = Trainer(cfg, run_dir=run_dir, device=device, save_cfg=False)
    step = t.restore_checkpoint()
    r = t.evaluate(num_samples=num_samples, profile_scenes=profile_scenes,
                   pool=pool)
    return {"metric": f"eval_{cfg.arch}", "run": os.path.basename(run_dir),
            "step": int(step), **r, "note": note}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(
        description="Evaluate a run dir; append the record to --out")
    ap.add_argument("run_dir")
    ap.add_argument("num_samples", nargs="?", type=int, default=128)
    ap.add_argument("note", nargs="?", default="")
    ap.add_argument("--pool", choices=["auto", "train"], default="auto",
                    help="'train' scores the training subset (holdout "
                         "scenes excluded); default is the run's holdout "
                         "pool when configured, else the full dataset")
    ap.add_argument("--profile_scenes", type=int, default=1)
    ap.add_argument("--ae_load_path", default="",
                    help="arch nn: the trained autoencoder's run dir, when "
                         "the run's params.json names none")
    _record.add_arguments(ap)
    a = ap.parse_args(argv)
    device = _record.resolve_device(a.device)
    rec = evaluate_run(a.run_dir, a.num_samples, a.note, a.pool,
                       a.profile_scenes, a.ae_load_path, device)
    return _record.write(rec, device, a.out)


if __name__ == "__main__":
    main()
