"""CLI entry: ``python -m deepfluids_tpu_torch.main --flags...``.

Counterpart of :mod:`deepfluids_tpu.main` with the same flag set
(:mod:`deepfluids_tpu_torch.config`).  Ported so far, for arch "de":

    # train (a fresh run dir <log_dir>/<dataset>_<tag>; --load_path <run>
    # resumes it from its latest checkpoint), up to --max_step
    python -m deepfluids_tpu_torch.main --arch de \\
        --dataset smoke_pos21_size5 --batch_size 8

    # serve: sweep the parameter grid into <run>/test/
    python -m deepfluids_tpu_torch.main --arch de --is_train False \\
        --load_path <run>

Serving rebuilds the run's generator from its ``params.json``, loads
``<run>/weights.npz`` (which training writes at every checkpoint), sweeps
the grid and appends a quality evaluation.  Both run on the first CUDA
device when there is one, else on the CPU, unless ``device`` is given.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from deepfluids_tpu_torch.config import Config, get_config, merge_test_config
from deepfluids_tpu_torch.infer.sweep import run_test_sweep
from deepfluids_tpu_torch.train.trainer import Trainer
from deepfluids_tpu_torch.utils.rundir import get_logger

log = get_logger()


def main(config: Config, device: str | torch.device | None = None) -> dict:
    np.random.seed(config.seed)
    torch.manual_seed(config.seed)
    device = torch.device(device or ("cuda" if torch.cuda.is_available()
                                     else "cpu"))
    if config.is_train:
        trainer = Trainer(config, device=device)
        # --load_path on a train run restores the latest checkpoint and
        # continues toward --max_step.
        done = trainer.maybe_resume() if config.load_path else 0
        if done:
            log.info("resuming %s from step %d", trainer.run_dir, done)
        if done >= config.max_step:
            log.info("already at max_step %d; nothing to do",
                     config.max_step)
            return {"step": done}
        result = trainer.train(num_steps=config.max_step - done)
        log.info("training done: %s", result)
        return result
    if not config.load_path:
        raise SystemExit("--is_train=false needs --load_path "
                         "(a trained run directory)")
    # Rebuild the TRAINED architecture from the run's own params.json;
    # explicit CLI flags still override.
    config = merge_test_config(config, config.load_path)
    trainer = Trainer(config, run_dir=config.load_path, device=device,
                      save_cfg=False)
    log.info("loaded %s on %s", trainer.restore_weights(), device)
    out_dir = os.path.join(trainer.run_dir, "test")
    # Sweep grid: --test_counts, else the dataset's own generation grid,
    # else 5 per axis.
    if config.test_counts:
        counts = [int(s) for s in config.test_counts.split(",")]
    elif trainer.manifest.param_counts:
        counts = list(trainer.manifest.param_counts)
    else:
        counts = [5] * (trainer.manifest.num_param - 1)
    result = run_test_sweep(
        trainer.apply, trainer.manifest, out_dir, counts=counts,
        num_frames=config.test_frames or None,
        batch_size=config.test_batch_size, save_png_every=20,
        device=device)
    result["eval"] = trainer.evaluate(num_samples=128)
    log.info("sweep done: %s", result)
    return result


if __name__ == "__main__":
    main(get_config(sys.argv[1:]))
