"""Run directory and logger of the port (counterpart of
:mod:`deepfluids_tpu.utils.rundir`, standard library only).

Layout: ``<log_dir>/<dataset>_<tag>/`` holding ``params.json``,
``checkpoint/``, ``sample/`` (train-time image dumps), ``test/`` (sweeps),
``metrics.jsonl`` and ``weights.npz``.
"""

from __future__ import annotations

import logging
import os
from datetime import datetime


def get_logger(name: str = "deepfluids_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s] %(message)s",
            datefmt="%H:%M:%S",
        ))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def prepare_run_dir(log_dir: str, dataset: str, tag: str,
                    load_path: str = "") -> str:
    """Create (or reuse, when resuming) the run directory.

    New runs get ``<log_dir>/<dataset>_<tag>/``, with a timestamp appended
    when that exists; a ``load_path`` that is an existing directory is
    reused as it is.
    """
    if load_path and os.path.isdir(load_path):
        run_dir = load_path
    else:
        run_dir = os.path.join(log_dir, f"{dataset}_{tag}")
        if os.path.exists(run_dir):
            stamp = datetime.now().strftime("%m%d_%H%M%S")
            run_dir = os.path.join(log_dir, f"{dataset}_{tag}_{stamp}")
    for sub in ("checkpoint", "sample", "test"):
        os.makedirs(os.path.join(run_dir, sub), exist_ok=True)
    return run_dir
