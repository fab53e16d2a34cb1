"""Logger of the port (counterpart of :mod:`deepfluids_tpu.utils.rundir`)."""

from __future__ import annotations

import logging


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
