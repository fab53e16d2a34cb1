"""Field parity — the normalized-L2 < 1e-3 gate, numpy only.

Counterpart of :mod:`deepfluids_tpu.utils.parity`, copied because that
package's ``__init__`` imports jax."""

from __future__ import annotations

import numpy as np


def normalized_l2(a: np.ndarray, b: np.ndarray) -> float:
    """||a - b||_2 / ||b||_2 (b is the reference)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def check_fields(ours: np.ndarray, reference: np.ndarray,
                 tol: float = 1e-3) -> dict:
    """Per-field normalized L2 of two ``[N, *spatial, C]`` stacks against
    ``tol``: ``{"max_l2", "mean_l2", "num_failed", "passed"}``."""
    if ours.shape != reference.shape:
        raise ValueError(f"shape mismatch {ours.shape} vs {reference.shape}")
    l2s = np.array([normalized_l2(o, r) for o, r in zip(ours, reference)])
    return {
        "max_l2": float(l2s.max()),
        "mean_l2": float(l2s.mean()),
        "num_failed": int((l2s > tol).sum()),
        "passed": bool((l2s <= tol).all()),
    }
