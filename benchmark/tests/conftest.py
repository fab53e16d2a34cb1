"""Shared pieces of the benchmark's tests: a tiny copy of each
configuration for the CPU, and the card fixture.

Run from the repository's root: ``python -m pytest benchmark/tests -q``
(the tests marked ``cuda`` skip without a card; on the card they hold the
control against the limits at the cells' own sizes)."""

from __future__ import annotations

import pytest
import torch

# Every width cut so that a cell runs in seconds on the CPU.
TINY = {"resolution": [16, 12], "filters": 8, "repeat": 2,
        "param_counts": [3, 2], "num_frames": 10, "distinct_frames": 4,
        "batch_size": 4}
TINY3 = {**TINY, "resolution": [8, 16, 12]}


def tiny(workload: str) -> dict:
    return TINY3 if "3d" in workload else TINY


@pytest.fixture
def card():
    """Skips a test without a CUDA card (decided here, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
