"""Faults planted in the measured program on the card, for the readings
that limits are set from and for the card's tests.  Each breaks the timed
path alone.

* ``graph_half_batch``: every replay of the program's CUDA graph takes the
  first half of its batch twice (the second half of the static index
  buffer is made a copy of the first), so the step's loss is the mean over
  half the batch; the eager warm-up chunk before the capture is as it was.
"""

from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def graph_half_batch():
    from deepfluids_tpu_torch.train import graph

    real = graph.StepGraph.fill

    def fill(self, block):
        if self._warm and "idx" in block:
            idx = np.array(block["idx"])
            half = idx.shape[1] // 2
            idx[:, half:2 * half] = idx[:, :half]
            block = {**block, "idx": idx}
        real(self, block)

    graph.StepGraph.fill = fill
    try:
        yield
    finally:
        graph.StepGraph.fill = real
