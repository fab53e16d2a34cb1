"""Losses of the port — for now only :func:`apply_curl`, the part of
:mod:`deepfluids_tpu.train.losses` the serving path runs.  The training
loss (field term, jacobian term) is ROADMAP Queue A item 5."""

from __future__ import annotations

import torch

from deepfluids_tpu_torch.ops import cuda_fd


def apply_curl(out: torch.Tensor) -> torch.Tensor:
    """psi ``[B, H, W, 1]`` -> velocity ``[B, H, W, 2]`` through the curl
    kernel wrapper (its plain version for a CPU tensor)."""
    if out.dim() == 4:
        return cuda_fd.curl2d_fused(out)
    if out.dim() == 5:
        raise NotImplementedError("3D curl (curl3d_fused) is ROADMAP "
                                  "Queue B item 5")
    raise ValueError(f"unsupported potential shape {tuple(out.shape)}")
