"""Differential-operator core: plain-torch ``fd`` and the kernel wrappers of
``cuda_fd`` behind the same names as :mod:`deepfluids_tpu.ops`."""

from deepfluids_tpu_torch.ops.cuda_fd import (
    curl2d_fused,
    curl2d_p,
    curl3d_fused,
    curl3d_p,
    jacobian2d_fused,
    jacobian2d_p,
    jacobian3d_fused,
    jacobian3d_p,
)
from deepfluids_tpu_torch.ops.fd import (
    curl2d,
    curl3d,
    divergence2d,
    divergence3d,
    jacobian2d,
    jacobian3d,
    vorticity2d,
    vorticity3d,
)

__all__ = [
    "curl2d",
    "jacobian2d",
    "divergence2d",
    "vorticity2d",
    "curl3d",
    "jacobian3d",
    "divergence3d",
    "vorticity3d",
    "curl2d_fused",
    "jacobian2d_fused",
    "curl2d_p",
    "jacobian2d_p",
    "curl3d_fused",
    "jacobian3d_fused",
    "curl3d_p",
    "jacobian3d_p",
]
