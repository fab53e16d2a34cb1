"""Differential-operator core: plain-torch ``fd`` and the kernel wrappers of
``cuda_fd`` behind the same names as :mod:`deepfluids_tpu.ops`."""

from deepfluids_tpu_torch.ops.cuda_fd import (
    curl2d_fused,
    curl2d_p,
    jacobian2d_fused,
    jacobian2d_p,
)
from deepfluids_tpu_torch.ops.fd import (
    curl2d,
    divergence2d,
    jacobian2d,
    vorticity2d,
)

__all__ = [
    "curl2d",
    "jacobian2d",
    "divergence2d",
    "vorticity2d",
    "curl2d_fused",
    "jacobian2d_fused",
    "curl2d_p",
    "jacobian2d_p",
]
