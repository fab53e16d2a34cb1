"""Utilities of the port: logger, numpy-only image writers, parity metric."""

from deepfluids_tpu_torch.utils.images import (
    field_to_image,
    save_field_image,
    save_gif,
)
from deepfluids_tpu_torch.utils.parity import check_fields, normalized_l2
from deepfluids_tpu_torch.utils.rundir import get_logger

__all__ = [
    "get_logger",
    "field_to_image",
    "save_field_image",
    "save_gif",
    "check_fields",
    "normalized_l2",
]
