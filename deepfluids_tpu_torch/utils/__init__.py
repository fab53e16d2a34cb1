"""Utilities of the port: logger and run directory, numpy-only image
writers, parity metric."""

from deepfluids_tpu_torch.utils.images import (
    field_to_image,
    save_field_image,
    save_gif,
    save_image_grid,
)
from deepfluids_tpu_torch.utils.parity import (
    check_dirs,
    check_fields,
    normalized_l2,
)
from deepfluids_tpu_torch.utils.rundir import get_logger, prepare_run_dir

__all__ = [
    "get_logger",
    "prepare_run_dir",
    "field_to_image",
    "save_field_image",
    "save_gif",
    "save_image_grid",
    "check_dirs",
    "check_fields",
    "normalized_l2",
]
