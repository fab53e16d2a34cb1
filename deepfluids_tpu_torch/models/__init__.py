"""Models of the port: the ``GeneratorBE`` decoder (arch "de") and the
Flax -> torch weight converter."""

from deepfluids_tpu_torch.models.generator import (
    GeneratorBE,
    default_repeat,
    upscale_nearest,
)
from deepfluids_tpu_torch.models.weights import (
    flax_shapes,
    flax_to_state_dict,
    load_flax_npz,
)

__all__ = [
    "GeneratorBE",
    "default_repeat",
    "upscale_nearest",
    "flax_shapes",
    "flax_to_state_dict",
    "load_flax_npz",
]
