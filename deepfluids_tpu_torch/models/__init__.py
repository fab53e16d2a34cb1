"""Models of the port: the ``GeneratorBE`` decoder (arch "de"), its
Flax-matching init, and the Flax <-> torch weight converter."""

from deepfluids_tpu_torch.models.generator import (
    GeneratorBE,
    default_repeat,
    flax_init_,
    upscale_nearest,
)
from deepfluids_tpu_torch.models.weights import (
    flax_shapes,
    flax_to_state_dict,
    load_flax_npz,
    save_flax_npz,
    state_dict_to_flax,
)

__all__ = [
    "GeneratorBE",
    "default_repeat",
    "flax_init_",
    "upscale_nearest",
    "flax_shapes",
    "flax_to_state_dict",
    "load_flax_npz",
    "save_flax_npz",
    "state_dict_to_flax",
]
