"""Models of the port: the ``GeneratorBE`` decoder (arch "de"), the
``Autoencoder`` (arch "ae"), the ``LatentIntegrator`` and its rollout
(arch "nn"), their Flax-matching init, and the Flax <-> torch weight
converter."""

from deepfluids_tpu_torch.models.autoencoder import Autoencoder, Encoder
from deepfluids_tpu_torch.models.generator import (
    GeneratorBE,
    default_repeat,
    flax_init_,
    upscale_nearest,
)
from deepfluids_tpu_torch.models.latent import (
    LatentIntegrator,
    noise_generator,
    rollout,
)
from deepfluids_tpu_torch.models.weights import (
    flax_shapes,
    flax_to_state_dict,
    load_flax_npz,
    save_flax_npz,
    state_dict_to_flax,
)

__all__ = [
    "Autoencoder",
    "Encoder",
    "GeneratorBE",
    "LatentIntegrator",
    "default_repeat",
    "flax_init_",
    "noise_generator",
    "rollout",
    "upscale_nearest",
    "flax_shapes",
    "flax_to_state_dict",
    "load_flax_npz",
    "save_flax_npz",
    "state_dict_to_flax",
]
