"""PyTorch fluid solvers + scene scripts (the data-generation layer, L0).

Counterpart of :mod:`deepfluids_tpu.datagen`, in the role of the
reference's external mantaflow C++ solver: produce ``data/<name>/v/*.npz`` +
``args.txt`` training datasets.  The solvers are plain PyTorch programs
with a leading scene axis that run on the card (or, when asked, on the
CPU); the matched projection's curl and its transpose are the package's
hand-written kernels.  Scene configs mirror the reference's four scripts
(smoke_pos21_size5, smoke_mov200_f400, liquid_pos10_size4,
smoke3_vel5_buo3_f250).
"""

from deepfluids_tpu_torch.datagen.smoke2d import (Smoke2DConfig,
                                                  simulate_smoke2d)
from deepfluids_tpu_torch.datagen.smoke3d import (Smoke3DConfig,
                                                  simulate_smoke3d)
from deepfluids_tpu_torch.datagen.liquid2d import (Liquid2DConfig,
                                                   simulate_liquid2d)
from deepfluids_tpu_torch.datagen import scenes

__all__ = [
    "Smoke2DConfig",
    "simulate_smoke2d",
    "Smoke3DConfig",
    "simulate_smoke3d",
    "Liquid2DConfig",
    "simulate_liquid2d",
    "scenes",
]
