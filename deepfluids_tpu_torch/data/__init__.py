"""Dataset access of the port: its own copies of the JAX package's
numpy-only data modules.

:mod:`.manifest` (the ``args.txt`` contract), :mod:`.dataset`
(``FieldDataset``, ``BatchManager``, the latent ``CodeDataset`` and the
(seed, step) batch-index stream) and :mod:`.native_npz` (the bulk
``.npz`` reader, built from the repo's ``native/npz_loader.cc`` into the
port's ``_build/``).
"""

from deepfluids_tpu_torch.data.dataset import (  # noqa: F401
    BatchManager,
    CodeDataset,
    FieldDataset,
    step_batch_indices,
)
from deepfluids_tpu_torch.data.manifest import (  # noqa: F401
    Manifest,
    load_manifest,
    save_manifest,
)
from deepfluids_tpu_torch.data.native_npz import (  # noqa: F401
    load_npz_batch,
    native_available,
)
