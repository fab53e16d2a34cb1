"""Dataset access of the port: the JAX package's numpy-only data modules.

Re-exports :mod:`deepfluids_tpu.data.manifest` (the ``args.txt`` contract),
:mod:`deepfluids_tpu.data.dataset` (``FieldDataset``, ``BatchManager`` and
the (seed, step) batch-index stream) and
:mod:`deepfluids_tpu.data.native_npz` (the bulk ``.npz`` reader), which need
no jax.
"""

from deepfluids_tpu.data.dataset import (  # noqa: F401
    BatchManager,
    FieldDataset,
    step_batch_indices,
)
from deepfluids_tpu.data.manifest import (  # noqa: F401
    Manifest,
    load_manifest,
    save_manifest,
)
from deepfluids_tpu.data.native_npz import load_npz_batch  # noqa: F401
