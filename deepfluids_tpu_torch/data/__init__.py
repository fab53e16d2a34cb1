"""Dataset access of the port: the JAX package's numpy-only data modules.

Re-exports :mod:`deepfluids_tpu.data.manifest` (the ``args.txt`` contract)
and :mod:`deepfluids_tpu.data.dataset` (``FieldDataset``,
``BatchManager``), which need no jax.
"""

from deepfluids_tpu.data.dataset import BatchManager, FieldDataset  # noqa: F401
from deepfluids_tpu.data.manifest import (  # noqa: F401
    Manifest,
    load_manifest,
    save_manifest,
)
