"""Run configuration of the port: the JAX package's own flag set.

Re-exports :mod:`deepfluids_tpu.config`, which needs only the standard
library, so both CLIs parse the same flags and read the same
``params.json``.
"""

from deepfluids_tpu.config import (  # noqa: F401
    Config,
    get_config,
    load_config,
    merge_test_config,
    save_config,
)
