"""deepfluids_tpu_torch — the PyTorch / CUDA port of :mod:`deepfluids_tpu`.

The JAX package beside it is the reference; this package mirrors its layout
and names so each module's counterpart is easy to find:

- ``ops``      — finite-difference core: plain-torch ``fd`` (the CPU path and
                 the reference every kernel is held against) and
                 ``cuda_fd``, wrappers around the hand-written Hopper
                 kernels in ``csrc/`` and the autograd Functions that join
                 each forward kernel to its transpose.
- ``models``   — the ``GeneratorBE`` decoder, Flax's init, and the
                 Flax <-> torch weight converter.
- ``train``    — the ``de`` loss, Adam with the cosine schedule, and the
                 ``Trainer`` that trains, checkpoints and serves.
- ``infer``    — parameter-grid sweeps writing the ``.npz``/PNG/GIF
                 artifacts.
- ``utils``    — numpy-only parity metric, image writers and logger.
- ``config``, ``data`` — re-exports of the JAX package's jax-free modules
                 ``deepfluids_tpu.config`` and
                 ``deepfluids_tpu.data.{manifest,dataset}``, the only
                 parts of it the port reuses.

The port imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
