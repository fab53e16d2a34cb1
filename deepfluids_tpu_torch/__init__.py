"""deepfluids_tpu_torch — the PyTorch / CUDA port of :mod:`deepfluids_tpu`.

The JAX package beside it is the reference; this package mirrors its layout
and names so each module's counterpart is easy to find:

- ``ops``      — finite-difference core: plain-torch ``fd`` (the CPU path and
                 the reference every kernel is held against) and
                 ``cuda_fd``, wrappers around the hand-written Hopper
                 kernels in ``csrc/`` and the autograd Functions that join
                 each forward kernel to its transpose.
- ``models``   — the ``GeneratorBE`` decoder, the ``Autoencoder`` and
                 the ``LatentIntegrator`` with its rollout, Flax's init,
                 and the Flax <-> torch weight converter.
- ``train``    — the ``de``, ``ae`` and ``nn`` losses, Adam with the cosine
                 schedule, and the ``Trainer`` that trains, checkpoints
                 and serves.
- ``infer``    — parameter-grid sweeps writing the ``.npz``/PNG/GIF
                 artifacts, the AE encode pass, the latent rollout and
                 its score against the simulation.
- ``utils``    — numpy-only parity metric, image writers and logger.
- ``config``, ``data`` — the port's own copies of the JAX package's
                 ``config`` and ``data.{manifest,dataset,native_npz}``
                 (and ``infer.score``):
                 the same flags, ``params.json``, ``args.txt`` and batch
                 stream.

The port imports ``torch`` and never ``jax``, nor anything of
``deepfluids_tpu``.  Its entry points (``main.main``, ``Trainer``, the
sweeps) run on the CUDA card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
