"""The port's repo-root entry points: the flagship forward, the dry runs.

Counterpart of the repo root's ``__graft_entry__.py``, under the same names:

  * :func:`entry` returns the flagship forward and its example arguments:
    the 2D smoke generator at the reference's 128x96 resolution (filters
    128, num_conv 4, bf16 convolutions), curl applied.  It is what
    :mod:`deepfluids_tpu_torch.bench` times.
  * :func:`dryrun_multichip` and :func:`dryrun_multihost` are the dry runs
    of :mod:`deepfluids_tpu_torch.tools.dryrun`, re-exported.
"""

from __future__ import annotations

from typing import Callable

import torch

from deepfluids_tpu_torch.datagen.grids import resolve_device
from deepfluids_tpu_torch.models import GeneratorBE, flax_init_
from deepfluids_tpu_torch.ops import cuda_fd
from deepfluids_tpu_torch.tools.dryrun import (  # noqa: F401  (re-exported)
    dryrun_multichip,
    dryrun_multihost,
)

__all__ = ["entry", "dryrun_multichip", "dryrun_multihost"]


def _flagship() -> GeneratorBE:
    return GeneratorBE((128, 96, 1), num_param=3, filters=128, num_conv=4,
                       compute_dtype=torch.bfloat16)


def _forward(model: GeneratorBE, p: torch.Tensor) -> torch.Tensor:
    """``p`` ``[B, 3]`` -> channels-last velocity ``[B, 128, 96, 2]`` f32:
    the generator's stream function through the curl kernel."""
    return cuda_fd.curl2d_fused(model(p))


def entry(device: str | torch.device | None = None
          ) -> tuple[Callable, tuple[GeneratorBE, torch.Tensor]]:
    """``(fn, (model, p))``: the flagship forward ``fn(model, p)``, the
    flagship ``GeneratorBE`` under Flax's init from seed 0
    (:func:`..models.flax_init_`, drawn from a seeded ``torch.Generator``)
    and ``p = zeros([8, 3])``, both on ``device`` (default: the card,
    raising without one; ``"cpu"`` for the plain path).

    JAX's ``entry`` applies ``deepfluids_tpu.ops.curl2d``, the jnp version,
    which XLA fuses into the program itself.  Here ``fn`` calls
    :func:`..ops.cuda_fd.curl2d_fused`, the hand-written kernel: on the
    card no main path runs the plain version, and the wrapper takes the
    plain ops only for a tensor on the CPU.
    """
    device = resolve_device(device)
    model = flax_init_(_flagship(), 0).to(device)
    p = torch.zeros((8, 3), dtype=torch.float32, device=device)
    return _forward, (model, p)
