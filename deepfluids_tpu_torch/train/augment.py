"""Training-time x-mirror augmentation (``--augment_flip_x``).

Counterpart of :mod:`deepfluids_tpu.train.augment`.  Every scene family of
the datagen is symmetric under a mirror across the x (width) axis, so the
mirror of a training frame is another equally likely frame, with

  * the u channel (x velocity, channel 0) negated, other channels (v[, w],
    levelsets) unchanged;
  * each ``*_x_pos`` parameter reflected, which in the [-1, 1]-normalized
    parameter space is a sign flip (exact when the raw range is symmetric
    about the 0.5 domain centre, which :func:`flip_signs` checks);
  * every other parameter unchanged.

A random half of each training batch is mirrored.  The mask is drawn on
the CPU from a ``torch.Generator`` seeded from ``(seed ^ 0xF11B, step)``,
a pure function of the two, so a resumed run mirrors the frames the
uninterrupted one did.  (JAX's ``fold_in`` Bernoulli stream cannot be
reproduced in torch; given the same mask the flipped batch is bit-equal to
JAX's.)

Holdout caveat: on a grid-sampled x-position family (``param_counts`` set)
the mirror of a training scene is the dataset's scene at the reflected
position, which may be held out; the trainer warns on that combination.
"""

from __future__ import annotations

import numpy as np
import torch

FLIP_SEED_XOR = 0xF11B


def flip_signs(manifest) -> tuple[torch.Tensor, torch.Tensor]:
    """(channel signs ``[C]``, parameter signs ``[P]``) of the x-mirror,
    float32 on the CPU.

    Raises if a ``*_x_pos`` parameter's range is not symmetric about the
    0.5 domain centre: the reflected parameter would leave the sampled
    range, so the mirror is no symmetry of the dataset.
    """
    chan = np.ones(manifest.num_channels, np.float32)
    if manifest.data_type == "velocity" and manifest.num_channels > 1:
        chan[0] = -1.0  # u = x component
    psign = np.ones(manifest.num_param, np.float32)
    for i, (name, (lo, hi)) in enumerate(
            zip(manifest.param_names, manifest.param_ranges)):
        if name.endswith("x_pos"):
            if abs((lo + hi) - 1.0) > 1e-6:
                raise ValueError(
                    f"--augment_flip_x: param {name!r} range [{lo}, {hi}] "
                    "is not symmetric about the 0.5 domain center; the "
                    "x-mirror is not a symmetry of this dataset")
            psign[i] = -1.0
    return torch.from_numpy(chan), torch.from_numpy(psign)


def _draw_mask(seed: int, step: int, batch: int) -> torch.Tensor:
    state = np.random.SeedSequence(
        [seed ^ FLIP_SEED_XOR, step]).generate_state(1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(state))
    return torch.rand(batch, generator=gen) < 0.5


def flip_mask(seed: int, step: int, batch: int,
              device: str | torch.device = "cpu") -> torch.Tensor:
    """The ``[batch]`` bool mask of the frames mirrored at global step
    ``step`` (the updates done before it): each True with probability 1/2,
    drawn on the CPU from a ``torch.Generator`` seeded from ``(seed ^
    0xF11B, step)``, then put on ``device``.  A CUDA device gets it from
    pinned memory without a sync (a copy from pageable memory would wait
    for the stream, so the host could not queue the step ahead of it)."""
    mask = _draw_mask(seed, step, batch)
    if torch.device(device).type != "cuda":
        return mask
    return mask.pin_memory().to(device, non_blocking=True)


def flip_mask_block(seed: int, step: int, k: int,
                    batch: int) -> torch.Tensor:
    """``[k, batch]`` bool on the CPU: row ``i`` is :func:`flip_mask` at
    step ``step + i``, the masks of a chunk of ``k`` updates (every
    trainer step's mask comes from here)."""
    return torch.stack([flip_mask(seed, step + i, batch, "cpu")
                        for i in range(k)])


def flip_x_batch(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                 chan_signs: torch.Tensor, param_signs: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mirror the frames of ``mask`` across x.

    x: ``[B, H, W, C]`` or ``[B, D, H, W, C]`` (W is always axis -2);
    y: ``[B, P]`` normalized params; mask: ``[B]`` bool; the signs of
    :func:`flip_signs`, all on the batch's device.
    """
    b = x.shape[0]
    xf = torch.flip(x, dims=(x.dim() - 2,)) * chan_signs
    yf = y * param_signs
    mf = mask.view((b,) + (1,) * (x.dim() - 1))
    return torch.where(mf, xf, x), torch.where(mask[:, None], yf, y)
