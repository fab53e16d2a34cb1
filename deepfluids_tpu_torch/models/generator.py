"""GeneratorBE — the parameterized field decoder (arch "de"), 2D and 3D.

Counterpart of :mod:`deepfluids_tpu.models.generator`: a BEGAN-style decoder
from a parameter vector to a stream function (2D) or vector potential (3D),

    p -> fc_in -> reshape to the coarse grid [(D0,) H0, W0, filters]
      -> repeat x { num_conv 3x3(x3) convs (leaky ReLU) + skip from the
                    stage input + 2x nearest upsample (except the last) }
      -> conv_out 3x3(x3) to out_channels (no activation), cast to float32.

The curl that turns the potential into velocity is applied outside the
network (:func:`deepfluids_tpu_torch.train.losses.apply_curl`).

Submodules carry the Flax names (``fc_in``, ``conv_{stage}_{c}``,
``conv_out``) so :mod:`.weights` maps one onto the other by name.  Dtypes
follow Flax's ``nn.Dense/nn.Conv(dtype=...)``: parameters stay float32 and
each layer casts its input, kernel and bias to ``compute_dtype``.  Inside,
activations are NCHW (NCDHW in 3D); ``fc_in``'s output is viewed
channels-last ``(B, [D0,] H0, W0, F)`` first, as Flax reshapes it, so the
weights need no row permutation.  Stride-1 ``'SAME'`` convolution with a
kernel of 3 is ``padding=1``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

ACT_SLOPE = 0.2   # leaky ReLU slope (the JAX module's act_slope default)


def default_repeat(output_shape: Sequence[int]) -> int:
    """Number of conv stages for an output shape (spatial dims + channel):
    ``log2(max spatial extent) - 2`` (128x96 -> 5 stages, coarse 8x6;
    32x64x112 -> 4 stages, coarse 4x8x14)."""
    return int(math.log2(max(output_shape[:-1]))) - 2


@torch.no_grad()
def flax_init_(model: nn.Module, seed: int) -> nn.Module:
    """Flax's default init, in place: every Linear/Conv weight from
    ``lecun_normal`` and every bias zero.

    ``lecun_normal`` is ``variance_scaling(1.0, "fan_in",
    "truncated_normal")``: a normal truncated at +-2 sigma, with sigma
    ``1 / sqrt(fan_in) / 0.8796...`` so that the truncated variance is
    ``1 / fan_in`` (fan_in = in times the kernel's volume for a conv, in
    for a Linear).
    Drawn on the CPU from a ``torch.Generator`` seeded with ``seed``, in
    module order, so the weights are the same on any device; they are not
    JAX's numbers (another generator), only its distribution.
    """
    gen = torch.Generator().manual_seed(seed)
    # The std of a unit normal truncated to [-2, 2] (jax.nn.initializers).
    trunc_std = 0.87962566103423978
    lo, hi = (math.erf(b / math.sqrt(2.0)) for b in (-2.0, 2.0))
    for module in model.modules():
        if not isinstance(module, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            continue
        w = module.weight
        fan_in = w[0].numel()      # (out, in) or (out, in, [kd,] kh, kw)
        sigma = 1.0 / math.sqrt(fan_in) / trunc_std
        # Inverse-CDF sampling of the truncated normal.
        u = torch.empty(w.shape, dtype=torch.float64).uniform_(
            lo, hi, generator=gen)
        draw = torch.erfinv(u) * math.sqrt(2.0)
        w.copy_((draw.clamp_(-2.0, 2.0) * sigma).to(w.dtype))
        module.bias.zero_()
    return model


def upscale_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsampling of an NCHW / NCDHW tensor: every cell
    repeated ``factor`` times along each spatial axis."""
    for dim in range(2, x.dim()):
        x = x.repeat_interleave(factor, dim=dim)
    return x


class GeneratorBE(nn.Module):
    """Parameter vector ``[B, num_param]`` -> field ``[B, *spatial, C]``
    (f32).

    Args:
      output_shape: ``(H, W, out_channels)`` (2D, e.g. ``(128, 96, 1)``) or
        ``(D, H, W, out_channels)`` (3D, e.g. ``(32, 64, 112, 3)``).
      num_param: length of the input vector (Flax infers it at init).
      filters, num_conv, repeat: as in the JAX module; ``repeat=0``
        derives it with :func:`default_repeat`.
      compute_dtype: dtype every layer computes in (float32 or bfloat16).

    The JAX module's beyond-reference knobs (Fourier embedding, spectral
    layers, the grid decoder, spatial sharding) are not ported; the trainer
    refuses a config that sets them.
    """

    def __init__(self, output_shape: Sequence[int] = (128, 96, 1),
                 num_param: int = 3, filters: int = 128, num_conv: int = 4,
                 repeat: int = 0, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if len(output_shape) not in (3, 4):
            raise ValueError(
                f"GeneratorBE output_shape {tuple(output_shape)}: want "
                "(H, W, C) or (D, H, W, C)")
        self.output_shape = tuple(int(s) for s in output_shape)
        self.filters = filters
        self.num_conv = num_conv
        self.repeat = repeat or default_repeat(self.output_shape)
        self.compute_dtype = compute_dtype
        spatial = self.output_shape[:-1]
        scale = 2 ** (self.repeat - 1)
        self.coarse = tuple(s // scale for s in spatial)
        if any(c * scale != s for c, s in zip(self.coarse, spatial)):
            raise ValueError(f"spatial dims {spatial} must be divisible by "
                             f"2**(repeat-1)={scale}")

        nd = len(spatial)
        conv = nn.Conv2d if nd == 2 else nn.Conv3d
        self._conv_fn = F.conv2d if nd == 2 else F.conv3d
        # (B, *coarse, F) -> (B, F, *coarse) and back at the output
        self._to_nc = (0, nd + 1, *range(1, nd + 1))
        self._to_last = (0, *range(2, nd + 2), 1)

        self.fc_in = nn.Linear(num_param, math.prod(self.coarse) * filters)
        for stage in range(self.repeat):
            for c in range(num_conv):
                self.add_module(f"conv_{stage}_{c}",
                                conv(filters, filters, 3, padding=1))
        self.conv_out = conv(filters, self.output_shape[-1], 3, padding=1)

    def _conv(self, layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_fn(x, layer.weight.to(dt), layer.bias.to(dt),
                             padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = F.linear(z.to(dt), self.fc_in.weight.to(dt),
                     self.fc_in.bias.to(dt))
        x = x.view(-1, *self.coarse, self.filters).permute(*self._to_nc)
        x0 = x
        for stage in range(self.repeat):
            for c in range(self.num_conv):
                x = F.leaky_relu(
                    self._conv(getattr(self, f"conv_{stage}_{c}"), x),
                    ACT_SLOPE)
            if stage < self.repeat - 1:
                x = upscale_nearest(x + x0, 2)
                x0 = x
            else:
                x = x + x0
        out = self._conv(self.conv_out, x)
        return out.permute(*self._to_last).float()
