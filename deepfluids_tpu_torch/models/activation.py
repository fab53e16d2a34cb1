"""The models' leaky ReLU, with JAX's gradient at 0.

``jax.nn.leaky_relu`` is ``where(x >= 0, x, slope * x)``: its gradient at
exactly 0 (and at -0.0) is 1, where ``F.leaky_relu``'s is the slope.  Exact
zeros are common: at Flax's init a zero patch of the field meets zero
biases, and in bf16 a bias can cancel a conv output.  The forward here is
``F.leaky_relu`` (the same bits: both are 0 at 0); the backward is ``g``
where ``x >= 0`` and ``slope * g`` elsewhere.

The generator and the encoder look :func:`leaky_relu` up on this module at
call time, so a test swaps the activation (a smooth stand-in without the
kink) by setting ``activation.leaky_relu``; :func:`smooth` is that
stand-in.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class _LeakyReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slope):
        ctx.save_for_backward(x)
        ctx.slope = slope
        return F.leaky_relu(x, slope)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, g, g * ctx.slope), None


def leaky_relu(x: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """``F.leaky_relu(x, negative_slope)`` whose gradient at 0 is 1, as
    ``jax.nn.leaky_relu``'s."""
    return _LeakyReLU.apply(x, negative_slope)


def smooth(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """A smooth stand-in for the leaky ReLU (no kink), for checks that
    compare two computations which round otherwise: at the kink a
    pre-activation within rounding of zero takes either slope."""
    return x * (0.6 + 0.4 * torch.tanh(x))
