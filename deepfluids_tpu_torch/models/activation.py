"""The models' leaky ReLU, with JAX's gradient at 0, and the conv stack's
bias add fused with it.

``jax.nn.leaky_relu`` is ``where(x >= 0, x, slope * x)``: its gradient at
exactly 0 (and at -0.0) is 1, where ``F.leaky_relu``'s is the slope.  Exact
zeros are common: at Flax's init a zero patch of the field meets zero
biases, and in bf16 a bias can cancel a conv output.  The forward here is
``F.leaky_relu`` (the same bits: both are 0 at 0); the backward is ``g``
where ``x >= 0`` and ``slope * g`` elsewhere.

Every conv the models follow with the activation hands it its bias-free
output and its bias: :func:`bias_leaky_relu` adds the bias and applies the
leaky ReLU in one pass, and takes its gradient in one pass, through the
kernels of :mod:`..ops.bias_act` on the card (their plain versions on the
CPU).  It saves its output, not its input: the next conv keeps that map
anyway, and with a positive slope the output has the input's sign.

The generator and the encoder look :func:`bias_leaky_relu` up on this
module at call time, so a test swaps the activation (a smooth stand-in
without the kink) by setting ``activation.bias_leaky_relu``;
:func:`bias_smooth` is that stand-in, :func:`smooth` its elementwise part.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deepfluids_tpu_torch.ops import bias_act


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


class _BiasLeakyReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, slope):
        y = bias_act.bias_leaky_relu_fwd(x, bias, slope)
        ctx.save_for_backward(y)
        ctx.slope = slope
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        if not bias_act.same_layout(g, y):
            g = torch.empty_like(y).copy_(g)
        dx = bias_act.leaky_relu_bwd(y, g, ctx.slope)
        db = None
        if ctx.needs_input_grad[1]:
            db = dx.sum([d for d in range(dx.dim()) if d != 1])
        return dx, db, None


def bias_leaky_relu(x: torch.Tensor, bias: torch.Tensor,
                    negative_slope: float) -> torch.Tensor:
    """``leaky_relu(x + bias, negative_slope)`` for a conv's bias-free
    output ``x`` ``[B, C, *spatial]`` and its bias ``[C]`` in ``x``'s
    dtype: one pass forward and one backward, with :func:`leaky_relu`'s
    gradient at 0; the bias's gradient is the input gradient summed over
    every dim but the channels'."""
    return _BiasLeakyReLU.apply(x, bias, negative_slope)


def smooth(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """A smooth stand-in for the leaky ReLU (no kink), for checks that
    compare two computations which round otherwise: at the kink a
    pre-activation within rounding of zero takes either slope."""
    return x * (0.6 + 0.4 * torch.tanh(x))


def bias_smooth(x: torch.Tensor, bias: torch.Tensor,
                negative_slope: float = 0.2) -> torch.Tensor:
    """:func:`smooth` of ``x + bias``: the stand-in for
    :func:`bias_leaky_relu`."""
    return smooth(bias_act.add_bias(x, bias), negative_slope)
