"""Encoder + Autoencoder (arch "ae"), 2D and 3D.

Counterpart of :mod:`deepfluids_tpu.models.autoencoder`: a stride-2 conv
encoder that mirrors :class:`.GeneratorBE` compresses a field to a code
``z``, whose first ``num_param`` dims are supervised to equal the
normalized simulation parameters; the decoder is a ``GeneratorBE`` taking
``z`` in place of the parameters.  Code layout (the latent integrator's
contract): ``z = [p_hat (num_param) ; z_free (z_num - num_param)]``.

    x -> conv_in 3x3(x3)
      -> repeat x { num_conv 3x3(x3) convs (leaky ReLU) + skip from the
                    stage input, then (except the last) a stride-2 conv
                    down_{stage} (leaky ReLU) }
      -> flatten in channels-last order -> fc_out -> z (float32)

Submodules carry the Flax names (``encoder/conv_in``, ``encoder/down_0``,
``decoder/fc_in``, ``predictor/fc_0``, ...), so :mod:`.weights` maps one
onto the other by name.  Two traps of the Flax layout:

  * a stride-2 ``'SAME'`` convolution pads ``(0, 1)`` along an even axis
    (``(1, 1)`` along an odd one), where torch's ``padding=1`` pads
    ``(1, 1)``: the padding is explicit here;
  * the flatten before ``fc_out`` is in NHWC order, so the activations
    are permuted channels-last first and the weights need no permutation.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deepfluids_tpu_torch.models import activation
from deepfluids_tpu_torch.models.generator import (
    ACT_SLOPE,
    GeneratorBE,
    default_repeat,
)
from deepfluids_tpu_torch.models.latent import LatentIntegrator
from deepfluids_tpu_torch.parallel import layers
from deepfluids_tpu_torch.parallel.comm import Shard


def same_pads(spatial: Sequence[int], stride: int,
              kernel: int = 3) -> tuple[int, ...]:
    """``F.pad`` widths (last axis first) of a ``'SAME'`` convolution, as
    XLA pads: ``total = max((ceil(n / s) - 1) * s + k - n, 0)``, the smaller
    half before."""
    pads = []
    for n in reversed(spatial):
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return tuple(pads)


class Encoder(nn.Module):
    """Field ``[B, *spatial, in_channels]`` -> code ``[B, z_num]`` (f32).

    Args:
      spatial: ``(H, W)`` or ``(D, H, W)`` of the input field.
      in_channels: the field's channels (Flax infers them at init).
      z_num, filters, num_conv, repeat: as in the JAX module; ``repeat=0``
        derives it from ``spatial`` with :func:`.default_repeat`.
      compute_dtype: dtype every layer computes in (float32 or bfloat16);
        parameters stay float32, as Flax's ``dtype=`` keeps them.

    After :meth:`shard_rows` the input is the rank's rows of the field and
    the maps stay sharded while their first extent halves evenly per rank;
    the first map that does not is gathered, and ``fc_out`` sums each
    rank's rows' part of the product (:mod:`..parallel.layers`).
    """

    def __init__(self, spatial: Sequence[int], in_channels: int,
                 z_num: int = 16, filters: int = 128, num_conv: int = 4,
                 repeat: int = 0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        spatial = tuple(int(s) for s in spatial)
        if len(spatial) not in (2, 3):
            raise ValueError(f"Encoder spatial {spatial}: want (H, W) or "
                             "(D, H, W)")
        self.num_conv = num_conv
        self.repeat = repeat or default_repeat(spatial + (0,))
        self.compute_dtype = compute_dtype
        nd = len(spatial)
        conv = nn.Conv2d if nd == 2 else nn.Conv3d
        self._conv_fn = F.conv2d if nd == 2 else F.conv3d
        self._to_nc = (0, nd + 1, *range(1, nd + 1))
        self._to_last = (0, *range(2, nd + 2), 1)

        self.conv_in = conv(in_channels, filters, 3, padding=1)
        self._down_pads = []
        for stage in range(self.repeat):
            for c in range(num_conv):
                self.add_module(f"conv_{stage}_{c}",
                                conv(filters, filters, 3, padding=1))
            if stage < self.repeat - 1:
                self.add_module(f"down_{stage}",
                                conv(filters, filters, 3, stride=2))
                self._down_pads.append(same_pads(spatial, 2))
                spatial = tuple(-(-s // 2) for s in spatial)
        self.fc_out = nn.Linear(math.prod(spatial) * filters, z_num)
        self.row_shard: Shard | None = None

    def shard_rows(self, shard: Shard | None) -> None:
        """Take the rank's rows of the field over ``shard``."""
        self.row_shard = shard

    def _conv(self, layer: nn.Module, x: torch.Tensor, rows: Shard | None,
              bias: bool = True) -> torch.Tensor:
        return layers.conv(x, layer, self.compute_dtype, self._conv_fn,
                           row_shard=rows, bias=bias)

    def _act(self, layer: nn.Module, y: torch.Tensor) -> torch.Tensor:
        """The leaky ReLU of ``layer``'s bias-free output ``y``, its bias
        added in the same pass (:func:`.activation.bias_leaky_relu`)."""
        return activation.bias_leaky_relu(
            y, layer.bias.to(self.compute_dtype), ACT_SLOPE)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        rows = self.row_shard if (self.row_shard is not None
                                  and self.row_shard.active) else None
        h = self._conv(self.conv_in, x.to(dt).permute(*self._to_nc), rows)
        h0 = h
        for stage in range(self.repeat):
            for c in range(self.num_conv):
                layer = getattr(self, f"conv_{stage}_{c}")
                h = self._act(layer, self._conv(layer, h, rows, bias=False))
            h = h + h0
            if stage < self.repeat - 1:
                down = getattr(self, f"down_{stage}")
                h, still = layers.conv_down(
                    h, down, dt, self._conv_fn, self._down_pads[stage], rows)
                rows = rows if still else None
                h = self._act(down, h)
                h0 = h
        z = layers.dense_rows(h, self.fc_out, dt, rows)
        return z.float()


class Autoencoder(nn.Module):
    """:class:`Encoder` + :class:`.GeneratorBE` decoder; ``forward`` returns
    ``(psi_hat, z)``.

    The caller applies the curl to ``psi_hat`` (the generator's contract)
    and supervises ``z[:, :num_param]`` against the parameters.
    ``pred_hidden > 0`` adds the co-trained one-step latent predictor of
    ``--ae_pred_w`` (a :class:`.LatentIntegrator` named ``predictor``).

    Args:
      output_shape: the decoder's ``(*spatial, out_channels)`` (psi or Psi
        under the curl).
      in_channels: the encoded field's channels.
      z_num, filters, num_conv, repeat, compute_dtype: as
        :class:`Encoder` / :class:`.GeneratorBE`.
      num_param, pred_hidden, pred_depth: the predictor's.
    """

    def __init__(self, output_shape: Sequence[int] = (128, 96, 1),
                 in_channels: int = 2, z_num: int = 16, filters: int = 128,
                 num_conv: int = 4, repeat: int = 0,
                 compute_dtype: torch.dtype = torch.float32,
                 num_param: int = 1, pred_hidden: int = 0,
                 pred_depth: int = 2):
        super().__init__()
        self.pred_hidden = pred_hidden
        self.encoder = Encoder(tuple(output_shape[:-1]), in_channels,
                               z_num=z_num, filters=filters,
                               num_conv=num_conv, repeat=repeat,
                               compute_dtype=compute_dtype)
        self.decoder = GeneratorBE(output_shape, num_param=z_num,
                                   filters=filters, num_conv=num_conv,
                                   repeat=repeat,
                                   compute_dtype=compute_dtype)
        if pred_hidden > 0:
            self.predictor = LatentIntegrator(
                z_num=z_num, num_param=num_param, hidden=pred_hidden,
                depth=pred_depth)

    def shard_rows(self, shard: Shard | None) -> None:
        """Shard the encoder's input and the decoder's output rows."""
        self.encoder.shard_rows(shard)
        self.decoder.shard_rows(shard)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        z = self.encoder(x)
        return self.decoder(z), z

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def predict(self, z: torch.Tensor, dp: torch.Tensor) -> torch.Tensor:
        """The co-trained predictor: ``dz_free`` from ``[z_t ; dp_t]``."""
        if self.pred_hidden <= 0:
            raise ValueError("predict() needs pred_hidden > 0")
        return self.predictor(z, dp)
