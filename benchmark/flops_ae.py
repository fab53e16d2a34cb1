"""Operations of the autoencoder (arch ``ae``) the benchmark counts from
shapes, as :mod:`benchmark.flops` counts the generator's: the dense and
convolution layers only, two FLOPs per multiply-add.

The encoder runs ``conv_in`` at every point of the field, each stage's
convolutions at its map's points, each stride-2 ``down_{s}`` at the points
of its output (each extent halved, rounding up) and ``fc_out`` once on the
last map; the decoder is :func:`benchmark.flops.layers` of the generator
with the code in place of the parameters.  In training every layer also
takes its weight gradient, and every layer but ``encoder.conv_in`` (whose
input is the field) its input gradient: unlike the generator's first dense
layer, the decoder's ``fc_in`` reads the code, which needs one.
"""

from __future__ import annotations

import math

from benchmark import flops


def encoder_layers(cfg: dict) -> list[tuple[str, int, int, int]]:
    """``(name, fan_in, out_channels, points)`` of every layer of one
    field's encoder forward, in order."""
    res, f, nd = cfg["resolution"], cfg["filters"], len(cfg["resolution"])
    grid = [int(n) for n in res]
    out = [("encoder.conv_in", cfg["num_channels"] * 3 ** nd, f,
            math.prod(grid))]
    for s in range(cfg["repeat"]):
        out += [(f"encoder.conv_{s}_{c}", f * 3 ** nd, f, math.prod(grid))
                for c in range(cfg["num_conv"])]
        if s < cfg["repeat"] - 1:
            grid = [-(-n // 2) for n in grid]
            out.append((f"encoder.down_{s}", f * 3 ** nd, f,
                        math.prod(grid)))
    out.append(("encoder.fc_out", math.prod(grid) * f, cfg["z_num"], 1))
    return out


def layers(cfg: dict) -> list[tuple[str, int, int, int]]:
    """The encoder's layers, then the decoder's."""
    dec = flops.layers({**cfg, "num_param": cfg["z_num"]})
    return encoder_layers(cfg) + [(f"decoder.{n}", k, o, p)
                                  for n, k, o, p in dec]


def forward_flops(cfg: dict) -> int:
    """FLOPs of one field's forward through encoder and decoder."""
    return sum(2 * k * o * n for _, k, o, n in layers(cfg))


def train_step_flops(cfg: dict, batch: int) -> int:
    """FLOPs of one training step of ``batch`` fields: forward, weight
    gradients and input gradients (none into ``encoder.conv_in``)."""
    fwd = [2 * k * o * n for _, k, o, n in layers(cfg)]
    return batch * (2 * sum(fwd) + sum(fwd[1:]))
