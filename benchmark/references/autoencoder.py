"""Plain PyTorch reference of the Deep Fluids autoencoder (Kim et al., Deep
Fluids, Eurographics 2019, arXiv:1806.02071, the ``ae`` half of config #4,
``smoke_mov200_f400``): its encoder, its decoder, its loss and Adam.

It imports nothing of the measured program.  The encoder is written here
from the paper's description and the reference code's conventions; the
decoder, the curl, the jacobian, Adam and the float8 control are
:mod:`benchmark.references.generator_be`'s, called, not copied:

* the encoder maps a velocity field ``[B, H, W, C]`` to a code ``z`` of
  ``z_num``: a 3x3 convolution ``conv_in`` from the field's channels (no
  activation), then ``repeat`` stages of ``num_conv`` 3x3 'SAME'
  convolutions with a leaky ReLU of slope 0.2 and a skip from the stage's
  input, a stride-2 3x3 'SAME' convolution ``down_{s}`` with a leaky ReLU
  between stages (its output is the next stage's input), and a dense layer
  ``fc_out`` on the last map flattened in channels-last order;
* the decoder is the generator of :mod:`.generator_be` with the code in
  place of the parameters (``num_param = z_num``), under the curl;
* the loss is ``w1 mean|u - x| + w2 mean|J(u) - J(x)| + w3 mean((z[:, :P]
  - p)^2)``, P the number of simulation parameters: the code's first P
  entries are held to the normalized parameters, so the latent space can
  be steered;
* Adam as :func:`.generator_be.train_steps`, over this loss.

Departures from the reference code, each also the measured program's:

* the stride-2 convolutions pad as XLA's 'SAME' does (the JAX package's
  Flax convolutions): ``(0, 1)`` along an even extent, ``(1, 1)`` along an
  odd one;
* the co-trained latent predictor (``--ae_pred_w``) is left out; a
  configuration that runs it is refused.

Parameters use the measured program's ``state_dict`` names
(``encoder.conv_0_0.weight``, ``decoder.fc_in.bias``, ...) and PyTorch's
layouts, so the benchmark hands one weight dict to both sides.  Feature
maps are NC(D)HW inside; everything runs in float32 (the benchmark turns
TF32 off around it).  The encoder is written for 2D and 3D fields alike.
"""

from __future__ import annotations

import math
import types

import torch
import torch.nn.functional as F

from benchmark.references import generator_be

ENCODER, DECODER = "encoder.", "decoder."


def same_pads(extents) -> tuple[int, ...]:
    """``F.pad`` widths (last axis first) of a stride-2 3x3 'SAME'
    convolution over a map of ``extents``: ``(0, 1)`` along an even
    extent, ``(1, 1)`` along an odd one."""
    pads: tuple[int, ...] = ()
    for n in reversed(extents):
        pads += (0, 1) if n % 2 == 0 else (1, 1)
    return pads


def code_grid(resolution, repeat: int) -> tuple[int, ...]:
    """The grid of the encoder's last map: each extent halved, rounding
    up, at each of the ``repeat - 1`` downsamplings."""
    grid = tuple(int(n) for n in resolution)
    for _ in range(repeat - 1):
        grid = tuple(-(-n // 2) for n in grid)
    return grid


def decoder_cfg(cfg: dict) -> dict:
    """The generator's configuration of the decoder: the code in place of
    the parameters."""
    return {**cfg, "num_param": cfg["z_num"]}


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape: the encoder's in the forward's
    order, then the decoder's."""
    if cfg.get("ae_pred_w", 0):
        raise ValueError("the reference has no latent predictor "
                         "(ae_pred_w must be 0)")
    res, f = cfg["resolution"], cfg["filters"]
    kernel = (3,) * len(res)
    shapes = {"encoder.conv_in.weight": (f, cfg["num_channels"]) + kernel,
              "encoder.conv_in.bias": (f,)}
    for s in range(cfg["repeat"]):
        names = [f"conv_{s}_{c}" for c in range(cfg["num_conv"])]
        if s < cfg["repeat"] - 1:
            names.append(f"down_{s}")
        for name in names:
            shapes[f"encoder.{name}.weight"] = (f, f) + kernel
            shapes[f"encoder.{name}.bias"] = (f,)
    width = math.prod(code_grid(res, cfg["repeat"])) * f
    shapes["encoder.fc_out.weight"] = (cfg["z_num"], width)
    shapes["encoder.fc_out.bias"] = (cfg["z_num"],)
    for k, v in generator_be.param_shapes(decoder_cfg(cfg)).items():
        shapes[DECODER + k] = v
    return shapes


def flatten(h: torch.Tensor) -> torch.Tensor:
    """A map ``[B, C, *spatial]`` as rows ``[B, prod(spatial) * C]`` in
    channels-last order: a point's channels side by side."""
    return h.permute(0, *range(2, h.dim()), 1).reshape(h.shape[0], -1)


def encoder(params: dict[str, torch.Tensor], x: torch.Tensor, cfg: dict,
            precision: str = "f32") -> torch.Tensor:
    """Fields ``[B, *res, C]`` -> codes ``[B, z_num]``."""
    nd = x.dim() - 2
    conv = F.conv2d if nd == 2 else F.conv3d
    prec = generator_be._prec

    def layer(h, name, stride=1, padding=1):
        w = prec(params[f"{ENCODER}{name}.weight"], precision)
        return conv(prec(h, precision), w, params[f"{ENCODER}{name}.bias"],
                    stride=stride, padding=padding)

    h = layer(x.permute(0, nd + 1, *range(1, nd + 1)), "conv_in")
    h0 = h
    for s in range(cfg["repeat"]):
        for c in range(cfg["num_conv"]):
            h = generator_be.leaky_relu(layer(h, f"conv_{s}_{c}"))
        h = h + h0
        if s < cfg["repeat"] - 1:
            h = F.pad(h, same_pads(h.shape[2:]))
            h = generator_be.leaky_relu(layer(h, f"down_{s}", stride=2,
                                              padding=0))
            h0 = h
    return F.linear(prec(flatten(h), precision),
                    prec(params[ENCODER + "fc_out.weight"], precision),
                    params[ENCODER + "fc_out.bias"])


def decoder_params(params: dict[str, torch.Tensor]) -> dict:
    """The decoder's leaves under the generator's names."""
    return {k[len(DECODER):]: v for k, v in params.items()
            if k.startswith(DECODER)}


def forward(params, x, cfg, precision: str = "f32"):
    """``(velocity field, code)`` of fields ``x``: the decoded code under
    the curl."""
    z = encoder(params, x, cfg, precision)
    psi = generator_be.generator(decoder_params(params), z, decoder_cfg(cfg),
                                 precision)
    return generator_be.curl(psi), z


def field(params, x, cfg, precision: str = "f32") -> torch.Tensor:
    """The reconstruction of fields ``x``."""
    return forward(params, x, cfg, precision)[0]


def loss(params, p, x, cfg, precision: str = "f32") -> torch.Tensor:
    """The batch's reconstruction loss plus ``w3`` times the squared error
    of the code's first P entries against the normalized parameters ``p``
    ``[B, P]``."""
    u, z = forward(params, x, cfg, precision)
    jac = generator_be.jacobian
    n = p.shape[1]
    return (cfg["w1"] * torch.mean(torch.abs(u - x))
            + cfg["w2"] * torch.mean(torch.abs(jac(u) - jac(x)))
            + cfg["w3"] * torch.mean(torch.square(z[:, :n] - p)))


# Adam from zero moments over a list of ``(p, x)`` batches, with its
# half-batch fault and float8 control: generator_be.train_steps' own code,
# run with this module's loss in place of the generator's.
train_steps = types.FunctionType(
    generator_be.train_steps.__code__,
    {**vars(generator_be), "loss": loss}, "train_steps",
    generator_be.train_steps.__defaults__)
train_steps.__doc__ = generator_be.train_steps.__doc__
