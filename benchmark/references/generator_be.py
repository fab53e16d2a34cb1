"""Plain PyTorch reference of the Deep Fluids generator (Kim et al., Deep
Fluids, Eurographics 2019, arXiv:1806.02071), its curl, its loss and Adam.

It imports nothing of the measured program: the layers, the finite
differences, the loss and the optimizer are written here again from the
paper's description and the reference code's conventions:

* the generator maps a normalized parameter vector to a stream function
  (2D, one channel) or a vector potential (3D, three channels): a dense
  layer to the coarse grid, ``repeat`` stages of ``num_conv`` 3x3(x3)
  'SAME' convolutions with a leaky ReLU of slope 0.2, a skip from the
  stage's input, a 2x nearest upsampling between stages, and a last 3x3(x3)
  convolution without activation;
* the velocity is the curl of that output, by forward differences whose
  last sample repeats the one before (edge replication);
* the loss is ``mean|u - x| + mean|J(u) - J(x)|``, J the first derivatives
  of each velocity channel by the same differences;
* Adam (b1 0.5, b2 0.999, eps 1e-8) with the cosine decay of the rate from
  1e-4 to 2.5e-6 over 100 000 steps.

Parameters use the measured program's names and PyTorch layouts (a dense
weight ``(out, in)``, a conv weight ``(out, in, *kernel)``), so the
benchmark hands one weight dict to both sides.  Tensors are channels-last
fields ``[B, H, W, C]`` / ``[B, D, H, W, C]``; inside, feature maps are
NC(D)HW.  Everything runs in float32; the benchmark turns TF32 off around
it.  ``precision="fp8"`` is the control: every dense and conv layer reads
its input and weight rounded to float8 e4m3 with one scale a tensor (its
largest magnitude at 448), gradients passing straight through the
rounding.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SLOPE = 0.2
ADAM_EPS = 1e-8
FP8_MAX = 448.0


def coarse_grid(resolution, repeat: int) -> tuple[int, ...]:
    """The grid of the first stage: each extent over ``2**(repeat-1)``."""
    scale = 2 ** (repeat - 1)
    return tuple(int(r) // scale for r in resolution)


def potential_channels(resolution) -> int:
    """psi (2D) has one channel, the vector potential (3D) three."""
    return 1 if len(resolution) == 2 else 3


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape, in the forward's order."""
    res, f, k = cfg["resolution"], cfg["filters"], len(cfg["resolution"])
    kernel = (3,) * k
    coarse = coarse_grid(res, cfg["repeat"])
    shapes = {"fc_in.weight": (math.prod(coarse) * f, cfg["num_param"]),
              "fc_in.bias": (math.prod(coarse) * f,)}
    for s in range(cfg["repeat"]):
        for c in range(cfg["num_conv"]):
            shapes[f"conv_{s}_{c}.weight"] = (f, f) + kernel
            shapes[f"conv_{s}_{c}.bias"] = (f,)
    out = potential_channels(res)
    shapes["conv_out.weight"] = (out, f) + kernel
    shapes["conv_out.bias"] = (out,)
    return shapes


class _Fp8(torch.autograd.Function):
    """Round to float8 e4m3 with a per-tensor scale; identity backward."""

    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def _prec(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return x
    if precision == "fp8":
        return _Fp8.apply(x)
    raise ValueError(f"unknown precision {precision!r}")


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """``x`` where ``x >= 0``, else ``0.2 x`` (gradient 1 at 0)."""
    return torch.where(x >= 0, x, SLOPE * x)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsampling of every spatial axis of an NC(D)HW map."""
    for dim in range(2, x.dim()):
        x = x.repeat_interleave(2, dim=dim)
    return x


def generator(params: dict[str, torch.Tensor], p: torch.Tensor, cfg: dict,
              precision: str = "f32") -> torch.Tensor:
    """Normalized parameters ``[B, P]`` -> potential ``[B, *res, C]``."""
    res, f = cfg["resolution"], cfg["filters"]
    nd = len(res)
    conv = F.conv2d if nd == 2 else F.conv3d
    coarse = coarse_grid(res, cfg["repeat"])

    def layer(x, name, padding=1):
        w = _prec(params[f"{name}.weight"], precision)
        return conv(_prec(x, precision), w, params[f"{name}.bias"],
                    padding=padding)

    x = F.linear(_prec(p, precision), _prec(params["fc_in.weight"], precision),
                 params["fc_in.bias"])
    # the dense output is read channels-last over the coarse grid
    x = x.view(-1, *coarse, f).permute(0, nd + 1, *range(1, nd + 1))
    x0 = x
    for s in range(cfg["repeat"]):
        for c in range(cfg["num_conv"]):
            x = leaky_relu(layer(x, f"conv_{s}_{c}"))
        if s < cfg["repeat"] - 1:
            x = upsample2(x + x0)
            x0 = x
        else:
            x = x + x0
    out = layer(x, "conv_out")
    return out.permute(0, *range(2, nd + 2), 1)


def fdiff(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Forward difference along ``dim``; the last sample repeats the one
    before."""
    d = x.narrow(dim, 1, x.shape[dim] - 1) - x.narrow(dim, 0,
                                                      x.shape[dim] - 1)
    return torch.cat([d, d.narrow(dim, d.shape[dim] - 1, 1)], dim=dim)


def curl(psi: torch.Tensor) -> torch.Tensor:
    """2D: ``(dpsi/dy, -dpsi/dx)``; 3D: the curl of ``(a, b, c)``:
    ``(dc/dy - db/dz, da/dz - dc/dx, db/dx - da/dy)``.  Axes of a field:
    x is the last spatial axis, y the one before, z the first (3D)."""
    if psi.dim() == 4:
        s = psi[..., 0]
        return torch.stack([fdiff(s, -2), -fdiff(s, -1)], dim=-1)
    a, b, c = psi[..., 0], psi[..., 1], psi[..., 2]
    return torch.stack([fdiff(c, -2) - fdiff(b, -3),
                        fdiff(a, -3) - fdiff(c, -1),
                        fdiff(b, -1) - fdiff(a, -2)], dim=-1)


def jacobian(v: torch.Tensor) -> torch.Tensor:
    """Every channel's derivatives along x, y (and z), channel-major:
    2D ``(du/dx, du/dy, dv/dx, dv/dy)``, 3D nine."""
    nd = v.dim() - 2
    return torch.stack([fdiff(v[..., ch], -(k + 1))
                        for ch in range(v.shape[-1]) for k in range(nd)],
                       dim=-1)


def field(params, p, cfg, precision: str = "f32") -> torch.Tensor:
    """The velocity field of normalized parameters ``p``."""
    return curl(generator(params, p, cfg, precision))


def loss(params, p, x, cfg, precision: str = "f32") -> torch.Tensor:
    """``mean|u - x| + mean|J(u) - J(x)|`` of the batch."""
    u = field(params, p, cfg, precision)
    return (torch.mean(torch.abs(u - x))
            + torch.mean(torch.abs(jacobian(u) - jacobian(x))))


def cosine_lr(step: int, cfg: dict) -> float:
    """The rate of the update made after ``step`` updates."""
    s = min(step, cfg["max_step"])
    return cfg["lr_min"] + 0.5 * (cfg["lr_max"] - cfg["lr_min"]) * (
        1.0 + math.cos(math.pi * s / cfg["max_step"]))


def train_steps(params: dict[str, torch.Tensor], batches, cfg: dict,
                precision: str = "f32", half_batch=()) -> dict:
    """Adam from zero moments over ``batches`` (a list of ``(p, x)``, one a
    step).  Returns the loss of every step, the first step's gradients,
    the parameters after the last step and Adam's moments then (``m``,
    ``v``).  The steps (1 for the first) in ``half_batch`` take their loss
    over the first half of the batch's rows only (a planted fault)."""
    b1, b2 = cfg["beta1"], cfg["beta2"]
    theta = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in theta.items()}
    v2 = {k: torch.zeros_like(v) for k, v in theta.items()}
    losses, first_grad = [], None
    for t, (p, x) in enumerate(batches, start=1):
        if t in half_batch:
            p, x = p[:p.shape[0] // 2], x[:x.shape[0] // 2]
        leaves = {k: v.requires_grad_(True) for k, v in theta.items()}
        value = loss(leaves, p, x, cfg, precision)
        grads = torch.autograd.grad(value, list(leaves.values()))
        losses.append(float(value.detach()))
        if first_grad is None:
            first_grad = {k: g.detach().clone()
                          for k, g in zip(leaves, grads)}
        lr = cosine_lr(t - 1, cfg)
        with torch.no_grad():
            for (k, w), g in zip(leaves.items(), grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = m[k] / (1 - b1 ** t)
                vhat = v2[k] / (1 - b2 ** t)
                theta[k] = (w - lr * mhat / (vhat.sqrt() + ADAM_EPS)).detach()
    return {"losses": losses, "first_grad": first_grad, "params": theta,
            "m": m, "v": v2}
