"""Operations and bytes the benchmark counts from shapes, and the card's
peaks they are held against.

FLOPs count the dense and convolution layers only (two per multiply-add):
the forward of every layer; in training also each layer's weight gradient
(as many as its forward) and its input gradient where the input needs one
(every layer but the first dense, whose input is the parameter vector).
Elementwise work (bias adds, the activation, the skips, the upsampling),
the finite differences and Adam are left out, so a share of the peak made
from these counts is a lower bound of the work done.

Bytes of an FD kernel launch are its inputs read once and its outputs
written once: the channels each point moves, times the points, times the
element size.  The jacobian transposes are counted without the
vorticity's cotangent, as the training loss calls them (it never reads the
vorticity).
"""

from __future__ import annotations

import math
import re

# Published peaks of an NVIDIA H100 SXM (the data sheet, 700 W, dense):
# bf16 tensor-core operations and HBM3 bytes.
H100_SXM = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


def peaks(kind: str) -> dict | None:
    """The peaks of a card by its CUDA name, or None for a card the table
    does not hold."""
    return H100_SXM if "H100" in kind else None


def layers(cfg: dict) -> list[tuple[str, int, int, int]]:
    """``(name, fan_in, out_channels, points)`` of every dense and conv
    layer of one field's forward: a conv of ``fan_in`` inputs a point
    (input channels times the kernel's volume) run at ``points`` points;
    the dense layer runs at one."""
    res, f, r = cfg["resolution"], cfg["filters"], cfg["repeat"]
    nd = len(res)
    coarse = [n // 2 ** (r - 1) for n in res]
    out = [("fc_in", cfg["num_param"], math.prod(coarse) * f, 1)]
    for s in range(r):
        points = math.prod(c * 2 ** s for c in coarse)
        out += [(f"conv_{s}_{c}", f * 3 ** nd, f, points)
                for c in range(cfg["num_conv"])]
    out.append(("conv_out", f * 3 ** nd, 1 if nd == 2 else 3,
                math.prod(res)))
    return out


def forward_flops(cfg: dict) -> int:
    """FLOPs of one field's forward."""
    return sum(2 * k * o * n for _, k, o, n in layers(cfg))


def train_step_flops(cfg: dict, batch: int) -> int:
    """FLOPs of one training step of ``batch`` fields: forward, weight
    gradients and input gradients (none into the first dense layer)."""
    fwd = [2 * k * o * n for _, k, o, n in layers(cfg)]
    return batch * (2 * sum(fwd) + sum(fwd[1:]))


# Channels an FD kernel reads and writes once a point (see the module doc).
CHANNELS_MOVED = {"curl2d_fused": 3, "jacobian2d_fused": 7,
                  "curl2d_bwd": 3, "jacobian2d_bwd": 6, "curl3d_fused": 6,
                  "jacobian3d_fused": 15, "curl3d_bwd": 6,
                  "jacobian3d_bwd": 12}
_FD_NAME = re.compile(r"\b(curl|jacobian)(2d|3d)(_bwd)?_kernel\b")


def fd_kernel(name: str) -> str | None:
    """The FD kernel a device row's name launches (``curl2d_fused``,
    ``jacobian3d_bwd``, ...), or None."""
    m = _FD_NAME.search(name)
    if m is None:
        return None
    return f"{m.group(1)}{m.group(2)}{m.group(3) or '_fused'}"


def element_bytes(name: str) -> int:
    """Bytes of an element of the type a kernel's name instantiates it
    with: 2 for bfloat16 / half, else 4."""
    return 2 if re.search(r"bfloat16|half", name) else 4


def fd_bytes(kernel: str, points: int, elem: int) -> int:
    """Least bytes of one launch of ``kernel`` over ``points`` points."""
    return CHANNELS_MOVED[kernel] * points * elem
