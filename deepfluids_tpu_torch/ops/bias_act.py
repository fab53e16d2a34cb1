"""Wrappers around the conv stack's hand-written epilogue kernels
(``csrc/epilogue.cu``): the bias add and leaky ReLU after a convolution,
``y = leaky_relu(c + bias)``, in one pass, and its backward ``dx = y >= 0 ?
g : g * slope`` in one pass.

They replace no Pallas kernel: in :mod:`deepfluids_tpu` XLA fuses this
epilogue into the convolution.  On the card aten adds a conv's bias in a
pass of its own after cuDNN's convolution, and the activation reads and
writes the map again.  What bounds the kernels is memory: the forward
reads and writes the map once (2 x 2 bytes an element in bf16), the
backward reads two maps and writes one, so their least time is those bytes
at 3.35 TB/s (``PERF.md`` holds their times beside it).

Each wrapper checks its input, then dispatches on the device the tensor
lies on:

  * a CPU tensor goes to the plain version, with aten's rounding: the add
    rounded to the map's dtype, then ``F.leaky_relu``; the backward
    ``torch.where(y >= 0, g, g * slope)``;
  * a CUDA tensor launches the kernel on the current stream, or raises.
    There is no fallback to the plain version on the card.

A map is channels-last (NHWC, NDHWC) or contiguous NC(D)HW (a row-sharded
map, a map gathered over channel shards); any other layout is refused.
``launch_counts`` counts kernel launches by kernel and layout (plain
integers, incremented where a kernel is launched; a launch recorded into a
CUDA graph counts once, at its capture), so a run shows how often the
fused path engaged.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FWD = "bias_leaky_relu_fwd"
BWD = "leaky_relu_bwd"
LAYOUTS = ("channels_last", "contiguous")

launch_counts: dict[str, int] = {f"{k}.{lay}": 0 for k in (FWD, BWD)
                                 for lay in LAYOUTS}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def add_bias(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``x + bias`` with ``bias`` ``[C]`` along dim 1 of ``x`` ``[B, C,
    *spatial]``, rounded once to the dtype."""
    return x + bias.view((1, -1) + (1,) * (x.dim() - 2))


def bias_leaky_relu_plain(x: torch.Tensor, bias: torch.Tensor,
                          slope: float) -> torch.Tensor:
    """The forward kernel's plain version: aten's add, then
    ``F.leaky_relu``."""
    return F.leaky_relu(add_bias(x, bias), slope)


def leaky_relu_bwd_plain(y: torch.Tensor, g: torch.Tensor,
                         slope: float) -> torch.Tensor:
    """The backward kernel's plain version: ``g`` where the output ``y`` is
    >= 0 (at 0 and -0.0 too), ``g * slope`` rounded to the dtype
    elsewhere."""
    return torch.where(y >= 0, g, g * slope)


def layout(x: torch.Tensor) -> str:
    """``"contiguous"`` for NC(D)HW, ``"channels_last"`` for NHWC / NDHWC;
    raises on any other layout.  A map that is both (one channel, or one
    point) is contiguous: both index its channels alike."""
    if x.is_contiguous():
        return "contiguous"
    fmt = torch.channels_last if x.dim() == 4 else torch.channels_last_3d
    if x.dim() in (4, 5) and x.is_contiguous(memory_format=fmt):
        return "channels_last"
    raise ValueError(f"wants a contiguous or channels-last map, got shape "
                     f"{tuple(x.shape)} strides {x.stride()}")


def same_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` lie alike in memory: one shape, and one
    stride along every dim longer than 1."""
    return a.shape == b.shape and all(
        sa == sb for sa, sb, n in zip(a.stride(), b.stride(), a.shape)
        if n > 1)


def _check(name: str, x: torch.Tensor) -> str:
    if x.dim() not in (4, 5):
        raise ValueError(f"{name} wants [B, C, H, W] or [B, C, D, H, W], "
                         f"got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, got {x.device}")
    return layout(x)


def _library(name: str):
    """The kernel library, loaded; refused under a capture that would load
    it (loading initialises its CUDA runtime, which a capture forbids)."""
    from deepfluids_tpu_torch.ops import _build

    if torch.cuda.is_current_stream_capturing() and _build._lib is None:
        raise RuntimeError(f"{name}: the kernel library must be built and "
                           "loaded before a CUDA graph is captured")
    return _build.library()


def bias_leaky_relu_fwd(x: torch.Tensor, bias: torch.Tensor,
                        slope: float) -> torch.Tensor:
    """``leaky_relu(x + bias, slope)`` in one pass.

    Args:
      x: ``[B, C, *spatial]`` bias-free conv output, float32 or bfloat16,
        channels-last or contiguous.
      bias: ``[C]``, the dtype and device of ``x``.
      slope: the leaky ReLU's negative slope.
    Returns:
      ``y`` of the shape, dtype and layout of ``x``.
    """
    lay = _check(FWD, x)
    c = x.shape[1]
    if (bias.shape != (c,) or bias.dtype != x.dtype
            or bias.device != x.device):
        raise ValueError(f"{FWD}: bias {tuple(bias.shape)} {bias.dtype} "
                         f"{bias.device} does not match the map's {c} "
                         f"channels {x.dtype} {x.device}")
    if x.device.type == "cpu":
        return bias_leaky_relu_plain(x, bias, slope)
    y = run_fwd(_library(FWD), x, bias.contiguous(), slope,
                torch.cuda.current_stream(x.device).cuda_stream)
    launch_counts[f"{FWD}.{lay}"] += 1
    return y


def leaky_relu_bwd(y: torch.Tensor, g: torch.Tensor,
                   slope: float) -> torch.Tensor:
    """The leaky ReLU's input gradient from its output ``y`` and the output
    gradient ``g``, in one pass.  ``g`` must have the shape, dtype, device
    and layout of ``y`` (:func:`same_layout`)."""
    lay = _check(BWD, y)
    if (not same_layout(g, y) or g.dtype != y.dtype
            or g.device != y.device):
        raise ValueError(f"{BWD}: gradient {tuple(g.shape)} strides "
                         f"{g.stride()} {g.dtype} {g.device} does not match "
                         f"the output's {tuple(y.shape)} {y.stride()} "
                         f"{y.dtype} {y.device}")
    if y.device.type == "cpu":
        return leaky_relu_bwd_plain(y, g, slope)
    dx = run_bwd(_library(BWD), y, g, slope,
                 torch.cuda.current_stream(y.device).cuda_stream)
    launch_counts[f"{BWD}.{lay}"] += 1
    return dx


def run_fwd(lib, x: torch.Tensor, bias: torch.Tensor, slope: float,
            stream) -> torch.Tensor:
    """Launch ``lib``'s forward entry point on checked ``x`` and a
    contiguous ``bias`` into a new map of ``x``'s layout, on ``stream``."""
    y = torch.empty_like(x)
    err = lib.df_bias_leaky_relu_fwd(
        x.data_ptr(), bias.data_ptr(), y.data_ptr(), x.numel(), x.shape[1],
        math.prod(x.shape[2:]), int(layout(x) == "channels_last"), slope,
        _DTYPE_CODES[x.dtype], x.get_device(), stream)
    if err != 0:
        raise RuntimeError(f"{FWD} kernel launch failed: cudaError {err}")
    return y


def run_bwd(lib, y: torch.Tensor, g: torch.Tensor, slope: float,
            stream) -> torch.Tensor:
    """Launch ``lib``'s backward entry point on checked ``y`` and ``g``
    into a new map of their layout, on ``stream``."""
    dx = torch.empty_like(y)
    err = lib.df_leaky_relu_bwd(
        y.data_ptr(), g.data_ptr(), dx.data_ptr(), y.numel(), slope,
        _DTYPE_CODES[y.dtype], y.get_device(), stream)
    if err != 0:
        raise RuntimeError(f"{BWD} kernel launch failed: cudaError {err}")
    return dx
