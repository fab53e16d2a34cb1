"""Wrappers around the hand-written Hopper finite-difference kernels.

Counterpart of :mod:`deepfluids_tpu.ops.pallas_fd`.  Each wrapper checks
its input, then dispatches on the device the tensor lies on:

  * a CPU tensor goes to the plain version in :mod:`.fd`;
  * a CUDA tensor launches the kernel from ``csrc/`` on the current stream,
    or raises.  There is no fallback to the plain version on the card.

``launch_counts`` counts kernel launches per wrapper (plain integers, only
incremented where a kernel is launched), so a run can show that its path
went through the kernels.
"""

from __future__ import annotations

import torch

from deepfluids_tpu_torch.ops import fd

launch_counts: dict[str, int] = {"curl2d_fused": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def curl2d_fused(psi: torch.Tensor) -> torch.Tensor:
    """Kernel-backed :func:`deepfluids_tpu_torch.ops.fd.curl2d`.

    Args:
      psi: ``[B, H, W, 1]`` contiguous stream function, float32 or
        bfloat16, with H and W >= 2.
    Returns:
      ``[B, H, W, 2]`` velocity in the input dtype (f32 math).

    Forward only: on the card, an input that requires grad under grad mode
    raises (the backward kernel ``_curl2d_bwd`` is ROADMAP Queue B item 3).
    """
    if psi.dim() != 4 or psi.shape[-1] != 1:
        raise ValueError(f"curl2d_fused wants psi [B, H, W, 1], got "
                         f"{tuple(psi.shape)}")
    b, h, w, _ = psi.shape
    if h < 2 or w < 2:
        raise ValueError(f"curl2d_fused needs H, W >= 2, got H={h} W={w}")
    if psi.dtype not in _DTYPE_CODES:
        raise TypeError(f"curl2d_fused takes float32 or bfloat16, got "
                        f"{psi.dtype}")
    if not psi.is_contiguous():
        raise ValueError("curl2d_fused wants a contiguous psi")
    if psi.device.type == "cpu":
        return fd.curl2d(psi)
    if psi.device.type != "cuda":
        raise ValueError(f"curl2d_fused runs on cpu or cuda, got "
                         f"{psi.device}")
    if psi.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "curl2d_fused is forward-only on CUDA: its backward kernel "
            "(_curl2d_bwd) is ROADMAP Queue B item 3; call it under "
            "torch.no_grad() / torch.inference_mode()")
    from deepfluids_tpu_torch.ops._build import library

    out = torch.empty((b, h, w, 2), dtype=psi.dtype, device=psi.device)
    stream = torch.cuda.current_stream(psi.device).cuda_stream
    err = library().df_curl2d(psi.data_ptr(), out.data_ptr(), b, h, w,
                              _DTYPE_CODES[psi.dtype], psi.device.index,
                              stream)
    if err != 0:
        raise RuntimeError(f"curl2d kernel launch failed: cudaError {err}")
    launch_counts["curl2d_fused"] += 1
    return out
