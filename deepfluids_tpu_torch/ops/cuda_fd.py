"""Wrappers around the hand-written Hopper finite-difference kernels.

Counterpart of :mod:`deepfluids_tpu.ops.pallas_fd`.  Each wrapper checks
its input, then dispatches on the device the tensor lies on:

  * a CPU tensor goes to the kernel's plain version: the :mod:`.fd`
    function on the input upcast to f32, each output rounded once to the
    input dtype, which is the kernels' arithmetic;
  * a CUDA tensor launches the kernel from ``csrc/`` on the current stream,
    or raises.  There is no fallback to the plain version on the card.

The forward kernels (``curl2d_fused``, ``jacobian2d_fused`` and the 3D
``curl3d_fused``, ``jacobian3d_fused``) and their transposes (``*_bwd``)
are joined into the ``torch.autograd.Function``s :func:`curl2d_p`,
:func:`jacobian2d_p`, :func:`curl3d_p` and :func:`jacobian3d_p`, the
counterparts of JAX's custom-VJP ``pallas_fd.curl2d_p`` etc., which the
training loss differentiates through.

``launch_counts`` counts kernel launches per wrapper (plain integers, only
incremented where a kernel is launched), so a run can show that its path
went through the kernels.
"""

from __future__ import annotations

from typing import Callable

import torch

from deepfluids_tpu_torch.ops import fd

launch_counts: dict[str, int] = {
    "curl2d_fused": 0, "jacobian2d_fused": 0, "curl2d_bwd": 0,
    "jacobian2d_bwd": 0, "curl3d_fused": 0, "jacobian3d_fused": 0,
    "curl3d_bwd": 0, "jacobian3d_bwd": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _in_f32(fn: Callable, *xs: torch.Tensor):
    """``fn`` on the inputs upcast to f32, each output rounded once to the
    first input's dtype (a no-op pair of casts for f32 inputs)."""
    dt = xs[0].dtype
    out = fn(*(x.float() for x in xs))
    if isinstance(out, tuple):
        return tuple(o.to(dt) for o in out)
    return out.to(dt)


def _check(name: str, t: torch.Tensor, channels: int, min_extent: int,
           ndim: int = 2) -> None:
    """``t`` must be ``[B, *spatial, channels]`` with ``ndim`` spatial dims
    (2: H, W; 3: D, H, W), each >= ``min_extent``, contiguous f32/bf16."""
    axes = "DHW"[3 - ndim:]
    if t.dim() != ndim + 2 or t.shape[-1] != channels:
        raise ValueError(f"{name} wants [B, {', '.join(axes)}, {channels}], "
                         f"got {tuple(t.shape)}")
    spatial = tuple(t.shape[1:-1])
    if min(spatial) < min_extent:
        raise ValueError(f"{name} needs {', '.join(axes)} >= {min_extent}, "
                         f"got {dict(zip(axes, spatial))}")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} wants a contiguous input")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, got {t.device}")


def _launch(name: str, entry: str, ins: list[torch.Tensor],
            out_channels: list[int]) -> list[torch.Tensor]:
    """Launch ``entry`` on ``ins`` (CUDA, checked) into new channels-last
    outputs of ``out_channels`` channels each; count the launch."""
    from deepfluids_tpu_torch.ops._build import library

    x = ins[0]
    for t in ins:
        # The 2D kernels read each point's channels as one vector (float2,
        # float4, ...); the 3D kernels read every channel on its own.
        vector = t.shape[-1] if t.dim() == 4 else 1
        if t.data_ptr() % (vector * t.element_size()):
            raise ValueError(f"{name}: input storage is not aligned to "
                             f"{vector} channels")
    outs = [torch.empty(x.shape[:-1] + (c,), dtype=x.dtype, device=x.device)
            for c in out_channels]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(library(), entry)(
        *(t.data_ptr() for t in ins + outs), *x.shape[:-1],
        _DTYPE_CODES[x.dtype], x.device.index, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launch_counts[name] += 1
    return outs


def curl2d_fused(psi: torch.Tensor) -> torch.Tensor:
    """Kernel-backed :func:`deepfluids_tpu_torch.ops.fd.curl2d`.

    Args:
      psi: ``[B, H, W, 1]`` contiguous stream function, float32 or
        bfloat16, with H and W >= 2.
    Returns:
      ``[B, H, W, 2]`` velocity in the input dtype (f32 math).

    Not differentiable by itself: :func:`curl2d_p` is.
    """
    _check("curl2d_fused", psi, 1, 2)
    if psi.device.type == "cpu":
        return _in_f32(fd.curl2d, psi)
    return _launch("curl2d_fused", "df_curl2d", [psi], [2])[0]


def jacobian2d_fused(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel-backed :func:`deepfluids_tpu_torch.ops.fd.jacobian2d`.

    Args:
      x: ``[B, H, W, 2]`` contiguous velocity, float32 or bfloat16, with H
        and W >= 2.
    Returns:
      ``(J [B, H, W, 4], vort [B, H, W, 1])`` in the input dtype; the
      vorticity ``dvdx - dudy`` is taken in f32 and rounded once.
    """
    _check("jacobian2d_fused", x, 2, 2)
    if x.device.type == "cpu":
        return _in_f32(fd.jacobian2d, x)
    j, vort = _launch("jacobian2d_fused", "df_jacobian2d", [x], [4, 1])
    return j, vort


def curl2d_bwd(g: torch.Tensor) -> torch.Tensor:
    """Kernel-backed :func:`deepfluids_tpu_torch.ops.fd.curl2d_bwd`:
    ``[B, H, W, 2]`` velocity cotangent -> ``[B, H, W, 1]``, H, W >= 3."""
    _check("curl2d_bwd", g, 2, 3)
    if g.device.type == "cpu":
        return _in_f32(fd.curl2d_bwd, g)
    return _launch("curl2d_bwd", "df_curl2d_bwd", [g], [1])[0]


def jacobian2d_bwd(gj: torch.Tensor, gw: torch.Tensor) -> torch.Tensor:
    """Kernel-backed :func:`deepfluids_tpu_torch.ops.fd.jacobian2d_bwd`:
    cotangents ``J [B, H, W, 4]`` and ``vort [B, H, W, 1]`` ->
    ``[B, H, W, 2]``, H, W >= 3."""
    _check("jacobian2d_bwd", gj, 4, 3)
    _check("jacobian2d_bwd", gw, 1, 3)
    _check_pair("jacobian2d_bwd", gj, gw)
    if gj.device.type == "cpu":
        return _in_f32(fd.jacobian2d_bwd, gj, gw)
    return _launch("jacobian2d_bwd", "df_jacobian2d_bwd", [gj, gw], [2])[0]


def _check_pair(name: str, gj: torch.Tensor, gv: torch.Tensor) -> None:
    """The vorticity cotangent must match J's in points, dtype and device."""
    if (gv.shape[:-1] != gj.shape[:-1] or gv.dtype != gj.dtype
            or gv.device != gj.device):
        raise ValueError(f"{name}: vort cotangent {tuple(gv.shape)} "
                         f"{gv.dtype} {gv.device} does not match J's "
                         f"{tuple(gj.shape)} {gj.dtype} {gj.device}")


def curl3d_fused(psi: torch.Tensor) -> torch.Tensor:
    """Kernel-backed :func:`deepfluids_tpu_torch.ops.fd.curl3d`.

    Args:
      psi: ``[B, D, H, W, 3]`` contiguous vector potential, float32 or
        bfloat16, with D, H and W >= 2.
    Returns:
      ``[B, D, H, W, 3]`` velocity in the input dtype (f32 math).

    Not differentiable by itself: :func:`curl3d_p` is.
    """
    _check("curl3d_fused", psi, 3, 2, ndim=3)
    if psi.device.type == "cpu":
        return _in_f32(fd.curl3d, psi)
    return _launch("curl3d_fused", "df_curl3d", [psi], [3])[0]


def jacobian3d_fused(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel-backed :func:`deepfluids_tpu_torch.ops.fd.jacobian3d`.

    Args:
      x: ``[B, D, H, W, 3]`` contiguous velocity, float32 or bfloat16, with
        D, H and W >= 2.
    Returns:
      ``(J [B, D, H, W, 9], vort [B, D, H, W, 3])`` in the input dtype.  The
      vorticity is taken from the f32 derivatives and rounded once, in the
      kernel that writes J.  JAX's ``jacobian3d_fused`` subtracts the stored
      J entries instead: the same in f32, up to a rounding of J in bf16.
    """
    _check("jacobian3d_fused", x, 3, 2, ndim=3)
    if x.device.type == "cpu":
        return _in_f32(fd.jacobian3d, x)
    j, vort = _launch("jacobian3d_fused", "df_jacobian3d", [x], [9, 3])
    return j, vort


def curl3d_bwd(g: torch.Tensor) -> torch.Tensor:
    """Kernel-backed :func:`deepfluids_tpu_torch.ops.fd.curl3d_bwd`:
    ``[B, D, H, W, 3]`` velocity cotangent -> ``[B, D, H, W, 3]``, with D,
    H, W >= 3."""
    _check("curl3d_bwd", g, 3, 3, ndim=3)
    if g.device.type == "cpu":
        return _in_f32(fd.curl3d_bwd, g)
    return _launch("curl3d_bwd", "df_curl3d_bwd", [g], [3])[0]


def jacobian3d_bwd(gj: torch.Tensor, gv: torch.Tensor) -> torch.Tensor:
    """Kernel-backed :func:`deepfluids_tpu_torch.ops.fd.jacobian3d_bwd`:
    cotangents ``J [B, D, H, W, 9]`` and ``vort [B, D, H, W, 3]`` ->
    ``[B, D, H, W, 3]``, with D, H, W >= 3.

    The kernel folds the vorticity cotangent into J's at each point it
    reads, in f32.  JAX adds it to ``gj`` before its kernel, in the
    cotangents' dtype: the same in f32, one rounding more in bf16.
    """
    _check("jacobian3d_bwd", gj, 9, 3, ndim=3)
    _check("jacobian3d_bwd", gv, 3, 3, ndim=3)
    _check_pair("jacobian3d_bwd", gj, gv)
    if gj.device.type == "cpu":
        return _in_f32(fd.jacobian3d_bwd, gj, gv)
    return _launch("jacobian3d_bwd", "df_jacobian3d_bwd", [gj, gv], [3])[0]


def _check_min3(x: torch.Tensor, name: str) -> None:
    """The transposed stencils need every differenced extent >= 3: at 2 the
    last-row rule overwrites the first-row one and the cotangent is wrong
    (``pallas_fd._check_min3``)."""
    spatial = tuple(x.shape[1:-1])
    if any(n < 3 for n in spatial):
        raise ValueError(
            f"{name}: spatial dims {spatial} must all be >= 3 (the "
            f"transposed-stencil VJP is wrong at size 2; use the ops.fd "
            f"oracle for degenerate grids)")


class _Curl2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, psi):
        return curl2d_fused(psi)

    @staticmethod
    def backward(ctx, g):
        return curl2d_bwd(g.contiguous())


class _Jacobian2d(torch.autograd.Function):
    # An unused output's cotangent arrives as zeros (materialized grads),
    # as JAX passes them; the backward kernel takes any vort cotangent.
    @staticmethod
    def forward(ctx, x):
        return jacobian2d_fused(x)

    @staticmethod
    def backward(ctx, gj, gw):
        return jacobian2d_bwd(gj.contiguous(), gw.contiguous())


class _Curl3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, psi):
        return curl3d_fused(psi)

    @staticmethod
    def backward(ctx, g):
        return curl3d_bwd(g.contiguous())


class _Jacobian3d(torch.autograd.Function):
    # As _Jacobian2d: an unused vorticity's cotangent arrives as zeros.
    @staticmethod
    def forward(ctx, x):
        return jacobian3d_fused(x)

    @staticmethod
    def backward(ctx, gj, gv):
        return jacobian3d_bwd(gj.contiguous(), gv.contiguous())


def _needs_grad(x: torch.Tensor) -> bool:
    return x.requires_grad and torch.is_grad_enabled()


def curl2d_p(psi: torch.Tensor) -> torch.Tensor:
    """Differentiable :func:`curl2d_fused`: forward ``curl2d_fused``,
    backward ``curl2d_bwd``.  Raises ``ValueError`` when a gradient is
    required and H or W < 3."""
    if _needs_grad(psi):
        _check_min3(psi, "curl2d_p")
    return _Curl2d.apply(psi)


def jacobian2d_p(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable :func:`jacobian2d_fused`: forward
    ``jacobian2d_fused``, backward ``jacobian2d_bwd``.  Raises
    ``ValueError`` when a gradient is required and H or W < 3."""
    if _needs_grad(x):
        _check_min3(x, "jacobian2d_p")
    return _Jacobian2d.apply(x)


def curl3d_p(psi: torch.Tensor) -> torch.Tensor:
    """Differentiable :func:`curl3d_fused`: forward ``curl3d_fused``,
    backward ``curl3d_bwd``.  Raises ``ValueError`` when a gradient is
    required and D, H or W < 3."""
    if _needs_grad(psi):
        _check_min3(psi, "curl3d_p")
    return _Curl3d.apply(psi)


def jacobian3d_p(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable :func:`jacobian3d_fused`: forward
    ``jacobian3d_fused``, backward ``jacobian3d_bwd``.  Raises
    ``ValueError`` when a gradient is required and D, H or W < 3."""
    if _needs_grad(x):
        _check_min3(x, "jacobian3d_p")
    return _Jacobian3d.apply(x)
