"""Loss of arch "de", ported from :mod:`deepfluids_tpu.train.losses`:

    G = curl(psi);   loss = w1 * dist(G, x) + w2 * dist(J(G), J(x))

with ``dist`` the mean absolute ("l1") or squared ("l2") error, optionally
weighted per sample (``relative``).  The curl and the jacobian go through
the differentiable kernel wrappers :func:`cuda_fd.curl2d_p` /
:func:`cuda_fd.jacobian2d_p` for 2D fields ``[B, H, W, C]`` and
:func:`cuda_fd.curl3d_p` / :func:`cuda_fd.jacobian3d_p` for 3D fields
``[B, D, H, W, C]`` (their plain versions for CPU tensors).  For scalar
(levelset) fields the jacobian term is the spatial gradient of the scalar,
in plain torch as in the JAX package.  The JAX package's multi-chip
``_maybe_shard_batch`` is not ported (one card runs each kernel on the
whole batch).
"""

from __future__ import annotations

from typing import Callable

import torch

from deepfluids_tpu_torch.ops import cuda_fd, fd


def _dist(norm: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Per-element distance; an unknown name raises."""
    if norm == "l1":
        return torch.abs
    if norm == "l2":
        return torch.square
    raise ValueError(f"loss_norm must be 'l1' or 'l2', got {norm!r}")


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(a - b))


def _grad_scalar(x: torch.Tensor) -> torch.Tensor:
    """Spatial gradient of a scalar field ``[B, *spatial, 1]`` ->
    ``[B, *spatial, nd]`` (x, y[, z] order)."""
    s = x[..., 0]
    nd = x.dim() - 2
    return torch.stack([fd._fdiff(s, -(k + 1)) for k in range(nd)], dim=-1)


def jacobian_of(x: torch.Tensor) -> torch.Tensor:
    """First-derivative stack of a field: ``[B, H, W, 2]`` -> ``[B, H, W, 4]``
    through :func:`cuda_fd.jacobian2d_p`, ``[B, D, H, W, 3]`` ->
    ``[B, D, H, W, 9]`` through :func:`cuda_fd.jacobian3d_p`; a scalar
    ``[..., 1]`` -> its spatial gradient."""
    if x.shape[-1] == 1:
        return _grad_scalar(x)
    # The generator's direct (use_curl False) output is a permuted view.
    if x.dim() == 4:
        j, _ = cuda_fd.jacobian2d_p(x.contiguous())
        return j
    if x.dim() == 5:
        j, _ = cuda_fd.jacobian3d_p(x.contiguous())
        return j
    raise ValueError(f"unsupported field shape {tuple(x.shape)}")


def _sample_weights(target: torch.Tensor,
                    eps: float = 0.05) -> torch.Tensor:
    """Per-sample weights ~ ``1 / (mean|target| + eps)``, normalized to mean
    1, shaped to broadcast over a sample (relative-error training)."""
    axes = tuple(range(1, target.dim()))
    w = 1.0 / (torch.mean(torch.abs(target), dim=axes) + eps)
    w = w / torch.mean(w)
    return w.reshape((-1,) + (1,) * (target.dim() - 1))


def field_loss(pred: torch.Tensor, target: torch.Tensor, w1: float,
               w2: float, relative: bool = False,
               norm: str = "l1") -> tuple[torch.Tensor, dict]:
    """``w1 * dist(field) + w2 * dist(jacobian)``, the reconstruction loss.

    ``relative`` weights each sample by :func:`_sample_weights` (squared and
    renormalized for "l2", making it the per-frame relative L2^2)."""
    dist = _dist(norm)
    ef = dist(pred - target)
    ej = dist(jacobian_of(pred) - jacobian_of(target))
    if relative:
        wb = _sample_weights(target)
        if norm == "l2":
            wb = torch.square(wb)
            wb = wb / torch.mean(wb)
        loss_f = torch.mean(wb * ef)
        loss_j = torch.mean(wb * ej)
    else:
        loss_f = torch.mean(ef)
        loss_j = torch.mean(ej)
    return w1 * loss_f + w2 * loss_j, {"loss_field": loss_f,
                                       "loss_jac": loss_j}


def apply_curl(out: torch.Tensor) -> torch.Tensor:
    """psi ``[B, H, W, 1]`` -> velocity ``[B, H, W, 2]`` through
    :func:`cuda_fd.curl2d_p`, Psi ``[B, D, H, W, 3]`` -> velocity
    ``[B, D, H, W, 3]`` through :func:`cuda_fd.curl3d_p` (differentiable;
    their plain versions for a CPU tensor)."""
    if out.dim() == 4:
        return cuda_fd.curl2d_p(out)
    if out.dim() == 5:
        # The generator's 3-channel output is a permuted view.
        return cuda_fd.curl3d_p(out.contiguous())
    raise ValueError(f"unsupported potential shape {tuple(out.shape)}")


def generator_loss(net_out: torch.Tensor, x: torch.Tensor, use_curl: bool,
                   w1: float, w2: float, relative: bool = False,
                   norm: str = "l1") -> tuple[torch.Tensor, dict]:
    """Arch "de" loss; ``net_out`` is psi (``use_curl``) or the field."""
    pred = apply_curl(net_out) if use_curl else net_out
    loss, aux = field_loss(pred, x, w1, w2, relative, norm)
    aux["pred"] = pred
    return loss, aux
