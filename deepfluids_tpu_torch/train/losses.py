"""Losses of archs "de", "ae" and "nn", ported from
:mod:`deepfluids_tpu.train.losses`:

    G = curl(psi);   loss = w1 * dist(G, x) + w2 * dist(J(G), J(x))

(+ ``w3`` times the code's parameter error for "ae"; "nn" takes the mean
squared error of a rolled-out code window)

with ``dist`` the mean absolute ("l1") or squared ("l2") error, optionally
weighted per sample (``relative``).  The curl and the jacobian go through
the differentiable kernel wrappers :func:`cuda_fd.curl2d_p` /
:func:`cuda_fd.jacobian2d_p` for 2D fields ``[B, H, W, C]`` and
:func:`cuda_fd.curl3d_p` / :func:`cuda_fd.jacobian3d_p` for 3D fields
``[B, D, H, W, C]`` (their plain versions for CPU tensors).  For scalar
(levelset) fields the jacobian term is the spatial gradient of the scalar,
in plain torch as in the JAX package.

Several ranks: under data parallelism each rank runs the kernels on its
own rows (the JAX package's ``_maybe_shard_batch``) and takes the mean of
its rows; ``group`` (the data group) makes the relative weights' mean that
of the global batch, so the mean over ranks is the one-process loss.  The
``*_spatial`` functions take the rank's rows of the grid (``rows``, the
data group under ``--spatial_shard``) through the haloed kernels of
:mod:`..parallel.halo` and return the rank's share of the loss: its sum
over the group is the one-process loss.
"""

from __future__ import annotations

from typing import Callable

import torch

from deepfluids_tpu_torch.ops import cuda_fd, fd
from deepfluids_tpu_torch.parallel import halo
from deepfluids_tpu_torch.parallel.comm import (
    SINGLE,
    Shard,
    all_reduce_,
    global_mean,
)


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


def _sample_weights(target: torch.Tensor, eps: float = 0.05,
                    group: Shard = SINGLE,
                    rows: Shard | None = None) -> torch.Tensor:
    """Per-sample weights ~ ``1 / (mean|target| + eps)``, normalized to mean
    1 over the (global) batch, shaped to broadcast over a sample
    (relative-error training).  ``group``: the batch is split over it;
    ``rows``: each sample's rows are."""
    axes = tuple(range(1, target.dim()))
    if rows is None or not rows.active:
        m = torch.mean(torch.abs(target), dim=axes)
    else:
        m = all_reduce_(torch.sum(torch.abs(target), dim=axes), rows) / (
            target[0].numel() * rows.size)
    w = 1.0 / (m + eps)
    w = w / global_mean(w, group)
    return w.reshape((-1,) + (1,) * (target.dim() - 1))


def _weighted(ef: torch.Tensor, ej: torch.Tensor, target: torch.Tensor,
              relative: bool, norm: str, group: Shard,
              rows: Shard | None) -> tuple[torch.Tensor, torch.Tensor]:
    """The field and jacobian terms: means, or, over sharded ``rows``, the
    rank's share of them (its sum over the global count)."""
    if relative:
        wb = _sample_weights(target, group=group, rows=rows)
        if norm == "l2":
            wb = torch.square(wb)
            wb = wb / global_mean(wb, group)
        ef, ej = wb * ef, wb * ej
    if rows is None or not rows.active:
        return torch.mean(ef), torch.mean(ej)
    return (torch.sum(ef) / (ef.numel() * rows.size),
            torch.sum(ej) / (ej.numel() * rows.size))


def field_loss(pred: torch.Tensor, target: torch.Tensor, w1: float,
               w2: float, relative: bool = False, norm: str = "l1",
               group: Shard = SINGLE) -> tuple[torch.Tensor, dict]:
    """``w1 * dist(field) + w2 * dist(jacobian)``, the reconstruction loss.

    ``relative`` weights each sample by :func:`_sample_weights` (squared and
    renormalized for "l2", making it the per-frame relative L2^2)."""
    dist = _dist(norm)
    ef = dist(pred - target)
    ej = dist(jacobian_of(pred) - jacobian_of(target))
    loss_f, loss_j = _weighted(ef, ej, target, relative, norm, group, None)
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
        # The one-card generator's output is contiguous; a channel-sharded
        # conv_out's is a permuted view of its gathered NCDHW map.
        return cuda_fd.curl3d_p(out.contiguous())
    raise ValueError(f"unsupported potential shape {tuple(out.shape)}")


def generator_loss(net_out: torch.Tensor, x: torch.Tensor, use_curl: bool,
                   w1: float, w2: float, relative: bool = False,
                   norm: str = "l1", group: Shard = SINGLE
                   ) -> tuple[torch.Tensor, dict]:
    """Arch "de" loss; ``net_out`` is psi (``use_curl``) or the field."""
    pred = apply_curl(net_out) if use_curl else net_out
    loss, aux = field_loss(pred, x, w1, w2, relative, norm, group)
    aux["pred"] = pred
    return loss, aux


def autoencoder_loss(net_out: torch.Tensor, z: torch.Tensor, x: torch.Tensor,
                     y: torch.Tensor, use_curl: bool, num_param: int,
                     w1: float, w2: float, w3: float, relative: bool = False,
                     norm: str = "l1", group: Shard = SINGLE
                     ) -> tuple[torch.Tensor, dict]:
    """Arch "ae" loss: the reconstruction loss of :func:`generator_loss`
    plus ``w3`` times the mean squared error of ``z[:, :num_param]``
    against the normalized parameters ``y`` (the steerable code)."""
    loss, aux = generator_loss(net_out, x, use_curl, w1, w2, relative, norm,
                               group)
    loss_p = l2(z[:, :num_param], y[:, :num_param])
    aux["loss_param"] = loss_p
    return loss + w3 * loss_p, aux


def jacobian_of_spatial(x: torch.Tensor, rows: Shard) -> torch.Tensor:
    """:func:`jacobian_of` of the rank's rows of a field (haloed kernels;
    a scalar field's gradient in plain torch)."""
    if x.shape[-1] == 1:
        return halo.grad_scalar_sharded(x, rows)
    return halo.jacobian_sharded(x, rows)[0]


def field_loss_spatial(pred: torch.Tensor, target: torch.Tensor, w1: float,
                       w2: float, rows: Shard, relative: bool = False,
                       norm: str = "l1") -> tuple[torch.Tensor, dict]:
    """:func:`field_loss` of the rank's rows ``pred`` / ``target``: the
    rank's share of it (every term too)."""
    dist = _dist(norm)
    ef = dist(pred - target)
    ej = dist(jacobian_of_spatial(pred, rows)
              - jacobian_of_spatial(target, rows))
    loss_f, loss_j = _weighted(ef, ej, target, relative, norm, SINGLE, rows)
    return w1 * loss_f + w2 * loss_j, {"loss_field": loss_f,
                                       "loss_jac": loss_j}


def generator_loss_spatial(net_out: torch.Tensor, x: torch.Tensor,
                           use_curl: bool, w1: float, w2: float, rows: Shard,
                           relative: bool = False, norm: str = "l1"
                           ) -> tuple[torch.Tensor, dict]:
    """Arch "de" loss with the grid's H (2D) / D (3D) axis sharded: the
    rank's share."""
    pred = halo.curl_sharded(net_out, rows) if use_curl else net_out
    loss, aux = field_loss_spatial(pred, x, w1, w2, rows, relative, norm)
    aux["pred"] = pred
    return loss, aux


def autoencoder_loss_spatial(net_out: torch.Tensor, z: torch.Tensor,
                             x: torch.Tensor, y: torch.Tensor,
                             use_curl: bool, num_param: int, w1: float,
                             w2: float, w3: float, rows: Shard,
                             relative: bool = False, norm: str = "l1"
                             ) -> tuple[torch.Tensor, dict]:
    """Arch "ae" loss with the grid's spatial axis sharded: the rank's
    share (the code's error, the same on every rank, counts 1/n here)."""
    loss, aux = generator_loss_spatial(net_out, x, use_curl, w1, w2, rows,
                                       relative, norm)
    loss_p = l2(z[:, :num_param], y[:, :num_param]) / rows.size
    aux["loss_param"] = loss_p
    return loss + w3 * loss_p, aux


def latent_window_loss(z_pred: torch.Tensor, z_true: torch.Tensor,
                       num_param: int | None = None
                       ) -> tuple[torch.Tensor, dict]:
    """Arch "nn" loss over a rollout window ``[W, B, z_num]``: the mean
    squared error of every code after the shared start (the parameter
    block matches by construction, as in the reference).  ``num_param`` is
    the reference's third argument, which it takes and ignores too."""
    loss = l2(z_pred[1:], z_true[1:])
    return loss, {"loss_z": loss}
