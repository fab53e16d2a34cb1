"""The ranks of a multi-process run as a (data, model) layout, batch
sharding, gradient reduction and the channel-sharded parameters.

Counterpart of :mod:`deepfluids_tpu.parallel.mesh`.  JAX arranges devices
in a ``(data, model)`` mesh; here every rank is one process with one device
(a chip and a host alike), and the mesh is the world split into process
groups, rank ``r = data_index * num_model + model_index`` (the JAX mesh's
reshape order):

  * the data group, the ``num_data`` ranks of one model index, splits each
    batch into equal blocks of rows (or, under ``--spatial_shard``, the
    grid's first axis) and reduces the gradients;
  * the model group, the ``num_model`` ranks of one data index, splits the
    output channels of each conv whose count it divides (tensor
    parallelism); dense layers, biases and the knobs' tables stay
    replicated, and Adam's moments follow their parameters.

Gradients: data parallelism averages them over the data group, spatial
sharding sums them (each rank backpropagates its share of one loss), and
the model group needs no reduction (:mod:`.comm` makes every rank's
gradient whole).  :func:`reduce_grads_` is the one place that rule lives.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from deepfluids_tpu_torch.parallel.comm import (
    SINGLE,
    Shard,
    _cat_slots,
    all_reduce_,
    gather_slots,
)

BACKEND_ENV = "DEEPFLUIDS_DIST_BACKEND"


def init_distributed(device: str | torch.device = "cuda") -> torch.device:
    """Join the process group that torchrun (or the launcher) describes
    in ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``; returns this rank's device.

    Without ``WORLD_SIZE`` it is a no-op and returns ``device``.  A CUDA
    rank takes ``cuda:LOCAL_RANK`` (modulo the visible cards, so several
    ranks can share one card under gloo) and NCCL; a CPU rank gloo.
    ``DEEPFLUIDS_DIST_BACKEND`` overrides the backend (gloo on the card
    carries its collectives through host memory; NCCL refuses two ranks on
    one device)."""
    device = torch.device(device)
    if "WORLD_SIZE" not in os.environ:
        return device
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: a CUDA rank needs a card "
                               "and torch.cuda.is_available() is False")
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = os.environ.get(BACKEND_ENV) or (
        "nccl" if device.type == "cuda" else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=rank, world_size=world)
    return device


def world() -> tuple[int, int]:
    """``(rank, world size)``; ``(0, 1)`` outside a process group."""
    if not dist.is_available() or not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


@dataclasses.dataclass(frozen=True)
class Layout:
    """This rank's place in the run: its ``data`` and ``model`` shards and
    whether the data axis splits the grid (``spatial``) or the batch."""
    rank: int = 0
    world: int = 1
    data: Shard = SINGLE
    model: Shard = SINGLE
    spatial: bool = False

    @property
    def batch(self) -> Shard:
        """The shard that splits the batch (none under spatial)."""
        return SINGLE if self.spatial else self.data

    @property
    def rows(self) -> Shard | None:
        """The shard that splits the grid's first axis (spatial only)."""
        return self.data if self.spatial and self.data.active else None


_GROUPS: dict[tuple[int, ...], object] = {}


def _group(ranks: list[int]):
    """The process group of ``ranks``, made once for the whole world (every
    rank makes every group, in the same order)."""
    key = tuple(ranks)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(ranks))
    return _GROUPS[key]


def make_layout(num_data: int = 0, num_model: int = 1,
                spatial: bool = False) -> Layout:
    """The world split into data x model groups.  ``num_data`` 0 takes
    ``world // num_model``; a layout that does not use every rank raises,
    as the reference's ``make_mesh`` raises for a mesh larger than the
    devices it has."""
    rank, size = world()
    num_model = max(1, int(num_model or 1))
    num_data = int(num_data) or max(1, size // num_model)
    if num_data * num_model != size:
        raise ValueError(f"mesh {num_data}x{num_model} needs "
                         f"{num_data * num_model} devices (ranks), have "
                         f"{size}")
    if size == 1:
        return Layout(spatial=spatial)
    d, m = divmod(rank, num_model)
    groups = {}
    for mi in range(num_model):
        ranks = [di * num_model + mi for di in range(num_data)]
        groups[("data", mi)] = _group(ranks) if num_data > 1 else None
    for di in range(num_data):
        ranks = [di * num_model + mi for mi in range(num_model)]
        groups[("model", di)] = _group(ranks) if num_model > 1 else None
    return Layout(rank=rank, world=size,
                  data=Shard(groups[("data", m)], d, num_data),
                  model=Shard(groups[("model", d)], m, num_model),
                  spatial=spatial)


def local_rows(a: np.ndarray | torch.Tensor, shard: Shard, axis: int = 0,
               pair: bool = False):
    """This rank's block of a global batch along ``axis`` (0 for fields,
    1 for the ``[W, B, ...]`` windows of arch "nn").  ``pair``: a ``[2B]``
    ``[x_t ; x_{t+1}]`` batch, of which the rank takes its rows of each
    half, ``[its t rows ; its t+1 rows]``.  An indivisible batch raises, as
    the reference's ``shard_batch``."""
    if not shard.active:
        return a
    halves = 2 if pair else 1
    b = a.shape[axis] // halves
    if a.shape[axis] % halves or b % shard.size:
        raise ValueError(f"batch dim {b} not divisible by data-axis size "
                         f"{shard.size}")
    rows = b // shard.size
    idx = np.concatenate([np.arange(k * b + shard.index * rows,
                                    k * b + (shard.index + 1) * rows)
                          for k in range(halves)])
    if isinstance(a, torch.Tensor):
        return a.index_select(axis, torch.from_numpy(idx).to(a.device))
    return np.take(a, idx, axis=axis)


@torch.no_grad()
def reduce_grads_(params: list[torch.nn.Parameter], layout: Layout) -> None:
    """Make every rank's gradients those of the whole step, in one
    collective: the mean over the data group (data parallelism: each rank
    took the mean of its rows) or the sum (spatial sharding: each rank took
    its share of one loss).  The model group needs nothing."""
    shard = layout.data
    if not shard.active:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    all_reduce_(flat, shard)
    if not layout.spatial:
        flat /= shard.size
    offset = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


# -- tensor parallelism: the parameters of a model group ------------------

def shard_channels_(model: torch.nn.Module, shard: Shard) -> list[str]:
    """Cut each conv weight (``[out, in, *kernel]``) whose output channels
    divide by the model group to the rank's block, in place, and mark its
    module ``tp_shard``; returns the cut parameters' names.  Run after the
    init, so a model group starts from the one-rank model's weights."""
    if not shard.active:
        return []
    names = []
    for name, module in model.named_modules():
        if not isinstance(module, (torch.nn.Conv2d, torch.nn.Conv3d)):
            continue
        w = module.weight
        if w.shape[0] % shard.size:
            continue
        k = w.shape[0] // shard.size
        module.weight = torch.nn.Parameter(
            w.detach()[shard.index * k:(shard.index + 1) * k].clone())
        module.tp_shard = shard
        names.append(f"{name}.weight" if name else "weight")
    return names


def _gather_dim0(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    return _cat_slots(gather_slots(t, shard), 0)


def _own_dim0(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    k = t.shape[0] // shard.size
    return t[shard.index * k:(shard.index + 1) * k].clone()


def gather_cut(tensors: dict[str, torch.Tensor], cut: list[str],
               shard: Shard) -> dict[str, torch.Tensor]:
    """``tensors`` (a ``state_dict`` or gradients by name) with each cut
    one gathered whole; every rank of the model group must call it."""
    return {k: _gather_dim0(v, shard) if k in cut else v
            for k, v in tensors.items()}


def local_state_dict(full: dict[str, torch.Tensor], cut: list[str],
                     shard: Shard) -> dict[str, torch.Tensor]:
    """A whole ``state_dict`` cut to this rank's blocks."""
    return {k: _own_dim0(v, shard) if k in cut else v
            for k, v in full.items()}


def _opt_state_map(opt: torch.optim.Optimizer, model: torch.nn.Module,
                   cut: list[str]) -> set[int]:
    """Indices (in the optimizer's order) of the cut parameters."""
    ids = {id(p): i for i, p in enumerate(
        p for g in opt.param_groups for p in g["params"])}
    return {ids[id(p)] for n, p in model.named_parameters() if n in cut}


def full_optimizer_state(opt: torch.optim.Optimizer, model: torch.nn.Module,
                         cut: list[str], shard: Shard) -> dict:
    """``opt.state_dict()`` with the moments of the cut parameters
    gathered whole."""
    sd = opt.state_dict()
    if not cut:
        return sd
    idx = _opt_state_map(opt, model, cut)
    state = {i: {k: _gather_dim0(v, shard) if i in idx and v.dim() else v
                 for k, v in s.items()} for i, s in sd["state"].items()}
    return {**sd, "state": state}


def local_optimizer_state(sd: dict, opt: torch.optim.Optimizer,
                          model: torch.nn.Module, cut: list[str],
                          shard: Shard) -> dict:
    """A whole optimizer ``state_dict`` cut to this rank's blocks."""
    if not cut:
        return sd
    idx = _opt_state_map(opt, model, cut)
    state = {i: {k: _own_dim0(v, shard) if int(i) in idx and v.dim() else v
                 for k, v in s.items()} for i, s in sd["state"].items()}
    return {**sd, "state": state}


@torch.no_grad()
def grad_sq_norm(model: torch.nn.Module, cut: list[str],
                 shard: Shard) -> torch.Tensor:
    """The squared global norm of the gradients of the whole (uncut)
    model: the cut parameters' squares summed over the model group."""
    own, rep = [], []
    for name, p in model.named_parameters():
        if p.grad is not None:
            (own if name in cut else rep).append(torch.sum(p.grad ** 2))
    zero = next(model.parameters()).new_zeros(())
    s_cut = sum(own, zero).reshape(1)
    if own:
        all_reduce_(s_cut, shard)
    return sum(rep, zero) + s_cut[0]
