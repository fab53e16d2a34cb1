"""The ``--input_pipeline grain`` batch stream, built on ``torch.utils.data``.

Twin of :mod:`deepfluids_tpu.data.grain_loader` (a grain ``DataLoader``):
the same epoch-shuffled stream of normalized field batches, with
worker-process prefetch for datasets too large for ``--cache_data`` or
``--device_data_cache``, and a resume that starts at batch k without
reading the k batches before it.  It imports neither grain nor jax.

What it keeps of grain's stream: the records of shard s of k are the
contiguous block ``[s * (n // k), (s + 1) * (n // k))`` (drop remainder),
shuffled within itself per epoch; batch k is positions ``[kB, (k+1)B)`` of
the epochs' orders concatenated, so an unbounded stream runs across epoch
boundaries and a bounded one drops its last partial batch.  What it does
not keep: grain shuffles with its compiled ``index_shuffle`` at seed +
epoch, this module with ``np.random.default_rng((seed, epoch))``
(:func:`epoch_order`); and grain's batches depend on its worker count (each
worker batches every W-th record), these do not, so a resume under another
``--num_worker`` continues the same stream.
"""

from __future__ import annotations

import gc
from typing import Iterator

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset

from deepfluids_tpu_torch.data.dataset import FieldDataset


class _FieldSource(Dataset):
    """Map-style dataset of normalized ``(field, params)`` frames, over an
    optional subset ``indices`` of the frames (the trainer passes
    ``BatchManager.train_indices`` under ``--eval_holdout_scenes``).  No
    cache, so a worker does not grow its own copy of the data."""

    def __init__(self, dataset_dir: str, field_key: str = "v",
                 indices: np.ndarray | None = None):
        self.ds = FieldDataset(dataset_dir, cache=False, field_key=field_key)
        self.indices = (np.asarray(indices, np.int64)
                        if indices is not None else None)

    def __len__(self) -> int:
        return len(self.ds) if self.indices is None else len(self.indices)

    def __getitem__(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        j = int(i) if self.indices is None else int(self.indices[int(i)])
        return self.ds.get_normalized(j)


def _check_seed(seed: int) -> None:
    """A seed outside [0, 2**32) raises, as grain's sampler does."""
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} must be in [0, 2**32)")


def epoch_order(seed: int, epoch: int, m: int) -> np.ndarray:
    """The order of a shard's ``m`` records in epoch ``epoch``: a
    permutation of ``range(m)`` drawn from ``default_rng((seed, epoch))``
    (the ``step_rng`` idiom)."""
    _check_seed(seed)
    return np.random.default_rng((seed, epoch)).permutation(m)


class _EpochBatches:
    """Batch sampler: source positions of batches ``skip, skip + 1, ...``
    of the shard's epoch-shuffled stream (see the module docstring).  It
    runs in the loader's process, so the stream does not depend on the
    workers."""

    def __init__(self, n: int, batch_size: int, seed: int,
                 num_epochs: int | None, shard_index: int, shard_count: int,
                 skip_batches: int):
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard {shard_index} of {shard_count}")
        self.m = n // shard_count
        if self.m == 0:
            raise ValueError(f"{n} records give shard {shard_index} of "
                             f"{shard_count} none")
        self.start = shard_index * self.m
        self.batch_size = batch_size
        self.seed = seed
        self.end = None if num_epochs is None else num_epochs * self.m
        self.first = skip_batches * batch_size
        _check_seed(seed)

    def __iter__(self) -> Iterator[list[int]]:
        pos, epoch, order = self.first, -1, None
        while self.end is None or pos + self.batch_size <= self.end:
            batch = []
            for p in range(pos, pos + self.batch_size):
                e, k = divmod(p, self.m)
                if e != epoch:
                    epoch, order = e, epoch_order(self.seed, e, self.m)
                batch.append(self.start + int(order[k]))
            yield batch
            pos += self.batch_size


def make_grain_loader(
    dataset_dir: str,
    batch_size: int,
    seed: int = 0,
    field_key: str = "v",
    num_epochs: int | None = None,
    worker_count: int = 4,
    shard_index: int = 0,
    shard_count: int = 1,
    indices: np.ndarray | None = None,
    skip_batches: int = 0,
    pin_memory: bool = False,
) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """Yield ``(x [B, *res, C], y [B, P])`` batches as CPU float32 tensors
    (channels last, normalized to [-1, 1]), pinned if ``pin_memory``.

    Args:
      num_epochs: None streams without end; otherwise the stream stops
        after that many epochs, its last partial batch dropped.
      worker_count: reader processes (0: read in this process); forked,
        they only read ``.npz`` files and never touch CUDA.  The stream is
        the same for every count.
      shard_index / shard_count: this reader's contiguous block of the
        records (grain's ``ShardOptions``, drop remainder).
      indices: optional frame subset (eval-holdout training).
      skip_batches: start at batch ``skip_batches`` directly (a resume):
        nothing before it is read.
      pin_memory: page-locked batches for ``non_blocking`` copies to the
        card; without a card it raises.

    Closing the generator (or its end) shuts the workers down; a worker
    that dies fails the stream.
    """
    if pin_memory and not torch.cuda.is_available():
        raise RuntimeError("pin_memory needs a CUDA card")
    source = _FieldSource(dataset_dir, field_key, indices=indices)
    sampler = _EpochBatches(len(source), batch_size, seed, num_epochs,
                            shard_index, shard_count, skip_batches)
    loader = DataLoader(
        source, batch_sampler=sampler, num_workers=worker_count,
        pin_memory=pin_memory,
        multiprocessing_context="fork" if worker_count else None,
        # the workers' seeds come from here, not from torch's global RNG
        generator=torch.Generator().manual_seed(seed))
    # The forked workers must inherit no unreachable cycle: a worker's
    # collector would free it there, and with it any CUDA tensor it holds
    # (a finished trainer's graph and staging), which aborts the worker.
    gc.collect()
    it = iter(loader)
    try:
        yield from it
    finally:
        shutdown = getattr(it, "_shutdown_workers", None)
        if shutdown is not None:
            shutdown()
