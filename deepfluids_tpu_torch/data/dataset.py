"""Field / latent-code datasets and the prefetching BatchManager.

The port's own copy of :mod:`deepfluids_tpu.data.dataset` (numpy only):
the same files, batches and (seed, step) index stream.

Replaces the reference's TF1 FIFOQueue + Python feeder threads (SURVEY.md §2
"Batch manager" [M]) with:
  * an optional in-RAM cache (the 2D datasets are ~2 GB decompressed — the
    .npz inflate is the reference's classic input bottleneck, SURVEY §3.1);
  * a thread-pool prefetcher that decompresses the next batch while the
    device is busy with the current step;
  * host-side normalization to [-1, 1] by the manifest ranges.

Device placement/sharding is the trainer's job (pjit in_shardings); this
module yields ready numpy batches.
"""

from __future__ import annotations

import concurrent.futures as cf
import glob
import os
import threading
from typing import Iterator, Sequence

import numpy as np

from deepfluids_tpu_torch.data.manifest import Manifest, load_manifest


def step_rng(seed: int, step: int) -> np.random.Generator:
    """Deterministic per-step Generator (the ``jax.random.fold_in`` idiom).

    The training data order is a pure function of (seed, global step): exact
    crash-resume (SURVEY.md §5 checkpoint contract, "RNG") needs no RNG
    state in the checkpoint — a resumed run recomputes the identical batch
    sequence from the restored step number, immune to the prefetch worker
    having drawn ahead at save time."""
    return np.random.default_rng((seed, step))


def step_batch_indices(seed: int, step: int, n: int,
                       batch_size: int) -> np.ndarray:
    """Batch indices for one global step (see :func:`step_rng`)."""
    return step_rng(seed, step).integers(0, n, size=batch_size).astype(
        np.int32)


def step_batch_indices_block(seed: int, step: int, k: int, n: int,
                             batch_size: int) -> np.ndarray:
    """``[k, batch_size]`` int32: row ``i`` is :func:`step_batch_indices`
    at step ``step + i``, the draws of a chunk of ``k`` steps."""
    return np.stack([step_batch_indices(seed, step + i, n, batch_size)
                     for i in range(k)])


class FieldDataset:
    """Random-access view over ``data/<name>/v/*.npz`` (field + raw params)."""

    def __init__(self, dataset_dir: str, cache: bool = True,
                 field_key: str = "v"):
        self.dataset_dir = dataset_dir
        self.manifest = load_manifest(dataset_dir)
        self.files = sorted(
            glob.glob(os.path.join(dataset_dir, field_key, "*.npz"))
        )
        if not self.files:
            raise FileNotFoundError(
                f"no .npz fields under {dataset_dir}/{field_key}/"
            )
        self._cache: dict[int, tuple[np.ndarray, np.ndarray]] | None = (
            {} if cache else None
        )
        self._lock = threading.Lock()
        self._succ: np.ndarray | None = None

    @property
    def scene_keys(self) -> list[str]:
        """Per-file scene identity: the filename minus its ``_<frame>.npz``
        tail (datagen names frames ``<scene params>_<frame>.npz``)."""
        return [os.path.basename(f)[:-4].rsplit("_", 1)[0]
                for f in self.files]

    # Picklable for multiprocess loaders (grain workers): drop the lock and
    # the cache, recreate on unpickle.
    def __getstate__(self):
        state = self.__dict__.copy()
        state["_lock"] = None
        state["_cache"] = {} if state["_cache"] is not None else None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.files)

    @property
    def successor(self) -> np.ndarray:
        """``succ[i]`` = global index of the SAME scene's next frame, or -1.

        Temporal pairing for the prediction-aware AE objective
        (``--ae_pred_w``).  Frame numbers are parsed from the filename tail:
        datagen names frames ``<scene>_<frame>.npz`` WITHOUT zero-padding,
        so lexical file order is not temporal order and ``i+1`` is NOT the
        successor — the map goes through (scene, frame+1) lookup."""
        if self._succ is None:
            pos: dict[tuple[str, int], int] = {}
            for i, f in enumerate(self.files):
                scene, frame = os.path.basename(f)[:-4].rsplit("_", 1)
                pos[(scene, int(frame))] = i
            succ = np.full(len(self.files), -1, np.int32)
            for (scene, frame), i in pos.items():
                j = pos.get((scene, frame + 1))
                if j is not None:
                    succ[i] = j
            self._succ = succ
        return self._succ

    def _load(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        # Native C++ reader (zip walk + zlib inflate, GIL-free) when built;
        # transparent numpy fallback (deepfluids_tpu_torch.data.native_npz).
        # Exact capacities from the manifest avoid the default 64 MB
        # scratch allocation per read.
        from deepfluids_tpu_torch.data.native_npz import load_npz_field

        m = self.manifest
        x = load_npz_field(self.files[i], "x",
                           capacity=int(np.prod(m.field_shape)))
        y = load_npz_field(self.files[i], "y", capacity=max(m.num_param, 8))
        return x, y

    def get(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(field, raw_params) for frame ``i`` — cached after first read."""
        if self._cache is None:
            return self._load(i)
        with self._lock:
            hit = self._cache.get(i)
        if hit is not None:
            return hit
        item = self._load(i)
        with self._lock:
            self._cache[i] = item
        return item

    def get_normalized(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        x, y = self.get(i)
        m = self.manifest
        return (
            m.normalize_field(x).astype(np.float32),
            m.normalize_params(y).astype(np.float32),
        )


def select_holdout_keys(distinct: Sequence[str], n: int,
                        mode: str = "edge") -> set:
    """Pick the ``n`` held-out scene keys from the sorted distinct keys.

    ``edge`` (historical default): the lexically-LAST n scenes.  For
    grid-sampled parameter families (scene keys are grid-index tuples like
    ``"<pos>_<size>"``) that is the parameter-box EDGE, so the holdout
    number measures EXTRAPOLATION.

    ``interior``: scenes whose every grid coordinate is strictly inside its
    dimension's [min, max] (parsed from the key's ``_``-separated integer
    coordinates), stratified by picking n evenly spaced entries of the
    sorted interior pool.  Measures INTERPOLATION — the reference's actual
    use case is sweeping inside the sampled box (SURVEY §4/§6; r4 VERDICT
    missing #5 — edge holdouts conflated the two).

    Keys without all-integer coordinates (e.g. random-trajectory families)
    have no grid geometry: interior mode falls back to evenly spaced
    non-endpoint keys, which at least avoids the lexical extremes.
    """
    distinct = sorted(distinct)
    if mode == "edge" or n == 0:
        return set(distinct[-n:]) if n else set()
    if mode != "interior":
        raise ValueError(f"holdout_mode must be edge|interior, got {mode!r}")
    try:
        coords = np.array([[int(c) for c in k.split("_")] for k in distinct])
        if coords.ndim != 2:  # ragged coordinate counts
            raise ValueError
        lo, hi = coords.min(0), coords.max(0)
        inner = [k for k, c in zip(distinct, coords)
                 if np.all(c > lo) and np.all(c < hi)]
    except ValueError:
        inner = distinct[1:-1]
    if n > len(inner):
        raise ValueError(
            f"holdout_mode=interior needs {n} interior scenes but this "
            f"{len(distinct)}-scene dataset has only {len(inner)} "
            "(grid too small, or scene keys are not grid coordinates)")
    pick = np.round(np.linspace(0, len(inner) - 1, n)).astype(int)
    return {inner[i] for i in pick}


class BatchManager:
    """Random-batch sampler with thread-pool prefetch.

    Usage::

        bm = BatchManager(dataset_dir, batch_size=8, seed=0)
        for x, y in bm.batches(num_steps):   # numpy [B, ...], [B, P] in [-1,1]
            ...
    """

    def __init__(self, dataset_dir: str, batch_size: int, seed: int = 0,
                 cache: bool = True, num_workers: int = 8,
                 field_key: str = "v", holdout_scenes: int = 0,
                 holdout_mode: str = "edge", pair: bool = False):
        self.ds = FieldDataset(dataset_dir, cache=cache, field_key=field_key)
        self.manifest = self.ds.manifest
        self.batch_size = batch_size
        self.seed = seed
        self.pair = pair
        self.rng = np.random.default_rng(seed)
        # Scene-level eval holdout: holdout_scenes distinct scenes — the
        # lexically-last ("edge", extrapolation) or stratified interior
        # grid scenes ("interior", interpolation; see select_holdout_keys)
        # — are excluded from training draws; evaluate() samples them
        # instead.  With holdout_scenes=0, train_indices is the identity
        # and the batch stream is bit-identical to always.
        keys = self.ds.scene_keys
        distinct = sorted(set(keys))
        if holdout_scenes < 0 or holdout_scenes >= len(distinct):
            # A negative value would silently become a near-total holdout
            # via the distinct[-N:] slice (e.g. -1 -> all but one scene).
            raise ValueError(
                f"eval_holdout_scenes={holdout_scenes} must be in "
                f"[0, {len(distinct)}) for this {len(distinct)}-scene "
                "dataset")
        held = select_holdout_keys(distinct, holdout_scenes, holdout_mode)
        self.train_indices = np.array(
            [i for i, k in enumerate(keys) if k not in held], np.int32)
        self.eval_indices = np.array(
            [i for i, k in enumerate(keys) if k in held], np.int32)
        if pair:
            # (t, t+1) frame pairs for --ae_pred_w: draws come from train
            # frames that HAVE a same-scene successor (the holdout is
            # per-scene, so a valid successor of a train frame is itself
            # in the train pool).
            succ = self.ds.successor
            self.train_pair_indices = self.train_indices[
                succ[self.train_indices] >= 0]
            if not len(self.train_pair_indices):
                raise ValueError(
                    "pair=True but no frame has a same-scene successor "
                    "(single-frame scenes?)")
        self.pool = cf.ThreadPoolExecutor(max_workers=max(num_workers, 1))
        # Separate 1-thread executor for batch-level prefetch: submitting
        # sample_batch to self.pool and blocking on pool.map inside it
        # deadlocks when num_workers == 1 (the lone worker waits on work
        # that can never be scheduled).
        self._prefetch = cf.ThreadPoolExecutor(max_workers=1)

    def _gather(self, idx: Sequence[int]) -> tuple[np.ndarray, np.ndarray]:
        items = list(self.pool.map(self.ds.get_normalized, idx))
        x = np.stack([it[0] for it in items])
        y = np.stack([it[1] for it in items])
        return x, y

    def sample_batch(self, rng: np.random.Generator | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
        """One random batch.  ``rng`` defaults to the training stream;
        callers on other threads (e.g. sample dumps while the prefetch
        worker is drawing training batches) MUST pass their own Generator —
        np.random.Generator is not thread-safe."""
        rng = rng if rng is not None else self.rng
        if self.pair:
            idx = rng.integers(0, len(self.train_pair_indices),
                               size=self.batch_size)
            return self._pair_gather(self.train_pair_indices[idx])
        idx = rng.integers(0, len(self.train_indices), size=self.batch_size)
        return self._gather(self.train_indices[idx])

    def _pair_gather(self, idx_t: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Gather frames t and t+1 stacked along batch: ``x`` is
        ``[2B, ...]`` with rows ``[x_t ; x_{t+1}]`` (the --ae_pred_w loss
        splits at B)."""
        return self._gather(
            np.concatenate([idx_t, self.ds.successor[idx_t]]))

    def step_batch(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        """The batch for global step ``step`` — stateless (see step_rng).

        Draws positions in the TRAIN subset and maps through train_indices
        (the identity without a holdout, so the historical stream is
        preserved bit-for-bit).  In ``pair`` mode the draw is over the
        pair pool and the gathered batch is ``[2B, ...]``
        (:meth:`_pair_gather`)."""
        if self.pair:
            idx = step_batch_indices(self.seed, step,
                                     len(self.train_pair_indices),
                                     self.batch_size)
            return self._pair_gather(self.train_pair_indices[idx])
        idx = step_batch_indices(self.seed, step, len(self.train_indices),
                                 self.batch_size)
        return self._gather(self.train_indices[idx])

    def batches(self, num_steps: int, start_step: int = 0
                ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Yield the batches for global steps ``start_step+1 ..
        start_step+num_steps``, prefetching one step ahead.

        Batch content is a pure function of (seed, step), so interrupting
        and resuming at any step reproduces the identical stream."""
        nxt = self._prefetch.submit(self.step_batch, start_step + 1)
        for k in range(num_steps):
            cur = nxt.result()
            if k + 1 < num_steps:
                nxt = self._prefetch.submit(self.step_batch,
                                            start_step + k + 2)
            yield cur

    def close(self) -> None:
        """Shut down the worker pools (idempotent)."""
        self.pool.shutdown(wait=False)
        self._prefetch.shutdown(wait=False)

    def denorm(self, x: np.ndarray) -> np.ndarray:
        return self.manifest.denormalize_field(x)


class CodeDataset:
    """Latent-code sequences for the integrator (arch "nn").

    Reads ``data/<name>/code<z_num><suffix>/<scene>.npz`` files written by the AE
    encode pass (SURVEY.md §3.3): per scene, ``z = [T, z_num]`` (already in
    the AE's latent space, front dims = normalized params) and
    ``p = [T, num_param]`` raw params.

    ``window_batch`` serves random windows of ``w`` consecutive codes for
    recurrent training (SURVEY.md §3.4; w ~= 30 [B]).

    ``holdout_scenes`` mirrors BatchManager's contract: the LAST N scenes
    (sorted name order — the same set the AE's field-level holdout picks,
    so one --eval_holdout_scenes value partitions the whole cfg-4 pipeline
    consistently) never enter training draws; their code sequences stay
    loaded for evaluation.
    """

    def __init__(self, dataset_dir: str, z_num: int, seed: int = 0,
                 holdout_scenes: int = 0, suffix: str = "",
                 holdout_mode: str = "edge"):
        self.seed = seed
        self.manifest = load_manifest(dataset_dir)
        self.code_dir = os.path.join(dataset_dir, f"code{z_num}{suffix}")
        files = sorted(glob.glob(os.path.join(self.code_dir, "*.npz")))
        if not files:
            raise FileNotFoundError(f"no code files under {self.code_dir}")
        if holdout_scenes < 0 or holdout_scenes >= len(files):
            # Same guard as BatchManager: a negative value would silently
            # become a near-total holdout downstream.
            raise ValueError(
                f"eval_holdout_scenes={holdout_scenes} must be in "
                f"[0, {len(files)}) for this {len(files)}-scene code set")
        # Scene stems (filename minus .npz) in file order — index-aligned
        # with self.z/self.p, so eval code can find each code sequence's
        # ground-truth frames (<scene>_<frame>.npz) on disk.
        self.scenes = [os.path.basename(fp)[:-4] for fp in files]
        # Same holdout rule as BatchManager (one --eval_holdout_scenes /
        # --holdout_mode pair partitions the whole cfg-4 pipeline).  In
        # edge mode train_scene_indices is arange(n_train): window_batch
        # draws map through it as the identity, so historical streams are
        # preserved bit-for-bit.
        held = select_holdout_keys(self.scenes, holdout_scenes, holdout_mode)
        self.train_scene_indices = np.array(
            [i for i, s in enumerate(self.scenes) if s not in held],
            np.int32)
        self._eval_scene_indices = np.array(
            [i for i, s in enumerate(self.scenes) if s in held], np.int32)
        self.num_train_scenes = len(self.train_scene_indices)
        self.z: list[np.ndarray] = []
        self.p: list[np.ndarray] = []
        for fp in files:
            with np.load(fp) as d:
                self.z.append(d["z"].astype(np.float32))
                self.p.append(
                    self.manifest.normalize_params(d["p"]).astype(np.float32)
                )
        self.rng = np.random.default_rng(seed)

    @property
    def num_scenes(self) -> int:
        return len(self.z)

    @property
    def eval_scene_indices(self) -> np.ndarray:
        """Indices of the held-out scenes (empty without a holdout)."""
        return self._eval_scene_indices

    def window_batch(self, batch_size: int, window: int,
                     step: int | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (z_seq [w, B, z_num], p_seq [w, B, num_param]).

        With ``step`` given the draw is stateless per (seed, step) — the
        exact-resume contract (see :func:`step_rng`); without it the
        instance Generator stream is used (ad hoc sampling)."""
        min_t = min(z.shape[0] for z in self.z)
        if window > min_t:
            raise ValueError(
                f"window {window} exceeds shortest code sequence ({min_t} "
                f"frames); lower --w_num or regenerate codes")
        rng = self.rng if step is None else step_rng(self.seed, step)
        zs, ps = [], []
        for _ in range(batch_size):
            s = int(self.train_scene_indices[
                rng.integers(0, self.num_train_scenes)])
            t_max = self.z[s].shape[0] - window  # >= 0 (guarded above)
            t0 = int(rng.integers(0, t_max + 1))  # inclusive last start
            zs.append(self.z[s][t0:t0 + window])
            ps.append(self.p[s][t0:t0 + window])
        return np.stack(zs, axis=1), np.stack(ps, axis=1)
