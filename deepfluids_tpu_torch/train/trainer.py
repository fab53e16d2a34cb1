"""The Trainer of the port for arch "de": training and serving of one run.

Counterpart of :class:`deepfluids_tpu.train.trainer.Trainer` for arch
"de".  It owns the dataset manifest and ``BatchManager`` (reused from the
JAX package, which needs only numpy), builds the generator with Flax's
init, its Adam optimizer and cosine schedule (:mod:`.state`), and runs

  * :meth:`train`: the batch stream of ``BatchManager.batches`` (or the
    whole dataset on the device, ``--device_data_cache``), both a pure
    function of (seed, step); ``metrics.jsonl`` rows, sample dumps and
    checkpoints at the JAX trainer's steps;
  * :meth:`generate` / :meth:`evaluate`: the serving path.

Checkpoints are ``<run>/checkpoint/<step>/state.pt`` (params, Adam state,
step; the 3 newest are kept).  Each save also writes ``<run>/weights.npz``,
the flat ``tools/weights_io`` file that serving reads.  A JAX run's Orbax
checkpoint cannot be read without jax: export its ``weights.npz`` once
(``EXPORT_COMMAND``).
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import time

import numpy as np
import torch

from deepfluids_tpu_torch.config import Config, save_config
from deepfluids_tpu_torch.data import (
    BatchManager,
    load_npz_batch,
    step_batch_indices,
)
from deepfluids_tpu_torch.models import (
    GeneratorBE,
    flax_init_,
    load_flax_npz,
    save_flax_npz,
)
from deepfluids_tpu_torch.train import losses
from deepfluids_tpu_torch.train.state import (
    clip_by_global_norm_,
    cosine_lr_schedule,
    make_optimizer,
    set_lr,
)
from deepfluids_tpu_torch.utils.images import save_image_grid
from deepfluids_tpu_torch.utils.parity import normalized_l2
from deepfluids_tpu_torch.utils.rundir import get_logger, prepare_run_dir

log = get_logger()

WEIGHTS_FILE = "weights.npz"
CKPT_FILE = "state.pt"
CKPT_KEEP = 3

# One line that exports a JAX run's checkpoint to <run>/weights.npz.
EXPORT_COMMAND = (
    "python -c \"import sys; sys.path.insert(0, 'tools'); import weights_io; "
    "from deepfluids_tpu.config import load_config; "
    "from deepfluids_tpu.train.trainer import Trainer; r = '{run}'; "
    "t = Trainer(load_config(r), run_dir=r, save_cfg=False); "
    "t.restore_checkpoint(); "
    "weights_io.export_npz(t.state.params, r + '/weights.npz')\"")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_CACHE_DTYPES = {"float32": torch.float32, "float16": torch.float16}

_NOT_PORTED = {
    "ae": "arch 'ae' (autoencoder) is ROADMAP Queue A item 7",
    "nn": "arch 'nn' (latent integrator) is ROADMAP Queue A item 8",
}


def _check_unported_knobs(c: Config) -> None:
    """The JAX model's beyond-reference options are not ported: raise
    rather than run the plain trunk in their place."""
    if c.embed_bands or c.spectral_modes or c.decoder != "be":
        raise NotImplementedError(
            "--embed_bands / --spectral_modes / --decoder grid are not "
            "ported yet (ROADMAP Queue A item 10)")
    if c.spatial_shard:
        raise NotImplementedError(
            "--spatial_shard (spatial sharding) is not ported yet "
            "(ROADMAP Queue A item 11)")


def _check_unported_train_flags(c: Config) -> None:
    """Training flags this port does not cover yet raise, naming their
    ROADMAP item.  (--watchdog_secs and --backend_probe_secs guard the TPU
    runtime and are ignored: ROADMAP "Not to port".)"""
    refused = [
        (c.augment_flip_x, "--augment_flip_x is ROADMAP Queue A item 9"),
        (c.input_pipeline == "grain",
         "--input_pipeline grain is ROADMAP Queue A item 11"),
        (c.num_model_shards > 1 or c.num_data_shards > 1,
         "--num_model_shards / --num_data_shards > 1 are ROADMAP Queue A "
         "item 11"),
        (c.profile_steps, "--profile_steps is ROADMAP Queue A item 13"),
        (c.use_tensorboard, "--use_tensorboard is ROADMAP Queue A item 13"),
        (c.debug_nans, "--debug_nans is ROADMAP Queue A item 13"),
        (c.die_at_step, "--die_at_step (fault injection for "
         "tools/supervise.py) is ROADMAP Queue A item 13"),
    ]
    for bad, what in refused:
        if bad:
            raise NotImplementedError(f"{what}; not ported yet")


def _crossed(period: int, step: int, take: int) -> bool:
    """Whether the last ``take`` steps ending at ``step`` crossed a multiple
    of ``period``."""
    return step // period > (step - take) // period


class Trainer:
    """Owns the generator, its optimizer and the dataset of one run."""

    def __init__(self, config: Config, run_dir: str | None = None,
                 device: str | torch.device = "cpu", save_cfg: bool = True):
        if config.arch != "de":
            raise NotImplementedError(
                _NOT_PORTED.get(config.arch, f"unknown arch {config.arch!r}"))
        _check_unported_knobs(config)
        if config.is_train:
            _check_unported_train_flags(config)
        self.c = config
        self.run_dir = run_dir or prepare_run_dir(
            config.log_dir, config.dataset, config.tag, config.load_path)
        if save_cfg:
            save_config(config, self.run_dir)
        self.device = torch.device(device)
        self.dtype = _DTYPES[config.compute_dtype]

        field_key = "l" if config.data_type == "levelset" else "v"
        self.bm = BatchManager(
            config.dataset_dir, config.batch_size, seed=config.seed,
            cache=config.cache_data, num_workers=config.num_worker,
            field_key=field_key, holdout_scenes=config.eval_holdout_scenes,
            holdout_mode=config.holdout_mode)
        self.manifest = self.bm.manifest
        self.num_param = self.manifest.num_param
        self._check_geometry_flags()

        self.model = flax_init_(self._build_model(), config.seed).to(
            self.device)
        self.lr_fn = cosine_lr_schedule(config.lr_max, config.lr_min,
                                        config.max_step)
        self.step = 0      # optimizer updates done; drives the schedule
        self._metrics_path = os.path.join(self.run_dir, "metrics.jsonl")
        self._device_cache: tuple[torch.Tensor, torch.Tensor] | None = None
        log.info("arch=de params=%.2fM device=%s", sum(
            p.numel() for p in self.model.parameters()) / 1e6, self.device)

    def _check_geometry_flags(self) -> None:
        """--res_x/y/z and --is_3d must agree with the dataset's args.txt."""
        c, m = self.c, self.manifest
        if m.is_3d:
            want = {"res_z": m.resolution[0], "res_y": m.resolution[1],
                    "res_x": m.resolution[2]}
        else:
            want = {"res_y": m.resolution[0], "res_x": m.resolution[1]}
        for flag, actual in want.items():
            given = getattr(c, flag)
            if given and given != actual:
                raise ValueError(
                    f"--{flag}={given} but dataset {c.dataset} has "
                    f"{flag}={actual} (geometry comes from args.txt)")
        if (c.res_z or c.is_3d) and not m.is_3d:
            raise ValueError(f"--is_3d/--res_z given but {c.dataset} is 2D")

    def _potential_channels(self) -> int:
        """psi (1) / Psi (3) under curl, else the field channels."""
        if not self.c.use_curl or self.manifest.num_channels == 1:
            return self.manifest.num_channels
        return 1 if not self.manifest.is_3d else 3

    @property
    def curl_active(self) -> bool:
        return self.c.use_curl and self.manifest.num_channels > 1

    def _build_model(self) -> GeneratorBE:
        c = self.c
        return GeneratorBE(
            output_shape=tuple(self.manifest.resolution)
            + (self._potential_channels(),),
            num_param=self.num_param, filters=c.filters,
            num_conv=c.num_conv, repeat=c.repeat, compute_dtype=self.dtype)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    @functools.cached_property
    def opt(self) -> torch.optim.Adam:
        """Adam over the model's parameters, built at first use: serving
        never needs it, and building one imports ``torch._dynamo``, which
        takes seconds."""
        return make_optimizer(self.model.parameters(), self.c.beta1,
                              self.c.beta2)

    def _loss_fn(self, model: torch.nn.Module, x: torch.Tensor,
                 y: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """``(loss, {"loss_field", "loss_jac"})`` of ``model`` on the batch
        (fields ``x``, normalized params ``y``), as JAX's ``_loss_fn``."""
        c = self.c
        loss, aux = losses.generator_loss(
            model(y), x, self.curl_active, c.w1, c.w2, c.relative_loss,
            c.loss_norm)
        del aux["pred"]
        return loss, aux

    def _train_step(self, x: torch.Tensor,
                    y: torch.Tensor) -> dict[str, torch.Tensor]:
        """One Adam update at lr(updates done so far); the step's losses as
        device tensors."""
        set_lr(self.opt, self.lr_fn(self.step))
        self.opt.zero_grad(set_to_none=True)
        loss, aux = self._loss_fn(self.model, x, y)
        loss.backward()
        if self.c.grad_clip > 0:
            clip_by_global_norm_([p.grad for p in self.model.parameters()],
                                 self.c.grad_clip)
        self.opt.step()
        self.step += 1
        aux["loss"] = loss
        return {k: v.detach() for k, v in aux.items()}

    def _load_device_cache(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The whole normalized dataset on the device, once: fields in
        ``--cache_dtype``, params in f32, in the dataset's file order."""
        if self._device_cache is None:
            c, m = self.c, self.manifest
            files = self.bm.ds.files
            x = load_npz_batch(files, "x", m.field_shape,
                               num_threads=c.num_worker)
            y = load_npz_batch(files, "y", (m.num_param,),
                               num_threads=c.num_worker)
            x = torch.from_numpy(m.normalize_field(x).astype(np.float32))
            y = torch.from_numpy(m.normalize_params(y).astype(np.float32))
            x = x.to(self.device, _CACHE_DTYPES[c.cache_dtype])
            log.info("staged %d fields (%.2f GB, %s) on %s", x.shape[0],
                     x.numel() * x.element_size() / 1e9, x.dtype,
                     self.device)
            self._device_cache = (x, y.to(self.device))
        return self._device_cache

    def train(self, num_steps: int | None = None) -> dict:
        """Train ``num_steps`` (default ``--max_step``) more steps; returns
        the last logged losses."""
        c = self.c
        _check_unported_train_flags(c)
        num_steps = c.max_step if num_steps is None else num_steps
        k = max(1, c.steps_per_call)
        if k > 1 and num_steps % k:
            # Step counts as the JAX trainer's, whose chunks of k fused
            # steps round up (the schedule clamps past max_step).
            rounded = -(-num_steps // k) * k
            log.info("rounding num_steps %d -> %d (multiple of "
                     "steps_per_call=%d)", num_steps, rounded, k)
            num_steps = rounded
        start = self.step
        if c.device_data_cache:
            cache_x, cache_y = self._load_device_cache()
            pool = self.bm.train_indices

            def batch(step: int) -> tuple[torch.Tensor, torch.Tensor]:
                idx = torch.from_numpy(pool[step_batch_indices(
                    c.seed, step, len(pool), c.batch_size)]).to(self.device)
                return cache_x[idx].float(), cache_y[idx]
        else:
            it = self.bm.batches(num_steps, start_step=start)

            def batch(step: int) -> tuple[torch.Tensor, torch.Tensor]:
                x, y = next(it)
                return (torch.from_numpy(x).to(self.device),
                        torch.from_numpy(y).to(self.device))

        last: dict[str, float] = {}
        t0 = time.time()
        seen = 0
        with open(self._metrics_path, "a") as mf:
            while seen < num_steps:
                take = min(k, num_steps - seen)
                for _ in range(take):
                    aux = self._train_step(*batch(self.step + 1))
                seen += take
                step = start + seen
                if _crossed(c.log_step, step, take) or seen == num_steps:
                    last = {name: float(v) for name, v in aux.items()}
                    rate = seen / (time.time() - t0)
                    mf.write(json.dumps({"step": step,
                                         "steps_per_sec": round(rate, 3),
                                         **last}) + "\n")
                    mf.flush()
                    log.info("step %d loss %.5f (%.2f it/s)", step,
                             last["loss"], rate)
                if _crossed(c.test_step, step, take):
                    self._dump_samples(step)
                if _crossed(c.save_step, step, take) or seen == num_steps:
                    self.save_checkpoint()
        return last

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    @property
    def ckpt_dir(self) -> str:
        return os.path.abspath(os.path.join(self.run_dir, "checkpoint"))

    def checkpoint_steps(self) -> list[int]:
        """Steps with a complete checkpoint, oldest first."""
        if not os.path.isdir(self.ckpt_dir):
            return []
        return sorted(int(n) for n in os.listdir(self.ckpt_dir)
                      if n.isdigit() and os.path.exists(
                          os.path.join(self.ckpt_dir, n, CKPT_FILE)))

    def save_checkpoint(self) -> str:
        """Write ``checkpoint/<step>/`` (renamed into place whole), update
        ``<run>/weights.npz`` and keep the newest ``CKPT_KEEP``.

        The data order is a pure function of (seed, step), so params, Adam
        state and step are the whole state: a resumed run replays the
        uninterrupted one bit for bit."""
        path = os.path.join(self.ckpt_dir, str(self.step))
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({"params": self.model.state_dict(),
                    "opt_state": self.opt.state_dict(), "step": self.step},
                   os.path.join(tmp, CKPT_FILE))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        save_flax_npz(self.model, os.path.join(self.run_dir, WEIGHTS_FILE))
        for old in self.checkpoint_steps()[:-CKPT_KEEP]:
            shutil.rmtree(os.path.join(self.ckpt_dir, str(old)))
        return path

    def restore_checkpoint(self, step: int | None = None) -> int:
        """Restore the latest (or the given) checkpoint; the restored step.
        The betas are this run's flags, as a JAX resume rebuilds them."""
        if step is None:
            steps = self.checkpoint_steps()
            if not steps:
                raise FileNotFoundError(f"no checkpoint under "
                                        f"{self.ckpt_dir}")
            step = steps[-1]
        state = torch.load(os.path.join(self.ckpt_dir, str(step), CKPT_FILE),
                           map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["params"])
        self.opt.load_state_dict(state["opt_state"])
        for group in self.opt.param_groups:
            group["betas"] = (self.c.beta1, self.c.beta2)
        self.step = int(state["step"])
        return self.step

    def maybe_resume(self) -> int:
        """Resume from the latest checkpoint if there is one; the restored
        step, or 0 when starting fresh."""
        try:
            return self.restore_checkpoint()
        except FileNotFoundError:
            return 0

    def _dump_samples(self, step: int) -> None:
        """``sample/<step>.png``: 8 fields along the diagonal of the
        parameter box (a sample dump never stops training)."""
        try:
            m, n = self.manifest, 8
            p = np.stack([m.normalize_params(
                [np.interp(i, [0, n - 1], r) for r in m.param_ranges])
                for i in range(n)])
            mode = "levelset" if m.num_channels == 1 else "vorticity"
            save_image_grid(
                os.path.join(self.run_dir, "sample", f"{step:07d}.png"),
                list(self.generate(p)), mode=mode)
        except Exception as e:  # noqa: BLE001 - log and keep training
            log.warning("sample dump failed at step %d: %r", step, e)

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------

    def restore_weights(self) -> str:
        """Load ``<run_dir>/weights.npz`` into the model; returns its path."""
        path = os.path.join(self.run_dir, WEIGHTS_FILE)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found: the port reads a run's weights from "
                f"{WEIGHTS_FILE} (the flat tools/weights_io format). Export "
                "it once from the JAX checkpoint, from the repo root:\n  "
                + EXPORT_COMMAND.format(run=self.run_dir))
        load_flax_npz(path, self.model)
        return path

    def apply(self, p_norm: torch.Tensor) -> torch.Tensor:
        """Normalized params ``[B, P]`` -> fields ``[B, *res, C]`` on the
        model's device (curl applied when active)."""
        out = self.model(p_norm)
        return losses.apply_curl(out) if self.curl_active else out

    def generate(self, p_norm: np.ndarray) -> np.ndarray:
        """Params ``[B, P]`` (normalized) -> fields (normalized), numpy."""
        p = torch.from_numpy(np.asarray(p_norm, np.float32)).to(self.device)
        with torch.inference_mode():
            return self.apply(p).float().cpu().numpy()

    def evaluate(self, num_samples: int = 64) -> dict:
        """Generated-vs-dataset field L2 / rmse over a uniform frame sample
        of the held-out scenes when --eval_holdout_scenes is set, else of
        the whole dataset (the de branch of the JAX ``Trainer.evaluate``)."""
        holdout = bool(self.c.eval_holdout_scenes)
        pool = (self.bm.eval_indices if holdout
                else np.arange(len(self.bm.ds)))
        n = len(pool)
        idx = pool[np.linspace(0, n - 1, min(num_samples, n)).astype(int)]
        xs, ys = zip(*[self.bm.ds.get_normalized(int(i)) for i in idx])
        xs = np.stack(xs)
        ys = np.stack(ys)
        # Fixed-size padded chunks of test_batch_size, as the sweep runs.
        bs = max(1, self.c.test_batch_size)
        pad = (-len(ys)) % bs
        padded = (np.concatenate([ys, np.repeat(ys[-1:], pad, 0)]) if pad
                  else ys)
        gen = np.concatenate([self.generate(padded[i:i + bs])
                              for i in range(0, len(padded), bs)])[:len(ys)]
        l2s = np.array([normalized_l2(g, x) for g, x in zip(gen, xs)])
        out = {"num_samples": int(len(idx)), "holdout": holdout,
               "l2_mean": float(l2s.mean()),
               "l2_median": float(np.median(l2s)),
               "l2_max": float(l2s.max()),
               "rmse": float(np.sqrt(np.mean((gen - xs) ** 2)))}
        keys = self.bm.ds.scene_keys
        by_scene: dict[str, list[float]] = {}
        for i, l2 in zip(idx, l2s):
            by_scene.setdefault(keys[int(i)], []).append(float(l2))
        out["per_scene_l2_median"] = {
            k: round(float(np.median(v)), 4)
            for k, v in sorted(by_scene.items())}
        return out
