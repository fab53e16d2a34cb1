"""Serving subset of the JAX ``Trainer`` for arch "de".

Counterpart of :class:`deepfluids_tpu.train.trainer.Trainer`: it owns the
dataset manifest and ``BatchManager`` (reused from the JAX package, which
needs only numpy), builds the generator, loads its weights, and runs
``generate`` / ``evaluate``.  It builds no optimizer: training is ROADMAP
Queue A item 5.

Weights come from ``<run_dir>/weights.npz``, the flat
``tools/weights_io`` format, because the JAX run's Orbax checkpoint cannot
be read without jax.  A missing file raises; there is no random init.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from deepfluids_tpu_torch.config import Config
from deepfluids_tpu_torch.data import BatchManager
from deepfluids_tpu_torch.models import GeneratorBE, load_flax_npz
from deepfluids_tpu_torch.train.losses import apply_curl
from deepfluids_tpu_torch.utils.parity import normalized_l2

WEIGHTS_FILE = "weights.npz"

# One line that exports a JAX run's checkpoint to <run>/weights.npz.
EXPORT_COMMAND = (
    "python -c \"import sys; sys.path.insert(0, 'tools'); import weights_io; "
    "from deepfluids_tpu.config import load_config; "
    "from deepfluids_tpu.train.trainer import Trainer; r = '{run}'; "
    "t = Trainer(load_config(r), run_dir=r, save_cfg=False); "
    "t.restore_checkpoint(); "
    "weights_io.export_npz(t.state.params, r + '/weights.npz')\"")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_NOT_PORTED = {
    "ae": "arch 'ae' (autoencoder) is ROADMAP Queue A item 7",
    "nn": "arch 'nn' (latent integrator) is ROADMAP Queue A item 8",
}


def _check_unported_knobs(c: Config) -> None:
    """The JAX model's beyond-reference options are not ported: raise
    rather than serve the plain trunk in their place."""
    if c.embed_bands or c.spectral_modes or c.decoder != "be":
        raise NotImplementedError(
            "--embed_bands / --spectral_modes / --decoder grid are not "
            "ported yet (ROADMAP Queue A item 10)")
    if c.spatial_shard:
        raise NotImplementedError(
            "--spatial_shard (spatial sharding) is not ported yet "
            "(ROADMAP Queue A item 11)")


class Trainer:
    """Owns the generator, its weights and the dataset of one run."""

    def __init__(self, config: Config, run_dir: str | None = None,
                 device: str | torch.device = "cpu"):
        if config.arch != "de":
            raise NotImplementedError(
                _NOT_PORTED.get(config.arch, f"unknown arch {config.arch!r}"))
        _check_unported_knobs(config)
        self.c = config
        self.run_dir = run_dir or config.load_path
        if not self.run_dir:
            raise ValueError("Trainer needs a run directory (--load_path)")
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
        self.model = self._build_model().to(self.device)
        self.model.requires_grad_(False).eval()

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
        return apply_curl(out) if self.curl_active else out

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
