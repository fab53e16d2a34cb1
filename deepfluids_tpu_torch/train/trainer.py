"""The Trainer of the port: training and serving of one run, archs "de",
"ae" and "nn".

Counterpart of :class:`deepfluids_tpu.train.trainer.Trainer`.  It owns the
dataset manifest and the batch source (the port's copies of the JAX
package's ``BatchManager`` for the field archs "de" / "ae", with (t, t+1)
pair batches for ``--ae_pred_w``, and ``CodeDataset`` for the latent
integrator "nn"), builds the arch's model with Flax's init, its Adam
optimizer and cosine schedule (:mod:`.state`) on the CUDA card (or on
``device``), and runs

  * :meth:`train`: the batch stream of ``BatchManager.batches`` (or the
    whole dataset on the device, ``--device_data_cache``, "de" / "ae") or
    of ``CodeDataset.window_batch``, each a pure function of (seed, step),
    or ``--input_pipeline grain``'s epoch-shuffled stream
    (:mod:`..data.grain_loader`, "de" / "ae"), which a resume enters at its
    step without reading the batches before it;
    ``metrics.jsonl`` rows, sample dumps and checkpoints at the JAX
    trainer's steps (each row's ``host_s``: the host seconds of each span
    of :mod:`..spans` since the row before, checkpoints, sample dumps,
    captures and staging waits among them); every run takes chunks of
    ``--steps_per_call`` steps (:mod:`.graph`, the counterpart of JAX's
    compiled step), a CUDA graph replay each on one CUDA card ("de" /
    "ae"), uncaptured elsewhere;
  * :meth:`generate` ("de"), :meth:`reconstruct` / :meth:`encode` /
    :meth:`decode` ("ae") and :meth:`evaluate`: the serving path.

Checkpoints are ``<run>/checkpoint/<step>/state.pt`` (params, Adam state,
step; the 3 newest are kept).  Each save also writes ``<run>/weights.npz``,
the flat ``tools/weights_io`` file that serving reads.  A JAX run's Orbax
checkpoint cannot be read without jax: export its ``weights.npz`` once
(``EXPORT_COMMAND``).

Several ranks (:mod:`..parallel`; ``torchrun`` or
``tools/launch_multihost``): ``--num_data_shards`` splits each batch over
the data group (``--spatial_shard``: the grid's first axis instead, the
batch replicated) and ``--num_model_shards`` the conv channels over the
model group.  Every rank draws the same global (seed, step) batch and
keeps its rows; the augmentation mask and the ``--nn_noise`` stream are
drawn for the global batch.  Rank 0 writes the run's files; a checkpoint
holds the whole model, so it resumes under any layout.
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import time

import numpy as np
import torch

from deepfluids_tpu_torch import spans
from deepfluids_tpu_torch.config import Config, load_config, save_config
from deepfluids_tpu_torch.data import (
    BatchManager,
    CodeDataset,
    grain_loader,
    load_npz_batch,
)
from deepfluids_tpu_torch.data.dataset import step_batch_indices_block
from deepfluids_tpu_torch.infer.rollout import padded_chunks
from deepfluids_tpu_torch.infer.score import score_rollout_vs_sim
from deepfluids_tpu_torch.models import (
    Autoencoder,
    GeneratorBE,
    LatentIntegrator,
    flax_init_,
    flax_to_state_dict,
    load_flax_npz,
    noise_generator,
    rollout,
    save_flax_npz,
    state_dict_to_flax,
)
from deepfluids_tpu_torch.parallel import comm, mesh
from deepfluids_tpu_torch.train import augment, graph, losses
from deepfluids_tpu_torch.train.state import (
    clip_by_global_norm_,
    cosine_lr_table,
    load_optimizer_state_,
    lr_rows,
    make_optimizer,
    portable_optimizer_state,
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
ARCHS = ("de", "ae", "nn")


def _check_spatial_flags(c: Config) -> None:
    """``--spatial_shard`` applies to the field archs, as in the JAX
    trainer."""
    if c.spatial_shard and c.arch not in ("de", "ae"):
        raise ValueError("--spatial_shard applies to arch de/ae only")


def _check_arch_flags(c: Config) -> None:
    """The JAX trainer's refusals of flag combinations (its ``__init__``
    checks), with its messages."""
    if c.arch not in ARCHS:
        raise ValueError(f"unknown arch {c.arch!r}")
    if c.augment_flip_x and c.arch == "nn":
        raise ValueError("--augment_flip_x applies to arch de/ae "
                         "(field-space training); the latent integrator "
                         "trains on encoded codes")
    if c.nn_history < 1:
        raise ValueError("--nn_history must be >= 1")
    if c.ae_pred_w > 0:
        if c.arch != "ae":
            raise ValueError("--ae_pred_w trains the autoencoder's "
                             "co-trained latent predictor (arch ae)")
        if c.augment_flip_x:
            raise ValueError("--ae_pred_w with --augment_flip_x is "
                             "unsupported (pair batches)")
        if c.input_pipeline == "grain":
            raise ValueError("--ae_pred_w needs (t, t+1) pair batches; the "
                             "grain pipeline serves single frames")
    if c.arch == "nn" and c.nn_history >= c.w_num:
        raise ValueError(
            f"--nn_history {c.nn_history} must be < --w_num {c.w_num}: the "
            "first H window positions are true seed codes, so the window "
            "needs predicted steps to train on")
    if c.nn_field_w > 0 and not c.ae_load_path:
        raise ValueError("--nn_field_w needs --ae_load_path (the frozen "
                         "decoder to train through)")
    if c.decoder == "grid" and c.arch != "de":
        raise ValueError("--decoder grid applies to arch de (the "
                         "parameterized generator)")
    if c.input_pipeline == "grain":
        if c.arch not in ("de", "ae"):
            raise ValueError("--input_pipeline grain serves field batches "
                             "(arch de/ae only)")
        if c.device_data_cache:
            raise ValueError(
                "--input_pipeline grain streams batches; it cannot feed "
                "--device_data_cache (which gathers on device)")


def _parse_profile_steps(spec: str) -> tuple[int, int] | None:
    """``--profile_steps lo,hi`` as (lo, hi); None when unset."""
    if not spec:
        return None
    try:
        lo, hi = (int(s) for s in spec.split(","))
    except ValueError:
        raise ValueError(f"--profile_steps {spec!r}: expected 'lo,hi' "
                         "(two step numbers)") from None
    return lo, hi


def _host_seconds() -> dict[str, float]:
    """``metrics.jsonl``'s ``host_s``: the host seconds of each span
    (:mod:`..spans`) since the last call, spans that took none left out."""
    seconds = {name: round(ns * 1e-9, 6)
               for name, (_, ns, _) in sorted(spans.take().items())}
    return {name: s for name, s in seconds.items() if s}


def _crossed(period: int, step: int, take: int) -> bool:
    """Whether the last ``take`` steps ending at ``step`` crossed a multiple
    of ``period``."""
    return step // period > (step - take) // period


class Trainer:
    """Owns the model, its optimizer and the dataset of one run."""

    def __init__(self, config: Config, run_dir: str | None = None,
                 device: str | torch.device = "cuda", save_cfg: bool = True,
                 layout: mesh.Layout | None = None):
        _check_arch_flags(config)
        _check_spatial_flags(config)
        self.c = config
        # Serving runs whole on one rank (main serves from rank 0 only).
        self.layout = layout or (mesh.make_layout(
            config.num_data_shards, config.num_model_shards,
            config.spatial_shard) if config.is_train else mesh.Layout())
        self._main = self.layout.rank == 0
        self._check_batch_flags()
        self.run_dir = run_dir or self._shared_run_dir()
        if save_cfg and self._main:
            save_config(config, self.run_dir)
        self.device = torch.device(device)
        self.dtype = _DTYPES[config.compute_dtype]

        if config.arch in ("de", "ae"):
            field_key = "l" if config.data_type == "levelset" else "v"
            self.bm = BatchManager(
                config.dataset_dir, config.batch_size, seed=config.seed,
                cache=config.cache_data, num_workers=config.num_worker,
                field_key=field_key,
                holdout_scenes=config.eval_holdout_scenes,
                holdout_mode=config.holdout_mode, pair=self.pair_mode)
            self.manifest = self.bm.manifest
        else:
            # The same holdout rule as the AE's BatchManager, so one
            # --eval_holdout_scenes partitions the whole pipeline.
            self.codes = CodeDataset(
                config.dataset_dir, config.z_num, seed=config.seed,
                holdout_scenes=config.eval_holdout_scenes,
                suffix=config.code_suffix, holdout_mode=config.holdout_mode)
            self.manifest = self.codes.manifest
        self.num_param = self.manifest.num_param
        self._check_geometry_flags()
        self._flip = self._flip_signs()

        self.model = flax_init_(self._build_model(), config.seed).to(
            self.device)
        if self.layout.rows is not None:
            self.model.shard_rows(self.layout.rows)
        # the whole model's shapes, then the conv weights cut over the
        # model group (their names)
        self._whole_shapes = {k: torch.empty(v.shape, device="meta")
                              for k, v in self.model.state_dict().items()}
        self._cut = mesh.shard_channels_(self.model, self.layout.model)
        self._lr_table = cosine_lr_table(config.lr_max, config.lr_min,
                                         config.max_step)
        # Adam's rate on the device (capturable) where the graph can run
        self._lr = (torch.zeros((), device=self.device)
                    if graph.device_lr(config, self.device, self.layout)
                    else None)
        # whether train() captures the chunk body (a caller may turn it off)
        self.capture, why = graph.should_capture(config, self.device,
                                                 self.layout)
        if config.is_train:
            log.info("train step path: %s (%s)",
                     "graph" if self.capture else "chunk body", why)
        self._chunks: graph.StepGraph | None = None  # the last train()'s
        self.step = 0      # optimizer updates done; drives the schedule
        self._metrics_path = os.path.join(self.run_dir, "metrics.jsonl")
        self._device_cache: tuple[torch.Tensor, torch.Tensor] | None = None
        self._stream = None     # the open --input_pipeline grain stream
        self._dump_rng = np.random.default_rng(config.seed + 7919)
        self._eval_ae: Trainer | None = None
        self._profile_range = _parse_profile_steps(config.profile_steps)
        self._profiler = None   # the open --profile_steps window
        self._tb = None         # --use_tensorboard's writer, opened by train
        if config.nn_field_w > 0:
            # --nn_field_w trains through the frozen AE decoder.
            self._ae_trainer().model.requires_grad_(False)
        log.info("arch=%s params=%.2fM device=%s layout=%s", config.arch,
                 sum(p.numel() for p in self.model.parameters()) / 1e6,
                 self.device, self._layout_name())

    def _layout_name(self) -> str:
        lay = self.layout
        if lay.world == 1:
            return "single"
        what = "spatial" if lay.spatial else "data"
        return (f"rank {lay.rank}/{lay.world}: {what} {lay.data.index}/"
                f"{lay.data.size} x model {lay.model.index}/"
                f"{lay.model.size}")

    def _check_batch_flags(self) -> None:
        """A batch split over the data group must divide by it, as the
        reference's ``shard_batch`` requires; raised before anything is
        written."""
        n = self.layout.batch.size
        if self.c.is_train and self.c.batch_size % n:
            raise ValueError(f"batch dim {self.c.batch_size} not divisible "
                             f"by data-axis size {n}")

    def _shared_run_dir(self) -> str:
        """Rank 0 prepares the run directory and every rank takes its
        path (a second rank would find it made and add a timestamp)."""
        c = self.c
        path = [prepare_run_dir(c.log_dir, c.dataset, c.tag, c.load_path)
                if self._main else None]
        if self.layout.world > 1:
            torch.distributed.broadcast_object_list(path, src=0)
        return path[0]

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
        if c.spatial_shard:
            n, axis = self.layout.data.size, m.resolution[0]
            if axis % n:
                raise ValueError(
                    f"--spatial_shard needs the grid's first axis ({axis}) "
                    f"divisible by the data-axis size ({n})")

    def _flip_signs(self) -> tuple[torch.Tensor, torch.Tensor] | None:
        """``--augment_flip_x``'s (channel, parameter) signs on the device
        (arch "de" / "ae"; "nn" is refused), else None; warns where the
        mirror of a training scene can be a held-out one."""
        c = self.c
        if not c.augment_flip_x:
            return None
        chan, psign = augment.flip_signs(self.manifest)
        if (c.eval_holdout_scenes and self.manifest.param_counts
                and float(psign.min()) < 0):
            # Grid-sampled x-position family: the mirror of a training
            # scene IS the dataset's scene at the reflected position.
            log.warning(
                "--augment_flip_x on a GRID-sampled x-position family "
                "with --eval_holdout_scenes: mirrored training scenes "
                "can coincide with held-out scenes (mirror-twin "
                "leakage); holdout numbers for this run measure "
                "coverage, not generalization")
        return chan.to(self.device), psign.to(self.device)

    @property
    def pair_mode(self) -> bool:
        """(t, t+1) pair batches: ``--ae_pred_w`` on arch "ae"."""
        return self.c.arch == "ae" and self.c.ae_pred_w > 0

    def _potential_channels(self) -> int:
        """psi (1) / Psi (3) under curl, else the field channels."""
        if not self.c.use_curl or self.manifest.num_channels == 1:
            return self.manifest.num_channels
        return 1 if not self.manifest.is_3d else 3

    @property
    def curl_active(self) -> bool:
        return self.c.use_curl and self.manifest.num_channels > 1

    def _build_model(self) -> torch.nn.Module:
        c, m = self.c, self.manifest
        out_shape = tuple(m.resolution) + (self._potential_channels(),)
        if c.arch == "de":
            grid = c.decoder == "grid"
            return GeneratorBE(out_shape, num_param=self.num_param,
                               filters=c.filters, num_conv=c.num_conv,
                               repeat=c.repeat, compute_dtype=self.dtype,
                               embed_bands=c.embed_bands,
                               spectral_modes=c.spectral_modes,
                               grid_levels=c.grid_levels if grid else 0,
                               grid_features=c.grid_features if grid else 0,
                               grid_rank=c.grid_rank if grid else 0)
        # The knobs are the generator's: arch "ae" ignores --embed_bands
        # and --spectral_modes, as the JAX trainer does.
        if c.arch == "ae":
            return Autoencoder(
                out_shape, in_channels=m.num_channels, z_num=c.z_num,
                filters=c.filters, num_conv=c.num_conv, repeat=c.repeat,
                compute_dtype=self.dtype, num_param=self.num_param,
                pred_hidden=c.ae_pred_hidden if c.ae_pred_w > 0 else 0)
        return LatentIntegrator(z_num=c.z_num, num_param=self.num_param,
                                hidden=c.nn_hidden, depth=c.nn_depth,
                                history=c.nn_history)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    @functools.cached_property
    def opt(self) -> torch.optim.Adam:
        """Adam over the model's parameters, built at first use: serving
        never needs it, and building one imports ``torch._dynamo``, which
        takes seconds."""
        return make_optimizer(self.model.parameters(), self.c.beta1,
                              self.c.beta2, lr=self._lr)

    def _loss_fn(self, model: torch.nn.Module, a: torch.Tensor,
                 b: torch.Tensor, step: int = 0) -> tuple[torch.Tensor, dict]:
        """``(loss, aux)`` of ``model`` on one batch, as JAX's ``_loss_fn``:
        fields ``a`` and normalized params ``b`` ("de", "ae"), or a code
        window ``a`` ``[W, B, z_num]`` and its parameters ``b`` ``[W, B,
        P]`` ("nn", whose ``--nn_noise`` stream is drawn for ``step``, the
        updates done before this one)."""
        c, rows = self.c, self.layout.rows
        if c.arch == "de":
            if rows is not None:
                loss, aux = losses.generator_loss_spatial(
                    model(b), a, self.curl_active, c.w1, c.w2, rows,
                    c.relative_loss, c.loss_norm)
            else:
                loss, aux = losses.generator_loss(
                    model(b), a, self.curl_active, c.w1, c.w2,
                    c.relative_loss, c.loss_norm, self.layout.batch)
            del aux["pred"]
            return loss, aux
        if c.arch == "ae":
            return self._ae_loss(model, a, b)
        return self._nn_loss(model, a, b, step)

    def _ae_loss(self, model: torch.nn.Module, x: torch.Tensor,
                 y: torch.Tensor) -> tuple[torch.Tensor, dict]:
        c, n, rows = self.c, self.num_param, self.layout.rows
        out, z = model(x)
        if rows is not None:
            loss, aux = losses.autoencoder_loss_spatial(
                out, z, x, y, self.curl_active, n, c.w1, c.w2, c.w3, rows,
                c.relative_loss, c.loss_norm)
        else:
            loss, aux = losses.autoencoder_loss(
                out, z, x, y, self.curl_active, n, c.w1, c.w2, c.w3,
                c.relative_loss, c.loss_norm, self.layout.batch)
        del aux["pred"]
        if c.ae_pred_w > 0:
            # A pair batch [x_t ; x_{t+1}]: the predictor's one-step error
            # reaches the encoder through both halves' codes.
            if z.shape[0] % 2:
                raise ValueError(f"--ae_pred_w needs a [2B] pair batch, got "
                                 f"{z.shape[0]} rows")
            nb = z.shape[0] // 2
            zt, zt1, pt, pt1 = z[:nb], z[nb:], y[:nb], y[nb:]
            # The parameter block is pinned to the true trajectory.
            z_in = torch.cat([pt, zt[:, n:]], dim=-1)
            dz = model.predict(z_in, pt1 - pt)
            pl = torch.mean(torch.square(zt[:, n:] + dz - zt1[:, n:]))
            if rows is not None:
                pl = pl / rows.size       # the codes are whole on each rank
            loss = loss + c.ae_pred_w * pl
            aux["loss_pred"] = pl
        return loss, aux

    def _nn_loss(self, model: torch.nn.Module, z_seq: torch.Tensor,
                 p_seq: torch.Tensor, step: int) -> tuple[torch.Tensor, dict]:
        c, h, group = self.c, self.c.nn_history, self.layout.batch
        gen = (noise_generator(c.seed, step, z_seq.device)
               if c.nn_noise > 0 else None)
        b = z_seq.shape[1]
        # History H > 1 seeds the rollout with the window's first H codes.
        z_pred = rollout(model, z_seq[:h] if h > 1 else z_seq[0], p_seq,
                         self.num_param, remat=c.remat_rollout,
                         noise_std=c.nn_noise, generator=gen, history=h,
                         noise_rows=(b * group.size, b * group.index))
        loss, aux = losses.latent_window_loss(z_pred, z_seq,
                                              self.num_param)
        if c.nn_field_w > 0:
            # Decode nn_field_frames evenly spaced window positions (the
            # first H are the shared seed codes) through the frozen decoder.
            ae, w = self._ae_trainer(), z_pred.shape[0]
            k = int(min(max(1, c.nn_field_frames), w - h))
            t_idx = np.linspace(h, w - 1, k).astype(int)
            zp = z_pred[t_idx].reshape(-1, z_pred.shape[-1])
            zt = z_seq[t_idx].reshape(-1, z_seq.shape[-1])
            with torch.no_grad():
                target = ae.apply_decode(zt)
            fl, _ = losses.field_loss(ae.apply_decode(zp), target, c.w1,
                                      c.w2, c.relative_loss, c.loss_norm,
                                      group)
            loss = loss + c.nn_field_w * fl
            aux["loss_nnfield"] = fl
        return loss, aux

    def _train_step(self, a: torch.Tensor,
                    b: torch.Tensor) -> dict[str, torch.Tensor]:
        """One update on the device tensors ``(a, b)`` (this rank's part of
        a global batch), uncaptured, at the current step's rate and
        x-mirror mask (:meth:`_step_rows`); the step's losses as device
        tensors.  What the card's tests and ``chip_smoke.py`` time alone."""
        rows = self._step_rows(self.step, 1,
                               a.shape[0] * self.layout.batch.size)
        mask = rows["mask"][0] if "mask" in rows else None
        if mask is not None and a.device.type == "cuda":
            # from pinned memory: a pageable copy would wait for the stream
            mask = mask.pin_memory().to(a.device, non_blocking=True)
        aux = self._update(a, b, mask, float(rows["lr"][0]), self.step)
        self.step += 1
        return aux

    def _block_update(self, step: int, row: dict[str, torch.Tensor],
                      rate: float) -> dict[str, torch.Tensor]:
        """Update ``step`` of a chunk (:meth:`graph.StepGraph._body`) from
        its ``row`` of the static inputs of :meth:`_chunk_blocks`: the
        cache's rows ``idx`` or the batch ``x``, ``y``, the mask, and the
        rate, read from the device where Adam is capturable, else the host
        ``rate`` (no read back from the card)."""
        a, b = (self._cache_batch(row["idx"]) if "idx" in row
                else (row["x"], row["y"]))
        return self._update(a, b, row.get("mask"),
                            row["lr"] if self._lr is not None else rate, step)

    def _update(self, a: torch.Tensor, b: torch.Tensor,
                mask: torch.Tensor | None, lr: float | torch.Tensor,
                step: int) -> dict[str, torch.Tensor]:
        """The device body of update ``step`` (the updates done before
        it), which a CUDA graph captures: the x-mirror of ``mask``'s
        frames, the loss, backward, clipping and an Adam update at rate
        ``lr``; the losses as device tensors.  Leaves ``self.step`` to the
        caller."""
        if mask is not None:
            a, b = augment.flip_x_batch(a, b, mask, *self._flip)
        set_lr(self.opt, lr)
        loss, aux = self._backward(a, b, step)
        if self.c.debug_nans:
            self._raise_if_not_finite(loss, step)
        if self.c.grad_clip > 0:
            norm = (torch.sqrt(mesh.grad_sq_norm(
                self.model, self._cut, self.layout.model))
                if self._cut else None)
            clip_by_global_norm_([p.grad for p in self.model.parameters()],
                                 self.c.grad_clip, norm)
        self.opt.step()
        aux["loss"] = loss
        return {k: v.detach() for k, v in aux.items()}

    def _backward(self, a: torch.Tensor, b: torch.Tensor, step: int
                  ) -> tuple[torch.Tensor, dict]:
        """The rank's loss on its batch (rows) at update ``step``,
        backpropagated; the gradients made the whole step's over the
        layout."""
        self.opt.zero_grad(set_to_none=True)
        loss, aux = self._loss_fn(self.model, a, b, step)
        loss.backward()
        mesh.reduce_grads_(list(self.model.parameters()), self.layout)
        return loss, aux

    def _reported(self, aux: dict[str, torch.Tensor]) -> dict[str, float]:
        """The step's losses as floats, over the data group: the mean of
        the ranks' (data parallel) or the sum of their shares (spatial)."""
        names = list(aux)
        vals = torch.stack([aux[k].float().reshape(()) for k in names])
        if self.layout.data.active:
            comm.all_reduce_(vals, self.layout.data)
            if not self.layout.spatial:
                vals /= self.layout.data.size
        return dict(zip(names, vals.tolist()))

    def local_batch(self, a, b):
        """This rank's part of a global batch ``(a, b)`` (numpy or
        tensors): its rows (data parallel; axis 1 of an "nn" window; each
        half of a pair batch), or its rows of the grid (spatial)."""
        lay = self.layout
        if lay.rows is not None:
            return comm.split_rows(torch.as_tensor(a), lay.rows, 1), b
        axis = 1 if self.c.arch == "nn" else 0
        return (mesh.local_rows(a, lay.batch, axis, self.pair_mode),
                mesh.local_rows(b, lay.batch, axis, self.pair_mode))

    def _loss_and_grads(self, a, b) -> tuple[float, dict[str, np.ndarray]]:
        """The loss of the global batch ``(a, b)`` (fields and normalized
        params, or an "nn" window) at the current weights, and every
        parameter's gradient, whole, by Flax key, as numpy; under any
        layout the one-process numbers.  No update is made.  For the
        layouts' parity checks (the tests, ``chip_smoke.py``)."""
        a, b = self.local_batch(a, b)
        dev = self.device
        a = torch.as_tensor(np.asarray(a)).to(dev)
        b = torch.as_tensor(np.asarray(b)).to(dev)
        loss, aux = self._backward(a, b, self.step)
        grads = {n: p.grad for n, p in self.model.named_parameters()}
        if self._cut:
            grads = mesh.gather_cut(grads, self._cut, self.layout.model)
        self.opt.zero_grad(set_to_none=True)
        return (self._reported({"loss": loss.detach()})["loss"],
                state_dict_to_flax(grads))

    def _raise_if_not_finite(self, loss: torch.Tensor, step: int) -> None:
        """``--debug_nans``: raise at the first step (``step + 1``, the
        update after ``step``) whose loss or gradients hold a NaN or an
        infinity, before the update is applied.  One flag a
        tensor, stacked and read back once: a stream sync every step, which
        is why it stays behind the flag."""
        named = [("loss", loss)] + [
            (f"the gradient of {name}", p.grad)
            for name, p in self.model.named_parameters()
            if p.grad is not None]
        finite = torch.stack([torch.isfinite(t).all() for _, t in named])
        bad = (~finite).nonzero().flatten().tolist()
        if bad:
            raise FloatingPointError(
                f"--debug_nans: step {step + 1}: {named[bad[0]][0]} is "
                f"not finite ({len(bad)} of {len(named)} tensors checked "
                "are not)")

    # -- the operational flags: profiler window, tensorboard, fault -------

    def _profile_window(self, step: int, take: int) -> None:
        """Open ``--profile_steps lo,hi``'s window before the chunk of
        ``take`` steps that ends at ``step`` when it reaches ``lo``; close
        it before the first chunk that ends past ``hi``."""
        if self._profile_range is None:
            return
        lo, hi = self._profile_range
        if self._profiler is None and step >= lo and step - take < hi:
            from torch.profiler import ProfilerActivity, profile

            cuda = self.device.type == "cuda"
            activities = [ProfilerActivity.CPU]
            if cuda:
                activities.append(ProfilerActivity.CUDA)
                # the sentinel's kernel loads before the window opens, so
                # its first launch is not timed in it
                torch.cuda._sleep(1000)
            self._profiler = profile(activities=activities)
            self._profiler.start()
            if cuda:
                # a fresh window can lose its first device record
                torch.cuda._sleep(1000)
        elif self._profiler is not None and step > hi:
            self._stop_profiler()

    def _stop_profiler(self) -> str | None:
        """Close the open window and write what the profiler recorded as a
        Chrome trace under ``--profile_dir`` (default ``<run>/profile/``);
        the trace's path, None when no window was open."""
        prof, self._profiler = self._profiler, None
        if prof is None:
            return None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        pdir = self.c.profile_dir or os.path.join(self.run_dir, "profile")
        os.makedirs(pdir, exist_ok=True)
        lo, hi = self._profile_range
        rank = "" if self._main else f".rank{self.layout.rank}"
        path = os.path.join(pdir, f"steps_{lo}_{hi}{rank}.trace.json")
        prof.export_chrome_trace(path)
        log.info("profiled steps %d..%d -> %s", lo, hi, path)
        return path

    def _open_tensorboard(self) -> None:
        """``--use_tensorboard``: scalars beside metrics.jsonl.  A missing
        dependency logs a warning and training goes on."""
        if (not self.c.use_tensorboard or self._tb is not None
                or not self._main):
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(self.run_dir)
        except Exception as e:  # noqa: BLE001 - optional dependency
            log.warning("torch.utils.tensorboard unavailable: %s", e)

    def _inject_fault(self, step: int) -> None:
        """``--die_at_step``: once ``step`` reaches it, die with exit code 17
        (the code ``tools/supervise`` relaunches on), without a checkpoint
        and without flushing anything; work queued on the card is lost
        with the process.  The sentinel ``<run>/.fault_injected`` makes the
        relaunched run pass the step."""
        c = self.c
        if not c.die_at_step or step < c.die_at_step:
            return
        sentinel = os.path.join(self.run_dir, ".fault_injected")
        if os.path.exists(sentinel):
            return
        if self.layout.world > 1:
            # Every rank has looked before rank 0 writes the sentinel, so
            # all of them die at this step (and a relaunched group passes
            # it); the launcher then exits 17.
            torch.distributed.barrier()
        if self._main:
            open(sentinel, "w").close()
        log.error("fault injection: dying at step %d without checkpointing "
                  "(exit 17)", step)
        os._exit(17)

    def _load_device_cache(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The whole normalized dataset on the device, once: fields in
        ``--cache_dtype``, params in f32, in the dataset's file order;
        under ``--spatial_shard`` the rank's rows of each field."""
        if self._device_cache is not None:
            return self._device_cache
        # first reached in an eager chunk (the warm-up before a capture)
        assert not (self.device.type == "cuda"
                    and torch.cuda.is_current_stream_capturing()), \
            "the device cache is staged under a CUDA graph capture"
        with spans.span("train.stage_cache"):
            c, m = self.c, self.manifest
            files = self.bm.ds.files
            x = load_npz_batch(files, "x", m.field_shape,
                               num_threads=c.num_worker)
            y = load_npz_batch(files, "y", (m.num_param,),
                               num_threads=c.num_worker)
            x = torch.from_numpy(m.normalize_field(x).astype(np.float32))
            y = torch.from_numpy(m.normalize_params(y).astype(np.float32))
            if self.layout.rows is not None:
                x = comm.split_rows(x, self.layout.rows, 1)
            x = x.to(self.device, _CACHE_DTYPES[c.cache_dtype])
            log.info("staged %d fields (%.2f GB, %s) on %s", x.shape[0],
                     x.numel() * x.element_size() / 1e9, x.dtype,
                     self.device)
            self._device_cache = (x, y.to(self.device))
        return self._device_cache

    def _cache_indices(self, step: int, k: int) -> np.ndarray:
        """``[k, B]`` indices into the device cache of global steps ``step
        .. step + k - 1``: draws over the train subset, or, in pair mode,
        over the frames with a same-scene successor, ``[t ; t + 1]`` (``[k,
        2B]``)."""
        c = self.c
        pool = (self.bm.train_pair_indices if self.pair_mode
                else self.bm.train_indices)
        idx = pool[step_batch_indices_block(c.seed, step, k, len(pool),
                                            c.batch_size)]
        if self.pair_mode:
            idx = np.concatenate([idx, self.bm.ds.successor[idx]], axis=1)
        return idx

    def _cache_batch(self, idx: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """The device cache's rows ``idx`` (a device tensor): fields in
        f32, params."""
        cache_x, cache_y = self._load_device_cache()
        return cache_x[idx].float(), cache_y[idx]

    def _host_batches(self, num_steps: int, start: int):
        """The host batches ``(a, b)`` of steps ``start + 1 .. start +
        num_steps``: "nn"'s code windows, ``--input_pipeline grain``'s
        stream (page-locked tensors on the card) or the native one
        (numpy)."""
        c = self.c
        if c.arch == "nn":
            return (self.codes.window_batch(c.batch_size, c.w_num, step=s)
                    for s in range(start + 1, start + num_steps + 1))
        if c.input_pipeline != "grain":
            return self.bm.batches(num_steps, start_step=start)
        # Every rank reads the one global stream (shard 0 of 1) and keeps
        # its rows, as on the native path.
        if start:
            log.info("grain resume: sampler-state skip of %d batches "
                     "(decode-free)", start)
        self._stream = grain_loader.make_grain_loader(
            c.dataset_dir, c.batch_size, seed=c.seed,
            field_key="l" if c.data_type == "levelset" else "v",
            worker_count=min(c.num_worker, 4),
            indices=self.bm.train_indices if c.eval_holdout_scenes
            else None,
            skip_batches=start, pin_memory=self.device.type == "cuda")
        return self._stream

    def _step_rows(self, step: int, k: int, batch: int) -> dict:
        """The rates of updates ``step .. step + k - 1`` (``"lr"``, ``[k]``)
        and, under ``--augment_flip_x``, their x-mirror masks (``"mask"``,
        ``[k, rows]``): this rank's rows of masks drawn for a global batch
        of ``batch`` frames."""
        out = {"lr": lr_rows(self._lr_table, step, k)}
        if self._flip is not None:
            out["mask"] = mesh.local_rows(augment.flip_mask_block(
                self.c.seed, step, k, batch), self.layout.batch, 1)
        return out

    def _chunk_blocks(self, num_steps: int, start: int, k: int):
        """``block(step)`` -> the host inputs of the chunk of ``k`` updates
        after ``step`` updates (:meth:`graph.StepGraph.fill`), this rank's
        rows of each: :meth:`_step_rows`, and the cache's indices
        (``"idx"``) or the next ``k`` host batches (``"x"``, ``"y"``),
        each taken from the stream inside a ``train.next_batch`` span."""
        c, lay = self.c, self.layout
        cache = c.device_data_cache and c.arch != "nn"
        it = None if cache else self._host_batches(num_steps, start)

        def block(step: int) -> dict:
            with spans.span("train.block"):
                out = self._step_rows(step, k, c.batch_size)
                if cache:
                    # a rank gathers its rows (spatial: every index, its
                    # rows of each field are the cache's)
                    out["idx"] = mesh.local_rows(
                        self._cache_indices(step + 1, k).astype(np.int64),
                        lay.batch, 1, self.pair_mode)
                else:
                    rows = []
                    for _ in range(k):
                        with spans.span("train.next_batch"):
                            batch = next(it)
                        rows.append(self.local_batch(*batch))
                    out["x"] = [x for x, _ in rows]
                    out["y"] = [y for _, y in rows]
            return out
        return block

    def _chunk_runner(self, num_steps: int, start: int, k: int):
        """``run(take)`` -> the last losses of the next ``take`` steps
        (``take`` is ``k``): one chunk of the body, captured where
        ``self.capture``."""
        chunks = self._chunks = graph.StepGraph(self, k, self.capture)
        block = self._chunk_blocks(num_steps, start, k)

        def run(take: int) -> dict[str, torch.Tensor]:
            chunks.fill(block(self.step))
            aux = chunks.run()
            self.step += take
            if chunks.replays == 1:
                log.info("captured %d steps as one CUDA graph in %.2f s "
                         "(pool %.1f MB, FD launches a replay %s)", k,
                         chunks.capture_s, chunks.pool_bytes / 2 ** 20,
                         chunks.captured)
            return aux
        return run

    def train(self, num_steps: int | None = None) -> dict:
        """Train ``num_steps`` (default ``--max_step``) more steps; returns
        the last logged losses."""
        c = self.c
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
        last: dict[str, float] = {}
        self._open_tensorboard()
        t0 = time.time()
        seen = 0
        try:
            run = self._chunk_runner(num_steps, start, k)
            with (open(self._metrics_path, "a") if self._main
                  else open(os.devnull, "w")) as mf:
                while seen < num_steps:
                    take = min(k, num_steps - seen)
                    self._profile_window(start + seen + take, take)
                    aux = run(take)
                    seen += take
                    step = start + seen
                    if _crossed(c.log_step, step, take) or seen == num_steps:
                        with spans.span("train.log_sync"):
                            last = self._reported(aux)
                            rate = seen / (time.time() - t0)
                            mf.write(json.dumps({
                                "step": step, "steps_per_sec": round(rate, 3),
                                **last, "host_s": _host_seconds()}) + "\n")
                            mf.flush()
                            if self._tb is not None:
                                for name, v in last.items():
                                    self._tb.add_scalar(name, v, step)
                        log.info("step %d loss %.5f (%.2f it/s)", step,
                                 last["loss"], rate)
                    self._inject_fault(step)
                    if _crossed(c.test_step, step, take):
                        with spans.span("train.sample_dump"):
                            self._dump_samples(step)
                    if _crossed(c.save_step, step, take) or seen == num_steps:
                        self.save_checkpoint()
        finally:
            # A window still open (the run ended inside it, or a step
            # raised) is written as far as it got.
            self._stop_profiler()
            # The grain stream's workers stop with the run; the next
            # train() starts a stream at its own step.
            if self._stream is not None:
                self._stream.close()
                self._stream = None
            if self._tb is not None:
                self._tb.flush()
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

        The data order (and the ``--nn_noise`` stream) is a pure function
        of (seed, step), so params, Adam state and step are the whole
        state: a resumed run replays the uninterrupted one bit for bit."""
        with spans.span("train.checkpoint"):
            path = os.path.join(self.ckpt_dir, str(self.step))
            # the whole model (the cut convs gathered): any layout resumes it
            shard = self.layout.model
            params = mesh.gather_cut(self.model.state_dict(), self._cut,
                                     shard)
            opt_state = portable_optimizer_state(mesh.full_optimizer_state(
                self.opt, self.model, self._cut, shard))
            if not self._main:
                return path
            tmp = path + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save({"params": params, "opt_state": opt_state,
                        "step": self.step}, os.path.join(tmp, CKPT_FILE))
            shutil.rmtree(path, ignore_errors=True)
            os.replace(tmp, path)
            with spans.span("train.weights_npz"):
                save_flax_npz(self.model,
                              os.path.join(self.run_dir, WEIGHTS_FILE),
                              params)
            for old in self.checkpoint_steps()[:-CKPT_KEEP]:
                shutil.rmtree(os.path.join(self.ckpt_dir, str(old)))
            return path

    def restore_checkpoint(self, step: int | None = None) -> int:
        """Restore the latest (or the given) checkpoint; the restored step.
        The betas are this run's flags, as a JAX resume rebuilds them.  The
        optimizer's state tensors are new, so a captured graph is dropped
        (the next ``train`` captures again)."""
        if step is None:
            steps = self.checkpoint_steps()
            if not steps:
                raise FileNotFoundError(f"no checkpoint under "
                                        f"{self.ckpt_dir}")
            step = steps[-1]
        state = torch.load(os.path.join(self.ckpt_dir, str(step), CKPT_FILE),
                           map_location=self.device, weights_only=True)
        shard = self.layout.model
        self.model.load_state_dict(
            mesh.local_state_dict(state["params"], self._cut, shard))
        self._chunks = None
        load_optimizer_state_(self.opt, mesh.local_optimizer_state(
            state["opt_state"], self.opt, self.model, self._cut, shard))
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
        """``sample/<step>.png`` (a sample dump never stops training): "de"
        8 fields along the diagonal of the parameter box; "ae" 4 training
        frames above their reconstructions; "nn" none.  Every rank computes
        them (a sharded model's forward is collective); rank 0 writes."""
        try:
            m = self.manifest
            path = os.path.join(self.run_dir, "sample", f"{step:07d}.png")
            mode = "levelset" if m.num_channels == 1 else "vorticity"
            if self.c.arch == "de":
                n = 8
                p = np.stack([m.normalize_params(
                    [np.interp(i, [0, n - 1], r) for r in m.param_ranges])
                    for i in range(n)])
                fields = self.generate(p)
                if self._main:
                    save_image_grid(path, list(fields), mode=mode)
            elif self.c.arch == "ae":
                # Own RNG stream: the prefetch worker draws training
                # batches concurrently.
                x, _ = self.bm.sample_batch(rng=self._dump_rng)
                x = x[:4]
                rec = self.reconstruct(x)
                if self._main:
                    save_image_grid(path, list(x) + list(rec), ncol=4,
                                    mode=mode)
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
        if self._cut:
            with np.load(path) as d:
                flat = {k: d[k] for k in d.files}
            self.model.load_state_dict(mesh.local_state_dict(
                flax_to_state_dict(flat, self._whole_shapes), self._cut,
                self.layout.model))
        else:
            load_flax_npz(path, self.model)
        return path

    def _field(self, out: torch.Tensor) -> torch.Tensor:
        """The network's output (the rank's rows under ``--spatial_shard``,
        gathered) as a field: its curl when active."""
        if self.layout.rows is not None:
            out = comm.gather_rows(out, self.layout.rows, 1)
        return losses.apply_curl(out) if self.curl_active else out

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """A whole field batch -> the rank's rows under ``--spatial_shard``
        (the encoder's input)."""
        rows = self.layout.rows
        return x if rows is None else comm.split_rows(x, rows, 1)

    def apply(self, p_norm: torch.Tensor) -> torch.Tensor:
        """Arch "de": normalized params ``[B, P]`` -> fields ``[B, *res,
        C]`` on the model's device (curl applied when active)."""
        return self._field(self.model(p_norm))

    def apply_decode(self, z: torch.Tensor) -> torch.Tensor:
        """Arch "ae": codes ``[B, z_num]`` -> fields ``[B, *res, C]`` on the
        model's device (curl applied when active)."""
        return self._field(self.model.decode(z))

    def _numpy_call(self, fn, arr: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.asarray(arr, np.float32)).to(self.device)
        with torch.inference_mode():
            return fn(x).float().cpu().numpy()

    def generate(self, p_norm: np.ndarray) -> np.ndarray:
        """Params ``[B, P]`` (normalized) -> fields (normalized), numpy."""
        return self._numpy_call(self.apply, p_norm)

    def reconstruct(self, x: np.ndarray) -> np.ndarray:
        """Arch "ae": fields -> their reconstructions (normalized), numpy."""
        return self._numpy_call(
            lambda t: self._field(self.model(self._rows(t))[0]), x)

    def encode(self, x: np.ndarray) -> np.ndarray:
        """Arch "ae": fields (normalized) -> codes ``[B, z_num]``, numpy."""
        return self._numpy_call(
            lambda t: self.model.encode(self._rows(t)), x)

    def decode(self, z: np.ndarray) -> np.ndarray:
        """Arch "ae": codes -> fields (normalized), numpy."""
        return self._numpy_call(self.apply_decode, z)

    def _ae_trainer(self) -> Trainer | None:
        """The AE behind ``--ae_load_path`` (built once from its own
        ``params.json``, weights from its ``weights.npz``): the frozen
        decoder of "nn" field-space training and evaluation."""
        if not self.c.ae_load_path:
            return None
        if self._eval_ae is None:
            ae = Trainer(load_config(self.c.ae_load_path),
                         run_dir=self.c.ae_load_path, device=self.device,
                         save_cfg=False, layout=mesh.Layout())
            ae.restore_weights()
            self._eval_ae = ae
        return self._eval_ae

    def _ae_decode_fn(self):
        """Codes -> fields (numpy) through ``--ae_load_path``'s decoder."""
        ae = self._ae_trainer()
        return None if ae is None else ae.decode

    def evaluate(self, num_samples: int = 64, decode_fn=None,
                 profile_scenes: int = 1, pool: str = "auto") -> dict:
        """Model-quality metrics, as the JAX ``Trainer.evaluate``: "de"
        generated vs dataset fields, "ae" reconstructions and the code's
        parameter error, over a uniform frame sample; "nn" the latent
        rollout (:meth:`_evaluate_nn`).  ``pool`` "auto" samples the
        held-out scenes when --eval_holdout_scenes is set, else the whole
        dataset; "train" only the training scenes."""
        if self.c.arch == "nn":
            return self._evaluate_nn(num_samples, decode_fn, profile_scenes,
                                     pool)
        holdout = bool(self.c.eval_holdout_scenes) and pool != "train"
        pool = (self.bm.train_indices if pool == "train"
                else self.bm.eval_indices if holdout
                else np.arange(len(self.bm.ds)))
        n = len(pool)
        idx = pool[np.linspace(0, n - 1, min(num_samples, n)).astype(int)]
        xs, ys = zip(*[self.bm.ds.get_normalized(int(i)) for i in idx])
        xs = np.stack(xs)
        out = {"num_samples": int(len(idx)), "holdout": holdout}
        bs = max(1, self.c.test_batch_size)
        if self.c.arch == "de":
            gen = padded_chunks(self.generate, np.stack(ys), bs)
        else:
            gen = padded_chunks(self.reconstruct, xs, bs)
            z = padded_chunks(self.encode, xs, bs)
            p = np.stack(ys)[:, :self.num_param]
            out["param_mse"] = float(
                np.mean((z[:, :self.num_param] - p) ** 2))
        l2s = np.array([normalized_l2(g, x) for g, x in zip(gen, xs)])
        out.update({"l2_mean": float(l2s.mean()),
                    "l2_median": float(np.median(l2s)),
                    "l2_max": float(l2s.max()),
                    "rmse": float(np.sqrt(np.mean((gen - xs) ** 2)))})
        keys = self.bm.ds.scene_keys
        by_scene: dict[str, list[float]] = {}
        for i, l2 in zip(idx, l2s):
            by_scene.setdefault(keys[int(i)], []).append(float(l2))
        out["per_scene_l2_median"] = {
            k: round(float(np.median(v)), 4)
            for k, v in sorted(by_scene.items())}
        return out

    def _evaluate_nn(self, num_samples: int, decode_fn=None,
                     profile_scenes: int = 1, pool: str = "auto") -> dict:
        """Latent-rollout fidelity: each sampled scene's code advanced from
        its start over the whole (shortest common) trajectory against the
        encoded truth; with a decoder (``decode_fn`` or --ae_load_path)
        also the decoded fields' rmse and the ``rollout_field_l2`` drift
        profile against the simulated frames, beside the AE's own floor
        (the true codes decoded)."""
        holdout = bool(self.c.eval_holdout_scenes) and pool != "train"
        pool = (self.codes.train_scene_indices if pool == "train"
                else self.codes.eval_scene_indices if holdout
                else np.arange(self.codes.num_scenes))
        idx = pool[np.linspace(0, len(pool) - 1,
                               min(num_samples, len(pool))).astype(int)]
        t_min = min(self.codes.z[i].shape[0] for i in idx)
        z_true = np.stack([self.codes.z[i][:t_min] for i in idx], 1)
        p_seq = np.stack([self.codes.p[i][:t_min] for i in idx], 1)
        h = self.c.nn_history
        z0 = z_true[:h] if h > 1 else z_true[0]
        with torch.inference_mode():
            traj = rollout(self.model, torch.from_numpy(z0).to(self.device),
                           torch.from_numpy(p_seq).to(self.device),
                           self.num_param, history=h).cpu().numpy()
        err = np.abs(traj - z_true)
        out = {"num_samples": int(len(idx)), "holdout": holdout,
               "z_mae": float(err.mean()),
               "z_mae_final": float(err[-1].mean()),
               "rollout_steps": int(traj.shape[0])}
        decode_fn = decode_fn or self._ae_decode_fn()
        if decode_fn is None:
            return out
        t_idx = np.linspace(0, traj.shape[0] - 1, 8).astype(int)
        f_pred = decode_fn(traj[t_idx].reshape(-1, traj.shape[-1]))
        f_true = decode_fn(z_true[t_idx].reshape(-1, traj.shape[-1]))
        out["field_rmse"] = float(np.sqrt(np.mean((f_pred - f_true) ** 2)))
        fk = "l" if self.manifest.data_type == "levelset" else "v"
        bs = max(1, self.c.test_batch_size)

        def decode_profile(zs: np.ndarray, scene: str) -> dict:
            dec = padded_chunks(decode_fn, zs, bs)
            return score_rollout_vs_sim(self.manifest.denormalize_field(dec),
                                        self.c.dataset_dir, scene,
                                        field_key=fk)

        profs, floors = [], []
        for k in range(min(max(1, profile_scenes), len(idx))):
            scene = self.codes.scenes[int(idx[k])]
            try:
                prof = decode_profile(traj[:, k], scene)
                floor = decode_profile(z_true[:, k], scene)
            except FileNotFoundError:
                continue  # a scene without raw frames: latent numbers only
            profs.append(prof)
            floors.append(floor)
        if profs:
            out["rollout_field_l2"] = profs[0]
            out["ae_floor_field_l2"] = floors[0]
            if len(profs) > 1:
                out["rollout_field_l2_scenes"] = profs
                out["ae_floor_field_l2_scenes"] = floors

                def agg(ps: list[dict], key: str) -> float:
                    return float(np.median([p[key] for p in ps]))
                out["rollout_field_l2_agg"] = {
                    "num_scenes": len(profs),
                    **{key: agg(profs, key) for key in (
                        "l2_median", "l2_firstq_median", "l2_lastq_median")},
                    **{f"floor_{key}": agg(floors, key) for key in (
                        "l2_median", "l2_firstq_median",
                        "l2_lastq_median")}}
        return out
