"""CLI entry: ``python -m deepfluids_tpu_torch.main --flags...``.

Counterpart of :mod:`deepfluids_tpu.main` with the same flag set
(:mod:`deepfluids_tpu_torch.config`):

    # train (a fresh run dir <log_dir>/<dataset>_<tag>; --load_path <run>
    # resumes it from its latest checkpoint), up to --max_step
    python -m deepfluids_tpu_torch.main --arch de \\
        --dataset smoke_pos21_size5 --batch_size 8

    # serve: sweep the parameter grid into <run>/test/
    python -m deepfluids_tpu_torch.main --arch de --is_train False \\
        --load_path <run>

    # config #3 (liquid: levelset fields, no curl), x-mirror augmentation,
    # and the generator's knobs (any subset)
    python -m deepfluids_tpu_torch.main --dataset liquid_pos10_size4 \\
        --data_type levelset --augment_flip_x true
    python -m deepfluids_tpu_torch.main --dataset smoke_pos21_size5 \\
        --decoder grid --embed_bands 8 --spectral_modes 8

    # config #4: train the autoencoder, encode the dataset into
    # <dataset>/code<z_num><suffix>/, train the latent integrator on the
    # codes, then roll it out through the AE's decoder into
    # <nn run>/test/rollout.{npz,gif}
    python -m deepfluids_tpu_torch.main --arch ae --dataset smoke_mov200_f400
    python -m deepfluids_tpu_torch.main --arch ae --is_train False \\
        --load_path <ae run>
    python -m deepfluids_tpu_torch.main --arch nn --dataset smoke_mov200_f400
    python -m deepfluids_tpu_torch.main --arch nn --is_train False \\
        --load_path <nn run> --ae_load_path <ae run>

    # several ranks (one process each): torchrun, or the port's launcher
    torchrun --nproc_per_node 2 -m deepfluids_tpu_torch.main \\
        --dataset smoke_pos21_size5 --num_data_shards 2
    python -m deepfluids_tpu_torch.tools.launch_multihost \\
        --num_processes 2 -- python -m deepfluids_tpu_torch.main \\
        --dataset smoke_pos21_size5 --spatial_shard true

Under ``WORLD_SIZE`` (torchrun's variables) :func:`main` joins the process
group first (:func:`..parallel.init_distributed`): each rank trains its
part of the layout (``--num_data_shards``, ``--num_model_shards``,
``--spatial_shard``) and rank 0 writes the run; a test invocation serves
from rank 0 alone.

A test invocation rebuilds the run's model from its ``params.json``
(the AE of an "nn" rollout from ``--ae_load_path``'s) and loads
``<run>/weights.npz``, which training writes at every checkpoint.  All of
it runs on the current CUDA device, and raises when there is none, unless
``--device cpu`` (``device="cpu"`` to :func:`main`) is given, as the tests
do and as a supervisor's child on a machine without a card must.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from deepfluids_tpu_torch import parallel
from deepfluids_tpu_torch.config import (
    Config,
    get_config,
    merge_test_config,
)
from deepfluids_tpu_torch.infer import (
    encode_dataset,
    rollout_trajectory,
    run_test_sweep,
    score_rollout_vs_sim,
)
from deepfluids_tpu_torch.train.trainer import Trainer
from deepfluids_tpu_torch.utils.images import save_gif
from deepfluids_tpu_torch.utils.rundir import get_logger

log = get_logger()


def main(config: Config, device: str | torch.device | None = None) -> dict:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "deepfluids_tpu_torch runs on a CUDA card and found none "
                "(torch.cuda.is_available() is False); pass device='cpu' "
                "to run the plain PyTorch path on the CPU")
        device = "cuda"
    device = parallel.init_distributed(device)
    rank, world = parallel.world()
    np.random.seed(config.seed)
    torch.manual_seed(config.seed)
    if config.is_train:
        trainer = Trainer(config, device=device)
        # --load_path on a train run restores the latest checkpoint and
        # continues toward --max_step.
        done = trainer.maybe_resume() if config.load_path else 0
        if done:
            log.info("resuming %s from step %d", trainer.run_dir, done)
        if done >= config.max_step:
            log.info("already at max_step %d; nothing to do",
                     config.max_step)
            return {"step": done}
        result = trainer.train(num_steps=config.max_step - done)
        log.info("training done: %s", result)
        return result
    if not config.load_path:
        raise SystemExit("--is_train=false needs --load_path "
                         "(a trained run directory)")
    if rank:
        log.info("serving runs on rank 0 of %d; rank %d has nothing to do",
                 world, rank)
        return {}
    # Rebuild the TRAINED architecture from the run's own params.json;
    # explicit CLI flags still override.
    config = merge_test_config(config, config.load_path)
    if config.arch == "nn" and not config.ae_load_path:
        raise SystemExit("arch 'nn' test needs --ae_load_path "
                         "(the trained autoencoder's run dir)")
    trainer = Trainer(config, run_dir=config.load_path, device=device,
                      save_cfg=False)
    log.info("loaded %s on %s", trainer.restore_weights(), device)
    out_dir = os.path.join(trainer.run_dir, "test")
    if config.arch == "ae":
        code_dir = encode_dataset(trainer.encode, config.dataset_dir,
                                  config.z_num,
                                  batch_size=config.test_batch_size,
                                  suffix=config.code_suffix)
        log.info("encoded dataset -> %s", code_dir)
        return {"code_dir": code_dir}
    if config.arch == "nn":
        return _rollout(trainer, config, out_dir, device)
    # Sweep grid: --test_counts, else the dataset's own generation grid,
    # else 5 per axis.
    if config.test_counts:
        counts = [int(s) for s in config.test_counts.split(",")]
    elif trainer.manifest.param_counts:
        counts = list(trainer.manifest.param_counts)
    else:
        counts = [5] * (trainer.manifest.num_param - 1)
    result = run_test_sweep(
        trainer.apply, trainer.manifest, out_dir, counts=counts,
        num_frames=config.test_frames or None,
        batch_size=config.test_batch_size, save_png_every=20,
        device=device)
    result["eval"] = trainer.evaluate(num_samples=128)
    log.info("sweep done: %s", result)
    return result


def _rollout(trainer: Trainer, config: Config, out_dir: str,
             device: torch.device) -> dict:
    """Arch "nn" test: roll the first scene's code out for --test_frames
    frames (default: the whole scene) through the AE's decoder, write
    ``rollout.npz`` / ``rollout.gif`` and score the fields against the
    simulated frames."""
    # The AE from its own params.json (its widths may differ from this
    # invocation's flags) and its weights.npz.
    ae = trainer._ae_trainer()
    codes = trainer.codes
    z_seq = codes.z[0]                                       # [T, z_num]
    p_raw = codes.manifest.denormalize_params(codes.p[0])    # [T, P] raw
    t = config.test_frames or z_seq.shape[0]
    # History H > 1 seeds the rollout with the first H encoded codes.
    h = trainer.c.nn_history
    z_start = z_seq[:h][:, None] if h > 1 else z_seq[:1]
    z_traj, fields = rollout_trajectory(
        trainer.model, ae.apply_decode, z_start, p_raw[:t],
        trainer.manifest, decode_batch=config.test_batch_size,
        device=device)
    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(os.path.join(out_dir, "rollout.npz"), z=z_traj,
                        x=fields[:, 0])
    levelset = trainer.manifest.num_channels == 1
    save_gif(os.path.join(out_dir, "rollout.gif"), list(fields[:, 0]),
             "levelset" if levelset else "vorticity")
    log.info("rollout of %d steps -> %s", t, out_dir)
    result = {"rollout_steps": int(t), "out_dir": out_dir}
    try:
        result["rollout_field_l2"] = score_rollout_vs_sim(
            fields[:, 0], config.dataset_dir, codes.scenes[0],
            field_key="l" if trainer.manifest.data_type == "levelset"
            else "v")
        log.info("rollout drift vs sim: %s", result["rollout_field_l2"])
    except FileNotFoundError:
        pass  # codes without raw frames on disk: latent-only artifacts
    return result


def split_device(argv: list[str]) -> tuple[list[str], str | None]:
    """``argv`` without ``--device <cpu|cuda[:i]>`` (or ``--device=...``),
    and the device it named (None: the card).  The device is where this
    invocation runs, not a property of the run: it is no ``Config`` field
    and ``params.json`` does not hold it."""
    rest, device, i = [], None, 0
    while i < len(argv):
        if argv[i] == "--device":
            if i + 1 >= len(argv):
                raise SystemExit("--device needs a value (cpu, cuda, cuda:0)")
            device, i = argv[i + 1], i + 2
        elif argv[i].startswith("--device="):
            device, i = argv[i].split("=", 1)[1], i + 1
        else:
            rest.append(argv[i])
            i += 1
    return rest, device


def cli(argv: list[str]) -> dict:
    """The command line: every ``Config`` flag, and ``--device``."""
    argv, device = split_device(argv)
    return main(get_config(argv), device=device)


if __name__ == "__main__":
    cli(sys.argv[1:])
