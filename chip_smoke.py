"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the repo root, one card, no args
    python3 chip_smoke.py readings # what sizes phase 6's K_F64, and the
                                   # cost of the models' activation
    python3 chip_smoke.py side <tree>  # one side of a parent/change
                                   # comparison of the training path
    python3 chip_smoke.py epilogue # phases 1 and 2's epilogue kernels

Drives the port's serving and training paths, 2D (configs #1/#2,
smoke_pos21_size5), 3D (config #5, smoke3_vel5_buo3), config #3's liquid
levelset (liquid_pos10_size4: no curl, so no FD kernel) and the 2D
generator with its knobs (the grid decoder, the Fourier embedding, the
spectral residuals, the x-mirror), and config #4's autoencoder + latent
integrator pipeline (smoke_mov200_f400), through the entry point a user
calls and checks every kernel on the way.  Phases, one line each (or a
few), each followed by its wall time; any failure raises and the script
exits non-zero:

  1. device and build: the card, its power limit, nvcc build of csrc/*.cu;
  2. each of the eight kernels against its plain PyTorch version on the
     card, at the serving and training shapes and odd ones (ragged 2D
     widths and row tiles, 3D bricks, rows of no 16-byte multiple,
     unaligned storage), f32 and bf16 (the four 2D kernels bit-equal in
     f32), jacobian2d_bwd and jacobian3d_bwd also without the vorticity's
     cotangent, plus the fd2d
     and fd3d goldens; the backward kernels refuse extents < 3; gradients
     through ``curl2d_p`` / ``jacobian2d_p`` / ``curl3d_p`` /
     ``jacobian3d_p`` (also with one output unused) against autograd of
     the plain ops; then the conv stack's two epilogue kernels (bias add +
     leaky ReLU, its backward) bit-equal to their plain versions on every
     stage's map of the three benchmark cells and on contiguous maps, the
     forward to aten's ``add_`` + ``F.leaky_relu`` on cuDNN's output, and
     their device times beside their bound, the plain version's and aten's;
  3. the generator goldens, 2D and 3D: Flax-init weights (tests/golden)
     through the port's GeneratorBE and the curl kernels, against JAX;
  4. the serving path at full width, 2D, 3D and liquid:
     ``deepfluids_tpu_torch.main.main`` on a synthetic dataset under the
     published manifest with the flagship GeneratorBE (bf16, seeded random
     weights): 21 x 5 x 20 = 2100 fields of 128x96, 5 x 3 x 8 = 120
     fields of 32x64x112 (8 of the 250 frames, for the time limit) and
     10 x 4 x 20 = 800 levelsets of 128x96; the curl kernel must launch
     once per batch and nothing else (the liquid path: nothing at all);
  6. the training path at full width, 2D, 3D, liquid and the knobs:
     ``main --is_train True`` trains the flagship GeneratorBE (bf16, batch
     8) on a learnable synthetic set (the curl of a Gaussian potential
     blob moved by the parameters; for the liquid, the signed distance to
     a falling drop), resumes from its last checkpoint with
     ``--device_data_cache`` (the liquid also with ``--augment_flip_x``),
     and serves a small grid from the run's weights.npz; the loss must
     fall, sample PNGs must be written and every kernel's launch count
     must be exact per step (zero for the liquid).  Every one of these
     runs (and phase 7's AE runs) must log the CUDA graph path
     (``train/graph.py``: one replay a chunk of --steps_per_call steps,
     the launches counted through capture x replays).  The 2D path also
     trains with ``--input_pipeline grain --num_worker 4`` (a log
     directory of its own) and resumes by the decode-free skip: launches
     exact, every batch pinned before its copy, the metrics steps
     contiguous, and on the host the resumed stream's first batches
     bit-equal to the fresh stream's.  Then one f32 train
     step through the kernels against the same step through the plain ops
     (loss and every parameter's gradient), or, for the liquid, which has
     no kernel, the card's step against the CPU's: with a smooth stand-in
     for the leaky ReLU at the parity gate, and with the leaky ReLU each
     side against the float64 network (the card at most K_F64 times as far
     as the CPU; the card's step with the slope 0.1 must fail that);
  7. config #4 (smoke_mov200_f400) at full width through ``main``: the
     autoencoder (filters 128, num_conv 4, z_num 16, bf16, batch 8) trains
     on a learnable synthetic moving-source set (16 scenes x 64 frames of
     the published 200 x 400) streaming, resumes with
     ``--device_data_cache``, and encodes the set; the latent integrator
     (w_num 30) trains on the codes and resumes; a scene is rolled out and
     decoded through the AE.  Losses must fall, launch counts be exact (an
     AE step's are a "de" step's, the curl once a decoded batch, none in
     the encode pass or the integrator), the rollout's codes and first
     decoded batch equal their recomputation through the plain ops; then
     one f32 AE train step, kernels against plain ops;
  5. timing (printed only): generator + curl throughput (2D batch 512, 3D
     batch 32), the device time of a train step (2D batch 8 and 64, 3D
     batch 8; kernels and plain ops), train steps/s end to end, each kernel
     alone against its plain version and its bound (device time from the
     profiler, inputs cold; the 2D kernels also at [1,128,96], the floor
     of their launch configuration; at the timed batch in f32 also the
     plain version under ``torch.compile``, checked against it and timed
     in the same window), config #4's AE step, encode pass,
     integrator step and a 400-frame rollout, the liquid step (batch 8 and
     64) and serving (batch 512), the knob step against the plain 2D step
     (batch 8 and 64) with the kernels each launches, the x-mirror's cost,
     and profile lines by kernel; and the uncaptured chunk body at
     --steps_per_call 1 against the CUDA graph at --steps_per_call 1, 8
     and 32 from the device cache (2D,
     liquid, knobs at batch 8 and 64, 3D and the AE at 8): wall, host and
     device ms a step, idle share, steps/s, the capture's seconds, the
     graph pool's and the peak's MB;
 14. right after phase 7, the CUDA graph against its body run uncaptured
     from the same seed and batches (2D batch 8 with the x-mirror, 3D
     batch 2, the AE on ``--ae_pred_w`` pair batches; 40 steps at
     --steps_per_call 1 and 8): parameters and Adam's state bit for bit
     (or, said so, within 1e-6 of each one's largest entry), launches
     exact; a 2D graph run checkpointed at 20, trained on, restored there
     (the held graph dropped) and trained to 40 equals 40 uninterrupted
     steps bit for bit;
  13. right after phase 5, the repo root's entry points:
     ``graft_entry.entry()`` on the card, its forward at the entry's own
     ``p`` and at a batch of 512 (finite, one curl launch a call) against the plain curl on the
     stream function it took (f32, and bf16), ``bench.run_device_bench``
     (its launches exact), then the whole ``python -m
     deepfluids_tpu_torch.bench`` in a subprocess: one line with the repo
     root's ``bench.py`` keys and metric, and both device rates at least
     0.8 of phase 5's batch-512 serving rate;
  8. ``sweep_on_device`` over the full 2D grid (21 000 fields, 2 GB) at
     batch 512 through its ring of pinned batch slots, a batch against
     ``sweep_generator``, and its fields/s;
  9. one forward of config #5's generator with every knob (random gains
     and bases, f32, curl applied) on the card against the CPU;
 10. the datagen, through the scene functions at each configuration's full
     width (scene and frame counts cut for the time limit, the cut
     printed): ``smoke_pos21_size5`` at 128x96 x 100 of 200 frames, a 5 x 3
     sub-grid in one scene batch with the jacobi projection and 2 x 2
     with the matched one (frames finite, density rising, the manifest's
     fields, every frame's distance to range(curl2d), matched frames
     under 1e-3 with zero wall through-flow, launch counts of the curl
     kernels exact for the matched run and zero for the jacobi one);
     ``smoke3_vel5_buo3`` at 32x64x112 (3 scenes x a 25-frame segment
     jacobi, 1 scene x 4 frames matched, the 3D multigrid setup timed);
     ``liquid_pos10_size4`` (4 scenes x 60 frames, particles and P2G mass
     conserved) and ``smoke_mov`` (4 x 64, params equal to numpy's
     knots); one step of each solver on the card against the port on the
     CPU from a shared state; the matched projection through the kernels
     against the plain ops; then ``main --is_train True`` on the 2D set
     the card just wrote (loss falling) and ``render_density_sweep`` of a
     scene through the trained generator against the set's d/ frames; and
     the solvers' frames/s, idle shares and launches a frame (printed
     only);
 11. the tools (``deepfluids_tpu_torch/tools``) and the trainer's
     operational flags through their normal entry points: each
     ``bench_suite`` surface once at its full shapes (``e2e_sweep2d`` cut in
     frames, the cut printed), the launches of a timed call exact;
     ``supervise`` around a flagship 2D ``main`` run in child processes
     (bf16, batch 8, device cache) killed by ``--die_at_step``: exit 0 after
     exactly one restart, the final step reached, the loss within the
     spread of an uninterrupted run's; ``--profile_steps``: a Chrome trace
     with rows of the four 2D kernels (a window without them is run
     again), and ``--use_tensorboard`` on the same run (an event file
     where tensorboard is installed); ``--debug_nans`` on a checkpoint poisoned with a NaN raises
     and names the step, the same run without the flag does not;
     ``eval_run`` on phase 6's 2D run and phase 7's integrator,
     ``rollout_eval`` on phase 7's rollout (its ``l2_median`` is the one
     ``main`` returned), ``latent_predictability`` on phase 7's codes;
     ``weights_io.export_run`` read back bit for bit (``exact`` and
     ``by_shape``); ``regen_all`` at a cut grid (a datagen child process),
     ``--verify_only``, and a removed file refused; ``solver_consistency``
     2D (float64 CG on the card) and matched at a cut; ``make_goldens
     --check``.  Every shape these give a kernel is one of phase 2's.
 12. several ranks (``deepfluids_tpu_torch/parallel``): (a) the 2D and 3D
     fields cut into 2, 4 and 8 blocks in this process, kernels #1-#8 on
     the haloed blocks bit-equal to the whole-field kernels, forward and
     backward, launched exactly once a block; (b) ``launch_multihost
     --num_processes 1`` and ``main --arch de`` on the flagship 2D (f32, l2,
     TF32 off) as a one-rank NCCL group, its losses against the plain
     loop's; (c) two gloo ranks on the one card: ``main --num_data_shards
     2`` at global batch 16 against one rank at 16 (each rank launching the
     kernels on its 8 rows), and one batch's loss and gradients from shared
     weights under data parallelism, ``--spatial_shard`` (64 rows a rank)
     and ``--num_model_shards 2`` against the replicated step; (e) the
     generator's knobs on ranks: on the pair, the spectral residuals (a DFT
     distributed over the rows) and the grid decoder's basis injection
     under ``--spatial_shard``, one batch's gradients from random gains and
     bases, and ``KNOB_FLAGS`` through ``main``; on four gloo ranks, 2 rows
     x 2 channels (``--spatial_shard --num_model_shards 2``): the knob
     model's gradients, ``main``, its checkpoint restored in one process bit
     for bit and resumed there; each gradient job with the leaky ReLU and
     with a smooth stand-in, every kernel's rows and launches exact; (d)
     ``dryrun_multichip(2, "cuda")``; the step times of the plain loop, the
     one-rank group, the gloo pair and the knobs' groups (printed only).

Then it prints the kernels as one JSON line, the card's name and power
limit as nvidia-smi gives them, and, last, the ``{"ok": true, ...}`` line.
It needs no network and imports no jax.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TOL_KERNEL = 1e-6     # tests/test_ops.py's bar for a fused kernel
TOL_GRAD = 1e-5       # and for a gradient
BF16_ULP = 2.0 ** -7  # one bf16 ulp, relative to the value, at most
TOL_PARITY = 1e-3     # the repo's normalized-L2 parity gate
# Phase 6's card-vs-CPU step with the leaky ReLU: the card's worst gradient
# distance to the float64 network over the CPU's, at most.
K_F64 = 2.0
# Kernel-check shapes (batch + spatial).  2D: 8 is the training batch, 32
# the serving sweep's (--test_batch_size), 512 the timed one; 4 is the
# matched datagen's scene batch, 16 and 64 its multigrid setup's probe
# batches (diagonal colours, the coarsest level's dense probe); (4, 2, 5) is
# below the backward kernels' minimum extent; for the curls' row tiles,
# widths of no multiple of 4 or 8 (37, 13: runs of one point), odd heights
# (a ragged last tile), a row wider than a block's threads (1100), and odd
# heights where curl2d_bwd takes 16-byte runs (88 x 129 x 96 in f32 and
# bf16, 48 x 129 x 96 in bf16 only).  3D: config #5's grid at the
# same batches and at 48 (the 3D setup's probe batch), odd extents, the smallest backward grid, D, H or W = 2, and
# for the backward kernels' bricks: rows whose bytes are no multiple of 16
# (W = 37, 113, 5, 11), ragged last bricks along z and y, D below one brick
# of planes (3, 4), and W wider than a brick's plane (1100: column tiles).
# The tools of phase 11 add 2 (a cut ensemble or fleet), 5 (rollout_decode),
# 128 (e2e_sweep2d, an integrator's evaluation) in 2D, 4 (train3d) in 3D,
# and the goldens' (2, 32, 24), (4, 32, 24) and (1, 8, 12, 16).
KERNEL_SHAPES = {
    2: [(1, 128, 96), (2, 128, 96), (4, 128, 96), (5, 128, 96),
        (8, 128, 96), (16, 128, 96), (32, 128, 96), (64, 128, 96),
        (128, 128, 96), (512, 128, 96),
        (3, 8, 8), (2, 16, 12), (4, 2, 5), (2, 32, 24), (4, 32, 24),
        (2, 9, 37), (3, 7, 13), (3, 5, 96), (1, 5, 1100), (48, 129, 96),
        (88, 129, 96)],
    3: [(1, 32, 64, 112), (4, 32, 64, 112), (8, 32, 64, 112),
        (32, 32, 64, 112), (48, 32, 64, 112), (1, 8, 12, 16),
        (2, 5, 6, 7), (1, 3, 3, 3), (1, 2, 6, 7), (1, 5, 2, 7),
        (1, 5, 6, 2), (2, 9, 13, 37), (1, 33, 65, 113), (3, 4, 7, 5),
        (2, 3, 9, 11), (1, 4, 5, 1100)],
}
# Shapes at which the kernels also take inputs whose storage starts one
# element (3D) or one point (2D: the wrappers refuse storage not aligned to
# a point's channels) past an aligned address, a view into a larger buffer.
UNALIGNED_SHAPES = {2: [(2, 9, 37), (8, 128, 96)],
                    3: [(2, 9, 13, 37), (8, 32, 64, 112)]}
# Kernels held bit-equal to their plain versions in f32 (max abs err 0).
EXACT_KERNELS = ("curl2d_fused", "curl2d_bwd", "jacobian2d_fused",
                 "jacobian2d_bwd")
# The transposes that also run without the vorticity's cotangent (the
# training loss's call, J's alone): name -> (J's channels, the
# vorticity's).
NO_VORT = {"jacobian2d_bwd": (4, 1), "jacobian3d_bwd": (9, 3)}


@dataclasses.dataclass(frozen=True)
class MainPath:
    """One main path of the port at the full width of its configuration:
    the dataset it serves and trains on, how far each phase drives it, and
    the kernel launches a run of it must make."""
    name: str                    # "2d" / "3d"
    dataset: str
    resolution: tuple            # (H, W) or (D, H, W)
    param_names: tuple
    param_ranges: tuple
    param_counts: tuple
    num_frames: int
    serve_counts: str            # --test_counts / --test_frames of phase 4
    serve_frames: int
    train_steps: int             # phase 6: train to train_steps streaming,
    resume_steps: int            # then resume with the cache to this step
    log_step: int
    save_step: int               # a checkpoint and a sample dump each
    parity_batch: int            # batch of the f32 kernels-vs-plain step
    step_launches: dict          # kernel launches of one train step ...
    forward_launches: dict       # ... and of one generated batch
    data_type: str = "velocity"  # or "levelset" (config #3: no curl)
    train_flags: tuple = ()      # extra flags of every phase 6 run
    resume_flags: tuple = ("--device_data_cache", "true")
    # phase 6's --input_pipeline grain runs, in a log directory of their
    # own: (train to this step, resume by the decode-free skip to this one),
    # or () for none
    grain_steps: tuple = ()

    @property
    def levelset(self) -> bool:
        return self.data_type == "levelset"

    @property
    def potential(self) -> int:
        """Channels of the generator's output: psi (2D), Psi (3D), or the
        levelset itself."""
        return 1 if len(self.resolution) == 2 else 3

    @property
    def channels(self) -> int:
        """Field channels: one per spatial axis, or the levelset's one."""
        return 1 if self.levelset else len(self.resolution)

    @property
    def field_key(self) -> str:
        """The dataset's field directory."""
        return "l" if self.levelset else "v"


# Kernel launches of one train step (the curl, its backward, the jacobian
# of the prediction and of the target, the prediction's jacobian backward)
# and of one generated batch (a sample dump or a served batch: the curl).
PATH_2D = MainPath(
    name="2d", dataset="smoke_pos21_size5", resolution=(128, 96),
    param_names=("src_x_pos", "src_radius", "frame"),
    param_ranges=((0.2, 0.8), (0.04, 0.12), (0.0, 199.0)),
    param_counts=(21, 5), num_frames=200, serve_counts="21,5",
    serve_frames=20, train_steps=200, resume_steps=300, log_step=20,
    save_step=100, parity_batch=8,
    step_launches={"curl2d_fused": 1, "curl2d_bwd": 1,
                   "jacobian2d_fused": 2, "jacobian2d_bwd": 1},
    forward_launches={"curl2d_fused": 1}, grain_steps=(100, 160))
PATH_3D = MainPath(
    name="3d", dataset="smoke3_vel5_buo3", resolution=(32, 64, 112),
    param_names=("inflow_vel", "buoyancy", "frame"),
    param_ranges=((0.5, 1.5), (0.04, 0.12), (0.0, 249.0)),
    param_counts=(5, 3), num_frames=250, serve_counts="5,3",
    serve_frames=8, train_steps=60, resume_steps=90, log_step=10,
    save_step=30, parity_batch=2,
    step_launches={"curl3d_fused": 1, "curl3d_bwd": 1,
                   "jacobian3d_fused": 2, "jacobian3d_bwd": 1},
    forward_launches={"curl3d_fused": 1})
# Config #3 (liquid_pos10_size4: 128x96 levelset, drop x position x drop
# radius, 200 frames, the published 10 x 4 grid): no curl, the loss's
# jacobian term the levelset's gradient in plain torch, so no FD kernel
# anywhere.  Phase 6 resumes with the device cache and the x-mirror.
PATH_LIQ = MainPath(
    name="liquid", dataset="liquid_pos10_size4", resolution=(128, 96),
    param_names=("drop_x_pos", "drop_radius", "frame"),
    param_ranges=((0.25, 0.75), (0.06, 0.15), (0.0, 199.0)),
    param_counts=(10, 4), num_frames=200, serve_counts="10,4",
    serve_frames=20, train_steps=200, resume_steps=300, log_step=20,
    save_step=100, parity_batch=8, step_launches={}, forward_launches={},
    data_type="levelset", train_flags=("--data_type", "levelset"),
    resume_flags=("--device_data_cache", "true", "--augment_flip_x",
                  "true"))
# The generator's knobs on the 2D smoke set at the flagship width: the
# grid decoder (levels 4, features 4, rank 8), the Fourier embedding and
# the spectral residuals (8 each) and the x-mirror; a step launches a 2D
# step's kernels, a served batch the curl.  Not served by phase 4: phase 6
# serves the trained run.
KNOB_FLAGS = ("--decoder", "grid", "--grid_levels", "4", "--grid_features",
              "4", "--grid_rank", "8", "--embed_bands", "8",
              "--spectral_modes", "8", "--augment_flip_x", "true")
PATH_KNOBS = dataclasses.replace(
    PATH_2D, name="knobs", serve_counts="", serve_frames=0, train_steps=100,
    resume_steps=150, log_step=10, save_step=50, train_flags=KNOB_FLAGS,
    grain_steps=())
PATHS = (PATH_2D, PATH_3D, PATH_LIQ, PATH_KNOBS)
# The flagship width of all paths (the config.py defaults).
FLAGSHIP = {"filters": 128, "num_conv": 4}


@dataclasses.dataclass(frozen=True)
class LatentPath:
    """Config #4's pipeline at full width: the autoencoder trained on a
    moving-source set, its encode pass, the latent integrator trained on
    the codes, and its rollout decoded through the AE; how far each phase
    drives it and the kernel launches a run of it must make."""
    name: str
    dataset: str
    resolution: tuple            # (H, W)
    param_ranges: tuple          # (src_x_pos, frame)
    num_scenes: int              # the published set ...
    num_frames: int
    scenes: int                  # ... and the synthetic one made here
    frames: int
    ae_steps: int                # AE: train streaming to ae_steps, resume
    ae_resume: int               # with the device cache to ae_resume
    nn_steps: int                # integrator: train to nn_steps, resume
    nn_resume: int               # to nn_resume
    log_step: int
    save_step: int               # a checkpoint and a sample dump each
    w_num: int                   # the integrator's training window
    z_num: int
    parity_batch: int
    step_launches: dict          # kernel launches of one AE train step ...
    forward_launches: dict       # ... and of one decoded batch


# Config #4 (smoke_mov200_f400: 128x96x2, params src_x_pos and frame; AE
# filters 128, num_conv 4, repeat 5, z_num 16; integrator nn_hidden 512,
# nn_depth 2, w_num 30): 16 scenes x their first 64 frames of the published
# 200 x 400, for the time limit.  An AE step launches a "de" step's
# kernels; an integrator step, the encode pass and the rollout's latent
# steps launch none.
PATH_MOV = LatentPath(
    name="mov", dataset="smoke_mov200_f400", resolution=(128, 96),
    param_ranges=((0.2, 0.8), (0.0, 399.0)), num_scenes=200,
    num_frames=400, scenes=16, frames=64, ae_steps=200, ae_resume=300,
    nn_steps=200, nn_resume=300, log_step=20, save_step=100, w_num=30,
    z_num=16, parity_batch=8, step_launches=PATH_2D.step_launches,
    forward_launches=PATH_2D.forward_launches)

# name -> (csrc file, the TPU kernel it replaces, its inputs' channels, the
# spatial dims it takes)
KERNELS = {
    "curl2d_fused": ("fd2d.cu", "deepfluids_tpu/ops/pallas_fd.py:99", [1], 2),
    "jacobian2d_fused": ("fd2d.cu", "deepfluids_tpu/ops/pallas_fd.py:144",
                         [2], 2),
    "curl2d_bwd": ("fd2d.cu", "deepfluids_tpu/ops/pallas_fd.py:323", [2], 2),
    "jacobian2d_bwd": ("fd2d.cu", "deepfluids_tpu/ops/pallas_fd.py:387",
                       [4, 1], 2),
    "curl3d_fused": ("fd3d.cu", "deepfluids_tpu/ops/pallas_fd.py:215", [3],
                     3),
    "jacobian3d_fused": ("fd3d.cu", "deepfluids_tpu/ops/pallas_fd.py:256",
                         [3], 3),
    "curl3d_bwd": ("fd3d.cu", "deepfluids_tpu/ops/pallas_fd.py:470", [3], 3),
    "jacobian3d_bwd": ("fd3d.cu", "deepfluids_tpu/ops/pallas_fd.py:520",
                       [9, 3], 3),
}
# Channels each kernel must read and write once per point (its minimum
# traffic): curl2d 1 -> 2, jacobian2d 2 -> 4 + 1, curl2d_bwd 2 -> 1,
# jacobian2d_bwd 4 + 1 -> 2 (4 -> 2 without the vorticity's cotangent, as
# the training loss calls it); curl3d 3 -> 3, jacobian3d 3 -> 9 + 3,
# curl3d_bwd 3 -> 3, jacobian3d_bwd 9 + 3 -> 3 (9 -> 3 likewise).
CHANNELS_MOVED = {"curl2d_fused": 3, "jacobian2d_fused": 7,
                  "curl2d_bwd": 3, "jacobian2d_bwd": 7, "curl3d_fused": 6,
                  "jacobian3d_fused": 15, "curl3d_bwd": 6,
                  "jacobian3d_bwd": 15}
# f32 operations a point (differences, the transposed stencil's at most two
# per axis, the curl's and the fold's adds), for the operations bound.
FLOPS_PER_POINT = {"curl2d_fused": 3, "jacobian2d_fused": 5,
                   "curl2d_bwd": 5, "jacobian2d_bwd": 12, "curl3d_fused": 9,
                   "jacobian3d_fused": 12, "curl3d_bwd": 15,
                   "jacobian3d_bwd": 30}
# NVIDIA's data sheet, H100 SXM at 700 W: HBM3 rate and f32 outside the
# tensor cores (the FD kernels' arithmetic).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Each timed call reads inputs no earlier call left in the 50 MB L2: a ring
# of input sets of at least this many bytes, as a training step finds them.
RING_BYTES = 256 << 20
# The kernel of torch.cuda._sleep, which opens each profiled window.
SENTINEL_KERNEL = "spin_kernel"
# Inductor names every kernel it generates triton_<kind>_...: the label of
# the compiled plain versions' rows in a profiled window.
COMPILED_LABEL = "triton_"


def card_line() -> str:
    """``name, power.limit`` of the card the smoke runs on, as nvidia-smi
    prints it."""
    card = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    out = subprocess.run(
        ["nvidia-smi", "-i", card, "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` calls, CUDA events,
    after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternated(plain, kernel, iters: int) -> tuple[float, float, tuple]:
    """(kernel ms, plain ms, the four readings): plain, kernel, kernel,
    plain on the same card, the better of each pair."""
    runs = (cuda_ms(plain, iters), cuda_ms(kernel, iters),
            cuda_ms(kernel, iters), cuda_ms(plain, iters))
    return min(runs[1:3]), min(runs[0], runs[3]), runs


def plain_version(name: str):
    """The plain PyTorch version a kernel is held against: the ``ops.fd``
    function on the f32-upcast input, each output rounded once to the
    input dtype (the kernels' arithmetic)."""
    from deepfluids_tpu_torch.ops import cuda_fd, fd

    fn = getattr(fd, name.replace("_fused", ""))
    return lambda *xs: cuda_fd._in_f32(fn, *xs)


def kernel_inputs(name: str, shape: tuple, dtype, gen, device):
    """Random inputs of kernel ``name`` at ``shape`` (batch + spatial)."""
    import torch

    return [torch.randn(shape + (c,), generator=gen, device=device).to(dtype)
            for c in KERNELS[name][2]]


@contextlib.contextmanager
def plain_fd_ops():
    """The training loss through the plain ops instead of the kernels, for
    the comparisons below: ``losses`` looks ``curl2d_p`` / ``jacobian2d_p``
    / ``curl3d_p`` / ``jacobian3d_p`` up on ``cuda_fd`` at call time."""
    from deepfluids_tpu_torch.ops import cuda_fd, fd

    names = ("curl2d", "jacobian2d", "curl3d", "jacobian3d")
    saved = {n: getattr(cuda_fd, n + "_p") for n in names}
    for n in names:
        setattr(cuda_fd, n + "_p", getattr(fd, n))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(cuda_fd, n + "_p", fn)


@contextlib.contextmanager
def plain_projection_ops():
    """The matched projection's curl and its transpose through the plain
    ``ops/fd.py`` functions instead of the kernels: its operators look the
    four functions up on the module at call time."""
    from deepfluids_tpu_torch.datagen import projection
    from deepfluids_tpu_torch.ops import fd

    plain = {"_curl": lambda psi: fd.curl2d(psi[..., None]),
             "_curl_adj": projection._curl_adj_plain,
             "_curl3": fd.curl3d, "_curl3_adj": projection._curl3_adj_plain}
    saved = {n: getattr(projection, n) for n in plain}
    for n, fn in plain.items():
        setattr(projection, n, fn)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(projection, n, fn)


def expected_launches(counts: dict) -> dict:
    """Every kernel's launch count: ``counts``, zero for the others."""
    from deepfluids_tpu_torch.ops import cuda_fd

    return {**dict.fromkeys(cuda_fd.launch_counts, 0), **counts}


def phase_build(card: str) -> dict:
    from deepfluids_tpu_torch.data import native_available
    from deepfluids_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    log = os.path.join(_build.build_dir(), "build.log")
    with open(log) as f:
        text = f.read()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                             text))
    reader = ("native (native/npz_loader.cc, built into the port's _build/)"
              if native_available() else "numpy (the native one did not "
              "build)")
    print(f"phase 1 device+build: ok  card: {card}  nvcc build+load "
          f"{secs:.2f} s; ptxas: {len(regs)} kernels, {min(regs)}-"
          f"{max(regs)} registers, {spills} bytes of spill stores (all in "
          f"{os.path.relpath(log, REPO)}); .npz reader: {reader}",
          flush=True)
    return {"build_s": secs}


def check_kernel(name: str, kernel, plain, xs: list, what: str) -> float:
    """``kernel(*xs)`` against ``plain(*xs)`` on the card: f32 within the
    kernel's tolerance, bf16 within one bf16 ulp of the f32 math; the
    largest abs error."""
    import torch

    dtype = xs[0].dtype
    tol = TOL_GRAD if name.endswith("_bwd") else TOL_KERNEL
    with torch.inference_mode():
        got = kernel(*xs)
        want = plain(*xs)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for g, wt in zip(got, want):
        if g.shape != wt.shape or g.dtype != dtype:
            raise AssertionError(f"{name} gave {g.shape} {g.dtype}, want "
                                 f"{wt.shape}")
        diff = (g.float() - wt.float()).abs()
        err = float(diff.max())
        ok = (err <= tol if dtype == torch.float32 else
              bool((diff <= BF16_ULP * wt.float().abs()).all()))
        if not ok:
            raise AssertionError(f"{name} {dtype} {what}: max abs err {err}")
        worst = max(worst, err)
    return worst


def phase_kernels(device) -> dict:
    """Each kernel vs its plain version on the card; returns the largest f32
    abs error seen per kernel."""
    import torch

    from deepfluids_tpu_torch.ops import cuda_fd, fd
    from deepfluids_tpu_torch.utils.parity import normalized_l2

    gen = torch.Generator(device=device).manual_seed(0)
    worst = {name: 0.0 for name in KERNELS}
    bf16_worst = {name: 0.0 for name in KERNELS}
    for name, (_, _, _, nd) in KERNELS.items():
        bwd = name.endswith("_bwd")
        plain = plain_version(name)
        for dtype in (torch.float32, torch.bfloat16):
            seen = worst if dtype == torch.float32 else bf16_worst
            for shape in KERNEL_SHAPES[nd]:
                xs = kernel_inputs(name, shape, dtype, gen, device)
                if bwd and min(shape[1:]) < 3:
                    try:
                        getattr(cuda_fd, name)(*xs)
                    except ValueError:
                        continue
                    raise AssertionError(f"{name} accepted extent < 3: "
                                         f"{shape}")
                seen[name] = max(seen[name], check_kernel(
                    name, getattr(cuda_fd, name), plain, xs, str(shape)))
            # Storage one element (3D) or one point (2D) past an aligned
            # address.
            for shape in UNALIGNED_SHAPES[nd]:
                xs = []
                for c in KERNELS[name][2]:
                    skip = 1 if nd == 3 else c
                    xs.append(torch.randn(
                        math.prod(shape) * c + skip, generator=gen,
                        device=device).to(dtype)[skip:].view(shape + (c,)))
                seen[name] = max(seen[name], check_kernel(
                    name, getattr(cuda_fd, name), plain, xs,
                    f"{shape} unaligned"))
    for name in EXACT_KERNELS:
        if worst[name] != 0.0:
            raise AssertionError(f"{name} f32 is {worst[name]} from its plain "
                                 f"version, not bit-equal")
    # The jacobians' transposes without the vorticity's cotangent (the
    # training loss's call): J's alone, against the plain version given
    # zeros; jacobian2d_bwd bit-equal in f32, also from unaligned storage.
    no_vort = {(n, dt): 0.0 for n in NO_VORT
               for dt in (torch.float32, torch.bfloat16)}
    for (name, dtype) in no_vort:
        plain, (cj, cw) = plain_version(name), NO_VORT[name]
        nd = KERNELS[name][3]
        for shape, skip in ([(s, 0) for s in KERNEL_SHAPES[nd]]
                            + [(s, cj) for s in UNALIGNED_SHAPES[nd]]):
            if min(shape[1:]) < 3:
                continue
            gj = torch.randn(math.prod(shape) * cj + skip, generator=gen,
                             device=device).to(dtype)[skip:].view(
                                 shape + (cj,))
            no_vort[name, dtype] = max(no_vort[name, dtype], check_kernel(
                name, lambda g, f=getattr(cuda_fd, name): f(g, None),
                lambda g, cw=cw: plain(g, g.new_zeros(g.shape[:-1] + (cw,))),
                [gj], f"{shape} skip {skip} without a vorticity cotangent"))
        if name in EXACT_KERNELS and no_vort[name, torch.float32] != 0.0:
            raise AssertionError(f"{name} without a vorticity cotangent f32 "
                                 f"is {no_vort[name, torch.float32]} from its "
                                 f"plain version, not bit-equal")
    # Gradients through the autograd Functions against autograd of the
    # plain ops: the JAX tests' shapes and the flagship training batches.
    grad_err = {2: 0.0, 3: 0.0}
    # Autograd through jacobian{2,3}d_p with one output unused: its
    # cotangent arrives as None (J's alone; the vorticity's alone, J's made
    # zeros).
    for nd, shape, fn, plain_fn, chans, outs in (
            (2, (2, 16, 12), cuda_fd.jacobian2d_p, fd.jacobian2d, 2, (4, 1)),
            (2, (8, 128, 96), cuda_fd.jacobian2d_p, fd.jacobian2d, 2, (4, 1)),
            (3, (2, 5, 6, 7), cuda_fd.jacobian3d_p, fd.jacobian3d, 3, (9, 3)),
            (3, (8, 32, 64, 112), cuda_fd.jacobian3d_p, fd.jacobian3d, 3,
             (9, 3))):
        x = torch.randn(shape + (chans,), generator=gen, device=device)
        for used in (0, 1):
            cot = torch.randn(shape + (outs[used],), generator=gen,
                              device=device)
            grads = []
            for f in (fn, plain_fn):
                a = x.clone().requires_grad_()
                f(a)[used].backward(cot)
                grads.append(a.grad)
            err = float((grads[0] - grads[1]).abs().max())
            if not err <= TOL_GRAD:
                raise AssertionError(f"autograd through {fn.__name__}, only "
                                     f"output {used} used, {shape}: {err}")
            grad_err[nd] = max(grad_err[nd], err)
    for nd, shape, fn, plain_fn, chans, cot in (
            (2, (2, 16, 12), cuda_fd.curl2d_p, fd.curl2d, 1, [2]),
            (2, (8, 128, 96), cuda_fd.curl2d_p, fd.curl2d, 1, [2]),
            (2, (2, 16, 12), cuda_fd.jacobian2d_p, fd.jacobian2d, 2, [4, 1]),
            (2, (8, 128, 96), cuda_fd.jacobian2d_p, fd.jacobian2d, 2,
             [4, 1]),
            (3, (2, 5, 6, 7), cuda_fd.curl3d_p, fd.curl3d, 3, [3]),
            (3, (8, 32, 64, 112), cuda_fd.curl3d_p, fd.curl3d, 3, [3]),
            (3, (2, 5, 6, 7), cuda_fd.jacobian3d_p, fd.jacobian3d, 3,
             [9, 3]),
            (3, (8, 32, 64, 112), cuda_fd.jacobian3d_p, fd.jacobian3d, 3,
             [9, 3])):
        x = torch.randn(shape + (chans,), generator=gen, device=device)
        cots = [torch.randn(shape + (c,), generator=gen, device=device)
                for c in cot]
        grads = []
        for f in (fn, plain_fn):
            a = x.clone().requires_grad_()
            out = f(a)
            out = out if isinstance(out, tuple) else (out,)
            torch.autograd.backward(list(out), cots)
            grads.append(a.grad)
        err = float((grads[0] - grads[1]).abs().max())
        if not err <= TOL_GRAD:
            raise AssertionError(f"autograd through {fn.__name__} "
                                 f"{shape}: {err} > {TOL_GRAD}")
        grad_err[nd] = max(grad_err[nd], err)
    golden = {}
    g = np.load(os.path.join(REPO, "tests", "golden", "fd2d.npz"))
    with torch.inference_mode():
        u = cuda_fd.curl2d_fused(torch.from_numpy(g["psi"]).to(device))
        j, w = cuda_fd.jacobian2d_fused(torch.from_numpy(g["u"]).to(device))
        div = fd.divergence2d(u)[:, :-2, :-2]
    golden[2] = (max(normalized_l2(u.cpu().numpy(), g["u"]),
                     normalized_l2(j.cpu().numpy(), g["j"]),
                     normalized_l2(w.cpu().numpy(), g["w"])),
                 float(div.abs().max()))
    g = np.load(os.path.join(REPO, "tests", "golden", "fd3d.npz"))
    with torch.inference_mode():
        u = cuda_fd.curl3d_fused(torch.from_numpy(g["psi"]).to(device))
        j, w = cuda_fd.jacobian3d_fused(torch.from_numpy(g["u"]).to(device))
        div = fd.divergence3d(u)[:, :-2, :-2, :-2]
    golden[3] = (max(normalized_l2(u.cpu().numpy(), g["u"]),
                     normalized_l2(j.cpu().numpy(), g["j"]),
                     normalized_l2(w.cpu().numpy(), g["w"])),
                 float(div.abs().max()))
    for nd, (l2, div_max) in golden.items():
        if not (l2 < TOL_PARITY and div_max <= 1e-5):
            raise AssertionError(f"fd{nd}d golden: L2 {l2}, interior div "
                                 f"{div_max}")
    for nd in (2, 3):
        names = [n for n in KERNELS if KERNELS[n][3] == nd]
        jbwd = f"jacobian{nd}d_bwd"
        extra = (f" + unaligned storage at {UNALIGNED_SHAPES[nd]}" + (
            f" (f32 bit-equal: {', '.join(EXACT_KERNELS)})" if nd == 2
            else "") + f"; {jbwd} without a vorticity cotangent max abs err "
            f"f32 {no_vort[jbwd, torch.float32]} bf16 "
            f"{no_vort[jbwd, torch.bfloat16]}")
        print(f"phase 2 kernel vs plain {nd}D: ok  {len(names)} kernels x "
              f"{len(KERNEL_SHAPES[nd])} shapes x f32/bf16{extra}; f32 max "
              f"abs err { {n: worst[n] for n in names} } (tol fwd "
              f"{TOL_KERNEL}, bwd {TOL_GRAD}); bf16 within one ulp of f32 "
              f"math (max abs err { {n: bf16_worst[n] for n in names} }); "
              f"bwd refuses extent < 3; autograd vs plain autograd "
              f"(jacobian{nd}d_p also with one output unused) max abs err "
              f"{grad_err[nd]:.3e} (tol {TOL_GRAD}); fd{nd}d golden (u, J, "
              f"vort) L2 {golden[nd][0]:.3e}, interior div "
              f"{golden[nd][1]:.3e}", flush=True)
    return worst


# The conv stack's epilogue kernels (ops/bias_act.py) on the maps [B, C,
# *spatial] of each cell, every stage, channels-last: the 2D step's batch
# 8, the sweep's 512 and the 3D step's 8; contiguous NC(D)HW (the sharded
# paths) at batch 2 and at the 2D and 3D odd shapes; timed at the sweep's
# largest map and the 3D step's.
EPILOGUE_SHAPES = (
    [(b, 128, 8 << s, 6 << s) for b in (8, 512) for s in range(5)]
    + [(8, 128, 4 << s, 8 << s, 14 << s) for s in range(4)])
EPILOGUE_NC_SHAPES = [(2, 128, 64, 48), (2, 128, 16, 32, 56), (3, 12, 9, 37),
                      (2, 3, 5, 6, 7)]
EPILOGUE_TIMED = [(512, 128, 128, 96), (8, 128, 32, 64, 112)]


def _epilogue_map(shape, channels_last: bool, dtype, gen, device):
    """A random map ``[B, C, *spatial]`` in the layout, a twentieth of its
    entries exact zeros of either sign."""
    import torch

    nd = len(shape) - 2
    phys = (shape[:1] + shape[2:] + shape[1:2]) if channels_last else shape
    x = torch.randn(phys, generator=gen, device=device)
    hit = torch.rand(phys, generator=gen, device=device)
    x = torch.where(hit < 0.025, 0.0, torch.where(hit < 0.05, -0.0, x))
    x = x.to(dtype)
    return x.permute(0, nd + 1, *range(1, nd + 1)) if channels_last else x


def phase_epilogue(device, card: str) -> dict:
    """Phase 2's epilogue kernels: each bit-equal to its plain version on
    every map of the cells (and contiguous maps), the forward bit-equal to
    aten's ``add_`` + ``F.leaky_relu`` on the same cuDNN output and the
    backward to the parent's ``where(t >= 0, g, g * slope)`` of the
    pre-activation; then their device times at ``EPILOGUE_TIMED`` beside
    their bound (bytes at 3.35 TB/s), the plain version's and
    ``library_ms`` (aten's ``add_`` + ``F.leaky_relu``; its
    ``leaky_relu_backward``), a yardstick the port never calls."""
    import torch
    import torch.nn.functional as F

    from deepfluids_tpu_torch.ops import bias_act

    slope = 0.2
    gen = torch.Generator(device=device).manual_seed(25)
    checked = 0
    for dtype in (torch.float32, torch.bfloat16):
        cases = ([(s, True) for s in EPILOGUE_SHAPES]
                 + [(s, False) for s in EPILOGUE_NC_SHAPES])
        for shape, last in cases:
            x = _epilogue_map(shape, last, dtype, gen, device)
            b = torch.randn(shape[1], generator=gen, device=device).to(dtype)
            b[0], b[-1] = 0.0, -0.0
            # a tenth of the entries cancel their bias exactly
            cancel = torch.rand(x.shape, generator=gen, device=device) < 0.1
            x.copy_(torch.where(cancel, -bias_act.add_bias(
                torch.zeros_like(x), b), x))
            y = bias_act.bias_leaky_relu_fwd(x, b, slope)
            g = _epilogue_map(shape, last, dtype, gen, device)
            dx = bias_act.leaky_relu_bwd(y, g, slope)
            want_y = bias_act.bias_leaky_relu_plain(x, b, slope)
            want_dx = bias_act.leaky_relu_bwd_plain(y, g, slope)
            torch.cuda.synchronize()
            what = f"{tuple(shape)} {dtype} {'NHWC' if last else 'NCHW'}"
            if bias_act.layout(y) != bias_act.layout(x):
                raise AssertionError(f"epilogue fwd {what}: layout changed")
            if not (torch.equal(y, want_y) and torch.equal(
                    torch.signbit(y), torch.signbit(want_y))):
                raise AssertionError(f"epilogue fwd {what}: not bit-equal "
                                     f"to plain")
            if not torch.equal(dx, want_dx):
                raise AssertionError(f"epilogue bwd {what}: not bit-equal "
                                     f"to plain")
            t = bias_act.add_bias(x, b)
            if not torch.equal(dx, torch.where(t >= 0, g, g * slope)):
                raise AssertionError(f"epilogue bwd {what}: not the parent's "
                                     f"where(t >= 0, g, g * slope)")
            checked += 1
            del x, y, g, dx, want_y, want_dx, t, cancel
    # on cuDNN's own output: the parent's conv with bias adds it by add_
    aten = {}
    for nd, shape in ((2, (8, 128, 32, 24)), (3, (8, 128, 8, 16, 28))):
        conv = F.conv2d if nd == 2 else F.conv3d
        fmt = torch.channels_last if nd == 2 else torch.channels_last_3d
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen, device=device).to(
                dtype).contiguous(memory_format=fmt)
            w = (torch.randn((128, 128) + (3,) * nd, generator=gen,
                             device=device) * (128 * 3 ** nd) ** -0.5).to(
                dtype).contiguous(memory_format=fmt)
            b = (0.1 * torch.randn(128, generator=gen, device=device)).to(
                dtype)
            c = conv(x, w, padding=1)
            got = bias_act.bias_leaky_relu_fwd(c, b, slope)
            want = F.leaky_relu(c.clone().add_(bias_act.add_bias(
                torch.zeros((1, 128) + (1,) * nd, device=device,
                            dtype=dtype), b)), slope)
            with_bias = F.leaky_relu(conv(x, w, b, padding=1), slope)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"epilogue fwd {nd}D {dtype}: not "
                                     f"bit-equal to add_ + F.leaky_relu on "
                                     f"cuDNN's output")
            aten[f"{nd}d_{str(dtype)[6:]}"] = bool(torch.equal(got,
                                                               with_bias))
    print(f"phase 2 epilogue kernels vs plain: ok  fwd and bwd bit-equal on "
          f"{checked} maps (f32/bf16; the cells' stages channels-last, "
          f"{len(EPILOGUE_NC_SHAPES)} contiguous NC(D)HW), zeros of both "
          f"signs, the bwd the parent's where form; fwd bit-equal to add_ + "
          f"F.leaky_relu on cuDNN's output; equal to the conv given its bias "
          f"then F.leaky_relu: {aten}", flush=True)
    timings = []
    for shape in EPILOGUE_TIMED:
        dtype = torch.bfloat16
        x = _epilogue_map(shape, True, dtype, gen, device)
        b = torch.randn(shape[1], generator=gen, device=device).to(dtype)
        g = _epilogue_map(shape, True, dtype, gen, device)
        y = bias_act.bias_leaky_relu_fwd(x, b, slope)
        scratch = x.clone()
        bview = bias_act.add_bias(torch.zeros((1, shape[1]) + (1,) * (
            len(shape) - 2), device=device, dtype=dtype), b)
        el = x.numel() * x.element_size()
        fwd = {
            "kernel": lambda: bias_act.bias_leaky_relu_fwd(x, b, slope),
            "plain": lambda: bias_act.bias_leaky_relu_plain(x, b, slope),
            "library": lambda: F.leaky_relu(scratch.add_(bview), slope)}
        bwd = {
            "kernel": lambda: bias_act.leaky_relu_bwd(y, g, slope),
            "plain": lambda: bias_act.leaky_relu_bwd_plain(y, g, slope),
            "library": lambda: torch.ops.aten.leaky_relu_backward(
                g, y, slope, False)}
        for name, fns, nbytes in (("bias_leaky_relu_fwd", fwd, 2 * el),
                                  ("leaky_relu_bwd", bwd, 3 * el)):
            ms = {k: min(cuda_ms(f, 20) for _ in range(2))
                  for k, f in fns.items()}
            bound = nbytes / 3.35e12 * 1e3
            row = {"name": name, "shape": list(shape), "dtype": "bfloat16",
                   "layout": "channels_last", "ms": ms["kernel"],
                   "bound_ms": bound, "share": bound / ms["kernel"],
                   "plain_ms": ms["plain"], "library_ms": ms["library"],
                   "card": card}
            timings.append(row)
            print(f"phase 2 epilogue timing {name} {tuple(shape)} bf16 NHWC "
                  f"[{card}]: {ms['kernel']:.4f} ms, bound {bound:.4f} ms "
                  f"({nbytes / 1e9:.3f} GB at 3.35 TB/s), share "
                  f"{bound / ms['kernel']:.3f}; plain {ms['plain']:.4f} ms, "
                  f"library {ms['library']:.4f} ms", flush=True)
        del x, y, g, scratch
    torch.cuda.empty_cache()
    print(json.dumps({"epilogue_kernels": timings}), flush=True)
    return {"epilogue": timings}


def phase_golden(device) -> None:
    import torch

    from deepfluids_tpu_torch.models import GeneratorBE, load_flax_npz
    from deepfluids_tpu_torch.train.losses import apply_curl
    from deepfluids_tpu_torch.utils.parity import check_fields

    # The JAX goldens were made in full f32: no TF32 in convs or matmuls.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    golden = os.path.join(REPO, "tests", "golden")
    for nd, shape, what in ((2, (32, 24, 1), "32x24"),
                            (3, (8, 16, 16, 3), "8x16x16")):
        g = np.load(os.path.join(golden, f"generator{nd}d.npz"))
        model = GeneratorBE(shape, num_param=3, filters=8, num_conv=2)
        load_flax_npz(os.path.join(golden, f"generator{nd}d_params.npz"),
                      model)
        model.to(device)
        with torch.inference_mode():
            u = apply_curl(model(torch.from_numpy(g["p"]).to(device)))
        res = check_fields(u.cpu().numpy(), g["u"], TOL_PARITY)
        if not res["passed"]:
            raise AssertionError(f"generator {nd}D golden failed: {res}")
        print(f"phase 3 generator golden {nd}D: ok  GeneratorBE {what} f8 "
              f"c2 f32 + curl{nd}d kernel vs JAX max L2 "
              f"{res['max_l2']:.3e} (tol {TOL_PARITY})", flush=True)


def save_path_manifest(path: MainPath, ds: str,
                       v_range=(-4.0, 4.0)) -> None:
    """The published manifest of ``path``'s dataset."""
    from deepfluids_tpu_torch.data import Manifest, save_manifest

    save_manifest(Manifest(
        param_names=list(path.param_names),
        param_ranges=[list(r) for r in path.param_ranges],
        num_scenes=math.prod(path.param_counts), num_frames=path.num_frames,
        resolution=list(path.resolution), num_channels=path.channels,
        v_range=list(v_range), data_type=path.data_type,
        param_counts=list(path.param_counts)), ds)


def flagship_model(path: MainPath):
    """The flagship GeneratorBE of ``path`` (filters 128, num_conv 4, bf16),
    as the Trainer builds it from the default flags."""
    import torch

    from deepfluids_tpu_torch.models import GeneratorBE

    return GeneratorBE(tuple(path.resolution) + (path.potential,),
                       num_param=3, compute_dtype=torch.bfloat16, **FLAGSHIP)


def make_serving_run(root: str, path: MainPath, seed: int = 0,
                     files: int = 6) -> str:
    """A synthetic dataset of ``path``'s shape (``files`` random fields, for
    the manifest and ``evaluate``) and a run dir with flagship params.json
    (bf16) and seeded weights.npz."""
    from deepfluids_tpu_torch.config import Config, save_config
    from deepfluids_tpu_torch.models import flax_shapes

    rng = np.random.default_rng(seed)
    data_dir = os.path.join(root, "data")
    ds = os.path.join(data_dir, path.dataset)
    save_path_manifest(path, ds)
    os.makedirs(os.path.join(ds, path.field_key))
    lo = [r[0] for r in path.param_ranges]
    for k in range(files):
        scene, frame = divmod(k, 3)
        np.savez_compressed(
            os.path.join(ds, path.field_key, f"{scene}_0_{frame}.npz"),
            x=rng.standard_normal(tuple(path.resolution) + (
                path.channels,)).astype(np.float32),
            y=np.array([lo[0] + 0.03 * scene, lo[1], frame], np.float32))
    run = os.path.join(root, f"run_{path.name}")
    save_config(Config(data_dir=data_dir, dataset=path.dataset,
                       data_type=path.data_type, compute_dtype="bfloat16",
                       **FLAGSHIP), run)
    # Flax-layout weights, lecun-normal-scaled, zero biases (Flax's init).
    weights = {}
    for key, shape in flax_shapes(flagship_model(path)).items():
        if key.endswith("/bias"):
            weights[key] = np.zeros(shape, np.float32)
        else:
            fan_in = math.prod(shape[:-1])
            weights[key] = (rng.standard_normal(shape)
                            / math.sqrt(fan_in)).astype(np.float32)
    np.savez(os.path.join(run, "weights.npz"), **weights)
    return run


def phase_serving(device, root: str, path: MainPath) -> dict:
    import torch

    from deepfluids_tpu_torch.config import get_config
    from deepfluids_tpu_torch.data import load_manifest
    from deepfluids_tpu_torch.infer.sweep import param_grid
    from deepfluids_tpu_torch.main import main
    from deepfluids_tpu_torch.models import load_flax_npz
    from deepfluids_tpu_torch.ops import cuda_fd, fd
    from deepfluids_tpu_torch.utils.parity import normalized_l2

    # Deterministic cuDNN, so the recomputation below runs the convolutions
    # the sweep ran and any difference is the curl's.
    torch.backends.cudnn.deterministic = True
    run = make_serving_run(root, path)
    counts, frames = path.serve_counts, path.serve_frames
    cfg = get_config(["--is_train", "False", "--load_path", run,
                      "--test_counts", counts, "--test_frames", str(frames)])
    n_fields = math.prod(int(c) for c in counts.split(",")) * frames
    n_data = len(glob.glob(os.path.join(root, "data", path.dataset,
                                        path.field_key, "*.npz")))
    bs = cfg.test_batch_size
    batches = -(-n_fields // bs) + -(-min(128, n_data) // bs)
    expect = expected_launches({k: n * batches for k, n in
                                path.forward_launches.items()})

    cuda_fd.reset_launch_counts()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    result = main(cfg, device=device)
    torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    launches = dict(cuda_fd.launch_counts)
    if launches != expect:
        raise AssertionError(f"the {path.name} serving path launched "
                             f"{launches}, expected {expect}: "
                             f"{path.forward_launches} per batch "
                             f"({batches}) and nothing else")

    out_dir = os.path.join(run, "test")
    files = sorted(glob.glob(os.path.join(out_dir, "*.npz")))
    if result["num_fields"] != n_fields or len(files) != n_fields:
        raise AssertionError(f"{len(files)} .npz written, {n_fields} wanted")
    field_shape = tuple(path.resolution) + (path.channels,)
    for f in files:
        with np.load(f) as d:
            if (d["x"].shape != field_shape or d["y"].shape != (3,)
                    or not np.isfinite(d["x"]).all()):
                raise AssertionError(f"bad artifact {f}")
    ev = result["eval"]
    if not np.isfinite(ev["l2_mean"]):
        raise AssertionError(f"eval not finite: {ev}")
    pngs = glob.glob(os.path.join(out_dir, "*.png"))
    if not pngs or not os.path.exists(os.path.join(out_dir, "scene0.gif")):
        raise AssertionError("PNG / GIF artifacts missing")

    # The first batch again, through the plain curl (none for a levelset):
    # same fields.
    model = flagship_model(path)
    load_flax_npz(os.path.join(run, "weights.npz"), model)
    model.to(device)
    manifest = load_manifest(os.path.join(root, "data", path.dataset))
    raw = param_grid(manifest, [int(c) for c in counts.split(",")], frames)
    p = torch.from_numpy(manifest.normalize_params(raw[:bs])).to(device)
    curl = (lambda out: out) if path.levelset else (
        fd.curl2d if path.potential == 1 else fd.curl3d)
    with torch.inference_mode():
        ref = manifest.denormalize_field(curl(model(p)).cpu().numpy())
    torch.backends.cudnn.deterministic = False
    got = np.stack([np.load(os.path.join(out_dir, f"0_{k}.npz"))["x"]
                    for k in range(min(bs, frames))])
    l2 = normalized_l2(got, ref[:len(got)])
    if not l2 < TOL_PARITY:
        raise AssertionError(f"sweep fields vs plain curl: L2 {l2} >= "
                             f"{TOL_PARITY}")
    curl_name = next(iter(path.forward_launches), None)
    what = (f"{curl_name} launches {launches[curl_name]} = {batches} "
            f"batches, no other kernel" if curl_name else
            f"no FD kernel in {batches} batches (no curl)")
    cut = ("" if frames == path.num_frames else
           f" ({frames} of the {path.num_frames} frames, cut for the time "
           f"limit)")
    print(f"phase 4 serving path {path.name.upper()}: ok  main() "
          f"--test_counts {counts} --test_frames {frames}{cut}: {n_fields} "
          f"fields of {'x'.join(map(str, field_shape))}, {len(pngs)} PNGs + "
          f"GIF in {secs:.2f} s ({n_fields / secs:.1f} fields/s end to end "
          f"incl. build/load/eval/writes); {what}; eval l2_mean "
          f"{ev['l2_mean']:.4f}; sweep vs recomputation through the plain "
          f"ops L2 {l2:.2e}", flush=True)
    return {"launches": launches, "serving_s": secs, "fields": n_fields,
            "weights": os.path.join(run, "weights.npz")}


def _train_fields_2d(path: MainPath):
    """(file name, field, params) of the 2D training set: 128x96x2 velocity
    (``path.resolution``), the curl of a Gaussian stream-function blob
    whose x position, radius and height follow (src_x_pos, src_radius,
    frame); 16 scenes x 16 frames (256 of the published 21 000)."""
    h, w = path.resolution
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, w / h, w),
                         indexing="ij")
    frames = 16
    for s in range(16):
        pos, size = divmod(s, 4)
        x_pos, radius = 0.2 + 0.6 * pos / 3, 0.04 + 0.08 * size / 3
        for f in range(frames):
            frame = 199.0 * f / (frames - 1)
            cy = 0.1 + 0.8 * frame / 199.0
            r = 2.0 * radius + 0.05
            psi = np.exp(-((xx - 0.75 * x_pos) ** 2 + (yy - cy) ** 2)
                         / (2 * r * r))
            u = np.diff(psi, axis=0, append=psi[-1:]) * h
            v = -np.diff(psi, axis=1, append=psi[:, -1:]) * w
            yield (f"{pos * 5}_{size}_{f}.npz",
                   np.stack([u, v], -1).astype(np.float32),
                   np.array([x_pos, radius, frame], np.float32))


def _train_fields_3d(path: MainPath):
    """(file name, field, params) of the 3D training set: 32x64x112x3
    velocity (``path.resolution``), the curl of a Gaussian vector-potential
    blob that rises with the frame at the inflow velocity's pace and grows
    with the buoyancy; the published 5 x 3 scenes x 8 frames (120 of
    3750)."""
    import torch

    from deepfluids_tpu_torch.ops import fd

    d, h, w = path.resolution
    zz, yy, xx = np.meshgrid(np.linspace(0, d / h, d), np.linspace(0, 1, h),
                             np.linspace(0, w / h, w), indexing="ij")
    frames = np.linspace(0.0, 249.0, 8)
    for i, vel in enumerate(np.linspace(0.5, 1.5, 5)):
        for j, buo in enumerate(np.linspace(0.04, 0.12, 3)):
            for f, frame in enumerate(frames):
                cy = 0.1 + 0.8 * min(1.0, vel * frame / 249.0)
                r = 2.0 * buo + 0.05
                blob = np.exp(-((xx - w / h / 2) ** 2 + (yy - cy) ** 2
                                + (zz - d / h / 2) ** 2) / (2 * r * r))
                psi = np.stack([0.5 * blob, blob, -0.7 * blob], -1)
                vel_field = fd.curl3d(torch.from_numpy(psi)).numpy() * h
                yield (f"{i}_{j}_{f}.npz", vel_field.astype(np.float32),
                       np.array([vel, buo, frame], np.float32))


def _train_fields_liquid(path: MainPath):
    """(file name, field, params) of config #3's training set: a 128x96
    levelset (``path.resolution``), the signed distance to a falling drop
    (a disc whose x position and radius are (drop_x_pos, drop_radius) and
    whose height falls with the frame) united with a pool at the bottom;
    4 positions x 4 radii of the published 10 x 4 grid, 16 frames each
    (256 of the published 8 000).  The drop's centre is ``drop_x_pos`` of
    the width, so the x-mirror maps a scene onto the one at 1 - x."""
    h, w = path.resolution
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, w / h, w),
                         indexing="ij")
    positions = np.linspace(*path.param_ranges[0], path.param_counts[0])
    radii = np.linspace(*path.param_ranges[1], path.param_counts[1])
    frames = 16
    for i in (0, 3, 6, 9):
        for j in range(4):
            for f in range(frames):
                frame = 199.0 * f / (frames - 1)
                cy = 0.85 - 0.6 * frame / 199.0
                drop = np.hypot(xx - positions[i] * w / h, yy - cy) - radii[j]
                yield (f"{i}_{j}_{f}.npz",
                       np.minimum(drop, yy - 0.15)[..., None].astype(
                           np.float32),
                       np.array([positions[i], radii[j], frame], np.float32))


def make_train_dataset(root: str, path: MainPath) -> str:
    """A learnable synthetic dataset of ``path``'s shape under its published
    manifest (v_range from the fields); its data dir."""
    data_dir = os.path.join(root, f"train_data_{path.name}")
    ds = os.path.join(data_dir, path.dataset)
    os.makedirs(os.path.join(ds, path.field_key))
    fields = (_train_fields_liquid if path.levelset else
              _train_fields_2d if path.potential == 1 else _train_fields_3d)
    lo = hi = 0.0
    for name, x, y in fields(path):
        lo, hi = min(lo, float(x.min())), max(hi, float(x.max()))
        np.savez(os.path.join(ds, path.field_key, name), x=x, y=y)
    vmax = max(-lo, hi)
    save_path_manifest(path, ds, (lo, hi) if path.levelset else
                       (-4.0, 4.0) if path.potential == 1 else (-vmax, vmax))
    return data_dir


def _metrics(run: str) -> list[dict]:
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def phase_train(device, root: str, path: MainPath) -> dict:
    """Train, resume and serve ``path`` through ``main`` at the flagship
    width; then its ``--input_pipeline grain`` runs, if it has
    ``grain_steps`` (:func:`phase_train_grain`)."""
    from deepfluids_tpu_torch.config import get_config
    from deepfluids_tpu_torch.main import main
    from deepfluids_tpu_torch.ops import cuda_fd

    t0 = time.perf_counter()
    data_dir = make_train_dataset(root, path)
    data_s = time.perf_counter() - t0
    logs = os.path.join(root, "logs")
    tag = f"chip_{path.name}"
    flags = ["--is_train", "True", "--arch", "de", "--data_dir", data_dir,
             "--dataset", path.dataset, "--log_dir", logs, "--tag", tag,
             "--batch_size", "8", "--compute_dtype", "bfloat16",
             "--log_step", str(path.log_step),
             "--save_step", str(path.save_step),
             "--test_step", str(path.save_step),
             "--num_worker", "4", "--filters", str(FLAGSHIP["filters"]),
             "--num_conv", str(FLAGSHIP["num_conv"]), *path.train_flags]
    run = os.path.join(logs, f"{path.dataset}_{tag}")
    n0, n1, save = path.train_steps, path.resume_steps, path.save_step

    def per_step(steps: int, dumps: int) -> dict:
        return expected_launches({
            k: steps * n + dumps * path.forward_launches.get(k, 0)
            for k, n in path.step_launches.items()})

    runs = []
    for argv, steps, dumps in (
            (flags + ["--max_step", str(n0)], n0, n0 // save),
            (flags + ["--max_step", str(n1), "--load_path", run,
                      *path.resume_flags],
             n1 - n0, n1 // save - n0 // save)):
        what = f"{path.name} training ({steps} steps, {dumps} sample dumps)"
        with step_log() as seen:
            _, secs, launches = _drive(device, argv, per_step(steps, dumps),
                                       what)
        runs.append({"secs": secs, "launches": launches, "steps": steps,
                     "graph": graph_taken(seen, what)})

    rows = _metrics(run)
    steps = [r["step"] for r in rows]
    want = list(range(path.log_step, n1 + 1, path.log_step))
    if steps != want:   # the resume must start at the saved step
        raise AssertionError(f"metrics steps {steps}, want {want}")
    first, last = _falls(rows, n0, path.name)
    ckpts = sorted(int(n) for n in os.listdir(os.path.join(run, "checkpoint")))
    saves = list(range(save, n1 + 1, save))
    samples = sorted(os.listdir(os.path.join(run, "sample")))
    if ckpts != sorted({*saves, n0, n1})[-3:] or samples != [
            f"{s:07d}.png" for s in saves]:
        raise AssertionError(f"checkpoints {ckpts}, samples {samples}")

    # Serve a small grid from the trained run's weights.npz.
    cuda_fd.reset_launch_counts()
    result = main(get_config(["--is_train", "False", "--load_path", run,
                              "--test_counts", "3,2", "--test_frames", "4"]),
                  device=device)
    served = dict(cuda_fd.launch_counts)
    files = sorted(glob.glob(os.path.join(run, "test", "*.npz")))
    if result["num_fields"] != 24 or len(files) != 24:
        raise AssertionError(f"served {len(files)} fields, want 24")
    field_shape = tuple(path.resolution) + (path.channels,)
    for f in files:
        with np.load(f) as d:
            if d["x"].shape != field_shape or not np.isfinite(d["x"]).all():
                raise AssertionError(f"bad artifact {f}")
    # one sweep batch of 24 fields and ceil(min(128, files) / 32) evaluate
    # batches
    n_data = len(glob.glob(os.path.join(data_dir, path.dataset,
                                        path.field_key, "*.npz")))
    batches = 1 + -(-min(128, n_data) // 32)
    want = expected_launches({k: batches * n for k, n in
                              path.forward_launches.items()})
    if not (np.isfinite(result["eval"]["l2_mean"]) and served == want):
        raise AssertionError(f"serving the trained run: {result['eval']}, "
                             f"launches {served}, want {want}")
    rate = {"stream": rows[n0 // path.log_step - 1]["steps_per_sec"],
            "cache": rows[-1]["steps_per_sec"]}
    grain = (phase_train_grain(device, root, path, data_dir, flags,
                               per_step) if path.grain_steps else None)
    nonzero = {k: v for k, v in runs[0]["launches"].items() if v}
    extra = " ".join(path.train_flags)
    print(f"phase 6 training path {path.name.upper()}: ok  main() --is_train "
          f"True flagship GeneratorBE bf16 batch 8{' ' + extra if extra else ''}"
          f" on {n_data} synthetic frames (made in {data_s:.2f} s): {n0} "
          f"steps in {runs[0]['secs']:.2f} s, resumed at step {n0} with "
          f"{' '.join(path.resume_flags)} to {n1} in {runs[1]['secs']:.2f} "
          f"s; loss "
          f"{first:.4f} (step {path.log_step}) -> {last:.4f} (step {n0}) -> "
          f"{rows[-1]['loss']:.4f} (step {n1}); launches of the first run "
          f"{nonzero} = {path.step_launches} per step + "
          f"{path.forward_launches} per sample dump, exact in both runs "
          f"(train step path: CUDA graph, {runs[0]['graph']}); "
          f"checkpoints {ckpts}; sample PNGs {samples}; served 24 fields from "
          f"weights.npz (eval l2_mean {result['eval']['l2_mean']:.4f}); "
          f"steps/s end to end (metrics.jsonl) streaming {rate['stream']}, "
          f"device cache {rate['cache']}"
          + (f", grain {grain['steps_per_sec']['grain']} (resumed "
             f"{grain['steps_per_sec']['grain_resumed']})" if grain else ""),
          flush=True)
    return {"run": run, "data_dir": data_dir, "runs": runs,
            "steps_per_sec": rate, "served": served, "grain": grain}


@contextlib.contextmanager
def pinned_grain_batches(count: dict):
    """``grain_loader.make_grain_loader`` wrapped so that every batch it
    hands the trainer must be pinned before the trainer copies it to the
    card; ``count["batches"]`` counts them.  The trainer looks the function
    up on the module at call time."""
    from deepfluids_tpu_torch.data import grain_loader

    make = grain_loader.make_grain_loader

    def checked(*args, **kwargs):
        with contextlib.closing(make(*args, **kwargs)) as stream:
            for x, y in stream:
                if not (x.is_pinned() and y.is_pinned()):
                    raise AssertionError("a grain batch reached the trainer "
                                         "unpinned")
                count["batches"] += 1
                yield x, y

    grain_loader.make_grain_loader = checked
    try:
        yield
    finally:
        grain_loader.make_grain_loader = make


def phase_train_grain(device, root: str, path: MainPath, data_dir: str,
                      flags: list[str], per_step) -> dict:
    """``--input_pipeline grain --num_worker 4`` through ``main`` on
    ``path``'s training set, from scratch and resumed by the decode-free
    skip, in a log directory of its own: launches exact per step, the loss
    falling, the metrics steps contiguous across the resume and every batch
    pinned; then, on the host, the resumed stream's first batches against
    the fresh stream's."""
    import itertools

    import torch

    from deepfluids_tpu_torch.config import load_config
    from deepfluids_tpu_torch.data import grain_loader

    logs = os.path.join(root, "logs_grain")
    gflags = list(flags)
    gflags[gflags.index("--log_dir") + 1] = logs
    gflags += ["--input_pipeline", "grain"]   # flags read with 4 workers
    run = os.path.join(logs, f"{path.dataset}_chip_{path.name}")
    (n0, n1), save = path.grain_steps, path.save_step
    runs, pinned = [], {"batches": 0}
    with pinned_grain_batches(pinned):
        for argv, steps, dumps in (
                (gflags + ["--max_step", str(n0)], n0, n0 // save),
                (gflags + ["--max_step", str(n1), "--load_path", run],
                 n1 - n0, n1 // save - n0 // save)):
            what = f"{path.name} grain training ({steps} steps)"
            with step_log() as seen:
                _, secs, launches = _drive(device, argv,
                                           per_step(steps, dumps), what)
            runs.append({"secs": secs, "launches": launches, "steps": steps,
                         "graph": graph_taken(seen, what)})
    if pinned["batches"] != n1:
        raise AssertionError(f"the trainer took {pinned['batches']} grain "
                             f"batches in {n1} steps")
    rows = _metrics(run)
    want = list(range(path.log_step, n1 + 1, path.log_step))
    if [r["step"] for r in rows] != want:
        raise AssertionError(f"grain metrics steps "
                             f"{[r['step'] for r in rows]}, want {want}")
    first, last = _falls(rows, n0, f"{path.name} grain")
    # The decode-free skip on the host: the stream resumed at batch n0
    # against the fresh stream's batches n0, n0 + 1, ...
    cfg, k = load_config(run), 4
    ds = os.path.join(data_dir, path.dataset)
    kw = dict(seed=cfg.seed, field_key=path.field_key, worker_count=4)
    with contextlib.closing(grain_loader.make_grain_loader(
            ds, cfg.batch_size, **kw)) as fresh, contextlib.closing(
            grain_loader.make_grain_loader(ds, cfg.batch_size,
                                           skip_batches=n0, **kw)) as skip:
        tail = list(itertools.islice(fresh, n0, n0 + k))
        head = list(itertools.islice(skip, k))
    if len(head) != k or not all(
            torch.equal(a, b) for ht, tt in zip(head, tail)
            for a, b in zip(ht, tt)):
        raise AssertionError("the resumed grain stream differs from the "
                             "fresh stream's tail")
    rate = {"grain": rows[n0 // path.log_step - 1]["steps_per_sec"],
            "grain_resumed": rows[-1]["steps_per_sec"]}
    print(f"phase 6 grain {path.name.upper()}: ok  main() --is_train True "
          f"--input_pipeline grain --num_worker 4, flagship bf16 batch 8: "
          f"{n0} steps in {runs[0]['secs']:.2f} s, resumed at step {n0} by "
          f"the decode-free skip to {n1} in {runs[1]['secs']:.2f} s; loss "
          f"{first:.4f} -> {last:.4f} (step {n0}) -> {rows[-1]['loss']:.4f} "
          f"(step {n1}); launches {path.step_launches} per step + "
          f"{path.forward_launches} per sample dump, exact in both runs "
          f"(train step path: CUDA graph, {runs[0]['graph']}); "
          f"all {n1} batches pinned before their copy; the resumed stream's "
          f"first {k} batches bit-equal to the fresh stream's batches "
          f"{n0}..{n0 + k - 1}; steps/s end to end (metrics.jsonl) "
          f"{rate['grain']} (resumed {rate['grain_resumed']})", flush=True)
    return {"run": run, "runs": runs, "steps_per_sec": rate}


def phase_train_parity(device, train: dict, path: MainPath) -> None:
    """One f32 train step's loss and gradients, kernels against plain ops,
    on the same weights and batch (TF32 off, deterministic cuDNN)."""
    import torch

    from deepfluids_tpu_torch.config import load_config
    from deepfluids_tpu_torch.ops import cuda_fd
    from deepfluids_tpu_torch.train.trainer import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg = load_config(train["run"])
    cfg.compute_dtype = "float32"
    t = Trainer(cfg, run_dir=train["run"], device=device, save_cfg=False)
    t.restore_weights()
    b = path.parity_batch
    x, y = (torch.from_numpy(a[:b]).to(device) for a in t.bm.step_batch(1))
    results = []
    for plain in (False, True):
        cuda_fd.reset_launch_counts()
        t.model.zero_grad(set_to_none=True)
        with plain_fd_ops() if plain else contextlib.nullcontext():
            loss, _ = t._loss_fn(t.model, x, y)
            loss.backward()
        torch.cuda.synchronize()
        results.append((loss.item(), {n: p.grad.clone() for n, p in
                                      t.model.named_parameters()},
                        dict(cuda_fd.launch_counts)))
    torch.backends.cudnn.deterministic = False
    (lk, gk, nk), (lp, gp, np_) = results
    if nk != expected_launches(path.step_launches) or any(np_.values()):
        raise AssertionError(f"parity launches: kernels {nk}, plain {np_}")
    # Each parameter's gradient error relative to its own largest entry;
    # conv_out's bias (the AE decoder's too) against the largest entry of
    # all gradients, since the curl annihilates a constant potential and
    # its gradient is rounding noise.
    scale = max(float(g.abs().max()) for g in gp.values())
    err = {n: float((gk[n] - gp[n]).abs().max()) / (
        scale if n.endswith("conv_out.bias") else float(gp[n].abs().max()))
        for n in gk}
    worst = max(err, key=err.get)
    if not (abs(lk - lp) <= 1e-6 * abs(lp) and err[worst] <= TOL_GRAD):
        raise AssertionError(f"kernel vs plain train step: loss {lk} vs "
                             f"{lp}, relative grad errors {err}")
    print(f"phase 6 parity {path.name.upper()}: ok  one f32 train step at "
          f"the flagship width, batch {b}, TF32 off, deterministic cuDNN: "
          f"loss kernels {lk!r} vs plain {lp!r}; every parameter's gradient "
          f"within {err[worst]:.2e} ({worst}) of the plain one, relative to "
          f"its largest entry (tol {TOL_GRAD})", flush=True)


@contextlib.contextmanager
def activation_as(fn):
    """The models' activation replaced by ``fn`` (None: kept), a function
    of a conv's bias-free output, its bias and the slope: the generator and
    the encoder look ``activation.bias_leaky_relu`` up at call time."""
    from deepfluids_tpu_torch.models import activation

    saved = activation.bias_leaky_relu
    activation.bias_leaky_relu = fn or saved
    try:
        yield
    finally:
        activation.bias_leaky_relu = saved


def with_bias(fn):
    """An elementwise activation ``fn(t, slope)`` as the models' hook: the
    bias added by aten first."""
    from deepfluids_tpu_torch.ops import bias_act

    return lambda x, b, slope: fn(bias_act.add_bias(x, b), slope)


def _recording(fn, branches: list, zeros: list):
    """``fn`` (the models' hook) that appends each call's branch ``x + b >=
    0`` to ``branches``, on the CPU, and its count of exact zeros to
    ``zeros``."""
    from deepfluids_tpu_torch.ops import bias_act

    def act(x, b, slope):
        t = bias_act.add_bias(x.detach(), b.detach())
        branches.append((t >= 0).cpu())
        zeros.append(int((t == 0).sum()))
        return fn(x, b, slope)
    return act


def _replaying(branches: list):
    """A leaky ReLU hook that takes, call by call, the branches
    ``branches`` recorded (``where(branch, t, slope * t)`` of ``t = x +
    b``, and its gradient likewise): a float64 network replaying another
    step's kink decisions."""
    import torch

    from deepfluids_tpu_torch.ops import bias_act

    calls = iter(branches)

    def act(x, b, slope):
        t = bias_act.add_bias(x, b)
        branch = next(calls).to(x.device)
        return torch.where(branch, t, t * slope)
    return act


def cpu_parity_readings(device, train: dict, path: MainPath,
                        act=None) -> dict:
    """One f32 train step (l2) of ``train``'s run at ``path.parity_batch``
    from its trained weights, on the card (TF32 off, deterministic cuDNN)
    and on the CPU in this process, each with the models' leaky ReLU
    (``act`` in its place when given) and with the smooth stand-in, and the
    card's also with the slope 0.1 (the negative control); each leaky step
    records its kink branches, and the float64 network (the card trainer's,
    on the card with cuDNN off, the loss on its f32 output) takes that step
    again with those branches, and once with its own.  Returns each step's
    ``(loss, gradients)``, the branches that differ from float64's own,
    the exact zeros each leaky step's activations met and the FD
    launches."""
    import copy

    import torch

    from deepfluids_tpu_torch.config import load_config
    from deepfluids_tpu_torch.models import activation
    from deepfluids_tpu_torch.ops import cuda_fd
    from deepfluids_tpu_torch.train.trainer import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg = load_config(train["run"])
    cfg.compute_dtype, cfg.loss_norm = "float32", "l2"
    b = path.parity_batch
    cpu = torch.device("cpu")
    trainers, batches = {}, {}
    for dev in (device, cpu):
        t = Trainer(cfg, run_dir=train["run"], device=dev, save_cfg=False)
        t.restore_weights()
        trainers[dev] = t
        batches[dev] = [torch.from_numpy(a[:b]).to(dev)
                        for a in t.bm.step_batch(1)]
    leaky = act or activation.bias_leaky_relu
    # the kernels take f32 and bf16: the float64 network's leaky ReLU is the
    # unfused one, with the same gradient at 0
    leaky64 = act or with_bias(activation.leaky_relu)

    def step(dev, fn, f64: bool = False):
        t = trainers[dev]
        model = t.model
        if f64:
            model = copy.deepcopy(t.model).double()
            model.compute_dtype = torch.float64
        # float64 through the plain CUDA convolutions (cuDNN off; flags()
        # sets every cuDNN flag, so TF32 stays off by name)
        no_cudnn = (torch.backends.cudnn.flags(
            enabled=False, deterministic=True, allow_tf32=False) if f64
            else contextlib.nullcontext())
        with activation_as(fn), no_cudnn:
            loss, _ = t._loss_fn(model, *batches[dev])
            loss.backward()
        grads = {n: p.grad.cpu().double().numpy()
                 for n, p in model.named_parameters()}
        t.model.zero_grad(set_to_none=True)
        return loss.item(), grads

    cuda_fd.reset_launch_counts()
    out, branches, zeros = {}, {}, {}
    for name, dev, fn in (("card", device, leaky), ("cpu", cpu, leaky),
                          ("card_slope01", device,
                           lambda x, b, s: leaky(x, b, 0.1)),
                          ("f64", device, leaky64)):
        branches[name], zeros[name] = [], []
        out[name] = step(dev, _recording(fn, branches[name], zeros[name]),
                         f64=name == "f64")
    for name in ("card", "cpu", "card_slope01"):
        out[name + "_f64"] = step(device, _replaying(branches[name]),
                                  f64=True)
    out["card_smooth"] = step(device, activation.bias_smooth)
    out["cpu_smooth"] = step(cpu, activation.bias_smooth)
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    out["flips"] = {name: sum(int((a != w).sum()) for a, w in
                              zip(branches[name], branches["f64"]))
                    for name in ("card", "cpu")}
    out["zeros"] = {name: sum(zeros[name]) for name in ("card", "cpu", "f64")}
    out["launches"] = dict(cuda_fd.launch_counts)
    return out


def _worst_l2(got: dict, want: dict) -> tuple[str, float]:
    """The parameter whose gradient is farthest from ``want``'s in
    normalized L2, and that distance."""
    from deepfluids_tpu_torch.utils.parity import normalized_l2

    err = {n: normalized_l2(got[n], want[n]) for n in want}
    worst = max(err, key=err.get)
    return worst, err[worst]


def phase_cpu_parity(device, train: dict, path: MainPath) -> None:
    """A path without kernels (config #3): the card's f32 train step (l2,
    TF32 off, deterministic cuDNN) against the CPU's from the trained
    weights (:func:`cpu_parity_readings`), held so that the check does not
    hinge on where the card's bf16 training happened to stop:

      (i) with the smooth stand-in (no kink), card against CPU: the loss
          within 1e-5 relative, every gradient at normalized L2 <
          TOL_PARITY.  This is the arithmetic the check holds;
     (ii) with the models' leaky ReLU, each side against the float64
          network taking that side's kink branches: the card's worst
          gradient L2 at most K_F64 times the CPU's (the CPU's path is the
          one the tests hold against JAX).  A pre-activation within
          rounding of zero takes either branch, and one such point at a
          coarse stage moves a conv kernel's gradient by ~1e-3 (normalized
          L2), so the distance to float64's own branches (printed, with
          the count of branches that differ) and card against CPU directly
          (5.47e-4 at one trained state, 1.71e-3 at another, on an H100)
          move with the trained state; they are printed, not held.
          Negative control: the card's step with the slope 0.1 must fail
          (ii).

    No FD kernel is launched (the path has none).  The step takes the l2
    loss: L1's sign flips wherever a residual is within rounding of zero."""
    r = cpu_parity_readings(device, train, path)
    (lc, gc), (lh, gh), (_, g64) = r["card"], r["cpu"], r["f64"]
    (ls, gs), (lhs, ghs) = r["card_smooth"], r["cpu_smooth"]
    smooth = _worst_l2(gs, ghs)
    card64 = _worst_l2(gc, r["card_f64"][1])
    cpu64 = _worst_l2(gh, r["cpu_f64"][1])
    ratio = card64[1] / cpu64[1]
    control = _worst_l2(r["card_slope01"][1],
                        r["card_slope01_f64"][1])[1] / cpu64[1]
    own = (_worst_l2(gc, g64), _worst_l2(gh, g64))
    direct = _worst_l2(gc, gh)
    if not (abs(ls - lhs) <= 1e-5 * abs(lhs) and smooth[1] < TOL_PARITY):
        raise AssertionError(f"(i) card vs CPU with the smooth stand-in: "
                             f"loss {ls} vs {lhs}, worst gradient L2 "
                             f"{smooth}")
    if abs(ls - lc) <= 1e-5 * abs(lc):
        raise AssertionError(f"the smooth stand-in is not live: loss {ls} "
                             f"vs the leaky {lc}")
    if not (abs(lc - lh) <= 1e-5 * abs(lh) and ratio <= K_F64):
        raise AssertionError(f"(ii) against float64 on the same branches: "
                             f"card {card64}, CPU {cpu64}, ratio {ratio} "
                             f"(tol {K_F64}); loss {lc} vs {lh}")
    if control <= K_F64:
        raise AssertionError(f"(ii)'s negative control passed: the card's "
                             f"step with the slope 0.1 is {control} times "
                             f"the CPU's distance to float64")
    if r["launches"] != expected_launches({}):
        raise AssertionError(f"card vs CPU: launches {r['launches']}")
    print(f"phase 6 parity {path.name.upper()}: ok  one f32 train step (l2) "
          f"at the flagship width, batch {path.parity_batch}, card (TF32 "
          f"off, deterministic cuDNN) vs CPU from the trained weights: (i) "
          f"smooth stand-in: loss {ls!r} vs {lhs!r} (relative "
          f"{abs(ls - lhs) / abs(lhs):.2e}, tol 1e-5), worst gradient L2 "
          f"{smooth[1]:.2e} ({smooth[0]}; tol {TOL_PARITY}); (ii) leaky "
          f"ReLU against the float64 network on each side's branches: card "
          f"{card64[1]:.2e} ({card64[0]}), CPU {cpu64[1]:.2e} "
          f"({cpu64[0]}), ratio {ratio:.3f} (tol {K_F64}); loss {lc!r} vs "
          f"{lh!r}; exact zeros met by the activations (where the "
          f"gradient is 1): card {r['zeros']['card']}, CPU "
          f"{r['zeros']['cpu']}, float64 {r['zeros']['f64']}; on float64's "
          f"own branches (card {r['flips']['card']}, CPU "
          f"{r['flips']['cpu']} branches differ): card {own[0][1]:.2e} "
          f"({own[0][0]}), CPU {own[1][1]:.2e} ({own[1][0]}); card vs CPU "
          f"directly (formerly held at {TOL_PARITY}) {direct[1]:.2e} "
          f"({direct[0]}); negative control, the card's slope 0.1: ratio "
          f"{control:.1f}, fails (ii) as it must; no FD kernel (the path "
          f"has none)", flush=True)


def make_mov_dataset(root: str, path: LatentPath) -> tuple[str, np.ndarray]:
    """A learnable moving-source set under config #4's published manifest:
    128x96x2 velocity, the curl of a Gaussian stream-function blob whose x
    position follows a seeded smooth random walk in [0.2, 0.8] (knots every
    40 frames, as ``datagen.scenes.smoke_mov`` draws it) and which rises
    with the frame; the first ``path.frames`` frames of ``path.scenes``
    scenes.  Returns the data dir and scene 0's walk over all
    ``path.num_frames`` frames."""
    from deepfluids_tpu_torch.data import Manifest, save_manifest

    h, w = path.resolution
    ds = os.path.join(root, "train_data_mov", path.dataset)
    os.makedirs(os.path.join(ds, "v"))
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, w / h, w),
                         indexing="ij")
    rng = np.random.default_rng(4)
    knots = max(path.num_frames // 40, 2)
    r = 0.21
    vmax, walks = 0.0, []
    for s in range(path.scenes):
        walk = np.interp(np.linspace(0, knots - 1, path.num_frames),
                         np.arange(knots), rng.uniform(0.2, 0.8, knots))
        walks.append(walk)
        for f in range(path.frames):
            cy = 0.15 + 0.7 * f / (path.frames - 1)
            psi = np.exp(-((xx - 0.75 * walk[f]) ** 2 + (yy - cy) ** 2)
                         / (2 * r * r))
            u = np.diff(psi, axis=0, append=psi[-1:]) * h
            v = -np.diff(psi, axis=1, append=psi[:, -1:]) * w
            x = np.stack([u, v], -1).astype(np.float32)
            vmax = max(vmax, float(np.abs(x).max()))
            np.savez(os.path.join(ds, "v", f"{s}_{f}.npz"), x=x,
                     y=np.array([walk[f], f], np.float32))
    save_manifest(Manifest(
        param_names=["src_x_pos", "frame"],
        param_ranges=[list(r) for r in path.param_ranges],
        num_scenes=path.num_scenes, num_frames=path.num_frames,
        resolution=list(path.resolution), num_channels=2,
        v_range=[-vmax, vmax], data_type="velocity"), ds)
    return os.path.dirname(ds), walks[0]


def _drive(device, argv: list[str], want: dict, what: str):
    """``main`` on ``argv`` from launch counts at 0; (result, seconds,
    launches), which must be ``want``."""
    import torch

    from deepfluids_tpu_torch.config import get_config
    from deepfluids_tpu_torch.main import main
    from deepfluids_tpu_torch.ops import cuda_fd

    cuda_fd.reset_launch_counts()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    result = main(get_config(argv), device=device)
    torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    launches = dict(cuda_fd.launch_counts)
    if launches != want:
        raise AssertionError(f"{what} launched {launches}, want {want}")
    return result, secs, launches


def _falls(rows: list[dict], upto: int, what: str) -> tuple[float, float]:
    """(first, step ``upto``) losses of ``metrics.jsonl`` rows; the loss
    must be finite and fall."""
    losses = [r["loss"] for r in rows]
    first = rows[0]["loss"]
    last = next(r["loss"] for r in rows if r["step"] == upto)
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"{what} loss did not fall: {losses}")
    return first, last


def phase_train_mov(device, root: str, path: LatentPath) -> dict:
    """Config #4 through ``main`` at full width: train the AE (streaming,
    then resumed with the device cache), encode the set, train the latent
    integrator on the codes (and resume it), and roll out a scene through
    the AE's decoder; the decoded batch against the plain ops."""
    import torch

    from deepfluids_tpu_torch.config import load_config
    from deepfluids_tpu_torch.data import load_manifest
    from deepfluids_tpu_torch.models import LatentIntegrator, load_flax_npz
    from deepfluids_tpu_torch.models import rollout as latent_rollout
    from deepfluids_tpu_torch.train.trainer import Trainer
    from deepfluids_tpu_torch.utils.parity import normalized_l2

    t0 = time.perf_counter()
    data_dir, walk = make_mov_dataset(root, path)
    data_s = time.perf_counter() - t0
    logs = os.path.join(root, "logs")
    common = ["--data_dir", data_dir, "--dataset", path.dataset,
              "--log_dir", logs, "--batch_size", "8",
              "--log_step", str(path.log_step),
              "--save_step", str(path.save_step),
              "--test_step", str(path.save_step), "--num_worker", "4",
              "--z_num", str(path.z_num)]
    ae_flags = (["--is_train", "True", "--arch", "ae", "--tag", "chip_ae",
                 "--compute_dtype", "bfloat16",
                 "--filters", str(FLAGSHIP["filters"]),
                 "--num_conv", str(FLAGSHIP["num_conv"])] + common)
    nn_flags = (["--is_train", "True", "--arch", "nn", "--tag", "chip_nn",
                 "--w_num", str(path.w_num)] + common)
    ae_run = os.path.join(logs, f"{path.dataset}_chip_ae")
    nn_run = os.path.join(logs, f"{path.dataset}_chip_nn")
    n0, n1, save = path.ae_steps, path.ae_resume, path.save_step
    none = expected_launches({})

    # The AE: train streaming, then resume with --device_data_cache; every
    # step launches the step kernels, every sample dump the curl.
    ae_runs = []
    for argv, steps, dumps in (
            (ae_flags + ["--max_step", str(n0)], n0, n0 // save),
            (ae_flags + ["--max_step", str(n1), "--load_path", ae_run,
                         "--device_data_cache", "true"],
             n1 - n0, n1 // save - n0 // save)):
        want = expected_launches({
            k: steps * n + dumps * path.forward_launches.get(k, 0)
            for k, n in path.step_launches.items()})
        with step_log() as seen:
            _, secs, launches = _drive(device, argv, want, "AE training")
        ae_runs.append({"secs": secs, "launches": launches, "steps": steps,
                        "graph": graph_taken(seen, "AE training")})
    rows = _metrics(ae_run)
    if [r["step"] for r in rows] != list(range(path.log_step, n1 + 1,
                                               path.log_step)):
        raise AssertionError(f"AE metrics steps {[r['step'] for r in rows]}")
    ae_loss = _falls(rows, n0, "AE") + (rows[-1]["loss"],)
    saves = list(range(save, n1 + 1, save))
    samples = sorted(os.listdir(os.path.join(ae_run, "sample")))
    if samples != [f"{s:07d}.png" for s in saves]:
        raise AssertionError(f"AE sample PNGs {samples}")
    ae_rate = {"stream": rows[n0 // path.log_step - 1]["steps_per_sec"],
               "cache": rows[-1]["steps_per_sec"]}

    # The encode pass: one code file a scene, no FD kernel.
    result, enc_s, enc_launches = _drive(
        device, ["--is_train", "False", "--load_path", ae_run], none,
        "the encode pass")
    codes = sorted(glob.glob(os.path.join(result["code_dir"], "*.npz")))
    if len(codes) != path.scenes:
        raise AssertionError(f"{len(codes)} code files, {path.scenes} "
                             f"wanted")
    for f in codes:
        with np.load(f) as d:
            if (d["z"].shape != (path.frames, path.z_num)
                    or d["p"].shape != (path.frames, 2)
                    or not np.isfinite(d["z"]).all()):
                raise AssertionError(f"bad code file {f}")

    # The integrator: train on the codes, resume; no FD kernel.
    nn_runs = []
    for argv, steps in (
            (nn_flags + ["--max_step", str(path.nn_steps)], path.nn_steps),
            (nn_flags + ["--max_step", str(path.nn_resume),
                         "--load_path", nn_run],
             path.nn_resume - path.nn_steps)):
        _, secs, launches = _drive(device, argv, none, "integrator training")
        nn_runs.append({"secs": secs, "launches": launches, "steps": steps})
    rows = _metrics(nn_run)
    if rows[-1]["step"] != path.nn_resume:
        raise AssertionError(f"integrator metrics {rows[-1]}")
    nn_loss = _falls(rows, path.nn_steps, "integrator") + (rows[-1]["loss"],)

    # The rollout of scene 0 over its frames, decoded by the AE: the curl
    # once a decoded batch (--test_batch_size 32), nothing else.  Under
    # deterministic cuDNN, so the recomputation below runs the same convs.
    batches = -(-path.frames // 32)
    torch.backends.cudnn.deterministic = True
    result, roll_s, roll_launches = _drive(
        device, ["--is_train", "False", "--load_path", nn_run,
                 "--ae_load_path", ae_run],
        expected_launches({k: batches * n for k, n in
                           path.forward_launches.items()}), "the rollout")
    out = os.path.join(nn_run, "test")
    with np.load(os.path.join(out, "rollout.npz")) as d:
        x, z = d["x"], d["z"]
    if (x.shape != (path.frames,) + tuple(path.resolution) + (2,)
            or not np.isfinite(x).all() or z.shape != (path.frames, 1,
                                                        path.z_num)
            or not os.path.exists(os.path.join(out, "rollout.gif"))
            or "rollout_field_l2" not in result):
        raise AssertionError(f"rollout artifacts: x {x.shape}, z {z.shape}, "
                             f"{sorted(result)}")
    # The rollout again: the latent steps on the card from the first code,
    # and its first decoded batch through the plain ops.
    manifest = load_manifest(os.path.join(data_dir, path.dataset))
    ae = Trainer(load_config(ae_run), run_dir=ae_run, device=device,
                 save_cfg=False)
    ae.restore_weights()
    nn_model = LatentIntegrator(path.z_num, 2, hidden=512, depth=2)
    load_flax_npz(os.path.join(nn_run, "weights.npz"), nn_model)
    nn_model.to(device)
    with np.load(codes[0]) as d:
        z0, p = d["z"][:1], manifest.normalize_params(d["p"])
    with torch.inference_mode(), plain_fd_ops():
        z_ref = latent_rollout(
            nn_model, torch.from_numpy(z0).to(device),
            torch.from_numpy(p[:, None].astype(np.float32)).to(device), 2)
        ref = manifest.denormalize_field(ae.apply_decode(
            torch.from_numpy(z[:32, 0]).to(device)).float().cpu().numpy())
    torch.backends.cudnn.deterministic = False
    z_err = float(np.abs(z_ref.cpu().numpy() - z).max())
    l2 = normalized_l2(x[:32], ref)
    if not (z_err <= 1e-5 and l2 < TOL_PARITY):
        raise AssertionError(f"rollout vs recomputation: codes {z_err}, "
                             f"fields L2 {l2}")
    drift = result["rollout_field_l2"]
    print(f"phase 7 config #4 path MOV: ok  main() on {path.scenes} x "
          f"{path.frames} synthetic frames of "
          f"{'x'.join(map(str, path.resolution))}x2 (of the published "
          f"{path.num_scenes} x {path.num_frames}, cut for the time limit; "
          f"made in {data_s:.2f} s): AE (filters {FLAGSHIP['filters']}, "
          f"num_conv {FLAGSHIP['num_conv']}, z_num {path.z_num}, bf16, "
          f"batch 8) {n0} steps streaming in {ae_runs[0]['secs']:.2f} s, "
          f"resumed with --device_data_cache to {n1} in "
          f"{ae_runs[1]['secs']:.2f} s, loss {ae_loss[0]:.4f} -> "
          f"{ae_loss[1]:.4f} -> {ae_loss[2]:.4f}, launches exactly "
          f"{path.step_launches} a step + {path.forward_launches} a sample "
          f"dump (train step path: CUDA graph, {ae_runs[0]['graph']}), "
          f"sample PNGs {samples}; encode pass {len(codes)} code "
          f"files of [{path.frames}, {path.z_num}] in {enc_s:.2f} s, no FD "
          f"kernel; integrator (nn_hidden 512, nn_depth 2, w_num "
          f"{path.w_num}, batch 8) {path.nn_steps} steps in "
          f"{nn_runs[0]['secs']:.2f} s, resumed to {path.nn_resume} in "
          f"{nn_runs[1]['secs']:.2f} s, loss {nn_loss[0]:.5f} -> "
          f"{nn_loss[1]:.5f} -> {nn_loss[2]:.5f}, no FD kernel; rollout of "
          f"{path.frames} frames in {roll_s:.2f} s, curl2d_fused "
          f"{roll_launches['curl2d_fused']} = {batches} decoded batches; "
          f"rollout_field_l2 median {drift['l2_median']} (first quarter "
          f"{drift['l2_firstq_median']}, last {drift['l2_lastq_median']}); "
          f"recomputed codes max abs err {z_err:.2e}, first batch vs plain "
          f"ops L2 {l2:.2e}", flush=True)
    return {"run": ae_run, "nn_run": nn_run, "walk": walk,
            "data_dir": data_dir, "rollout": result,
            "ae_runs": ae_runs, "nn_runs": nn_runs,
            "serving": [enc_launches, roll_launches],
            "ae_steps_per_sec": ae_rate, "encode_s": enc_s,
            "rollout_s": roll_s}


def phase_mov_timing(device, mov: dict, card: str, path: LatentPath) -> dict:
    """Config #4's timings (printed only): the AE train step at batch 8,
    kernels against plain ops; the AE's end-to-end steps/s; the encode
    pass; the integrator step; a rollout over the published scene length,
    decode included; a profile line for each."""
    import torch

    from deepfluids_tpu_torch.config import load_config
    from deepfluids_tpu_torch.infer import rollout_trajectory
    from deepfluids_tpu_torch.train.trainer import Trainer

    ae = Trainer(load_config(mov["run"]), run_dir=mov["run"], device=device,
                 save_cfg=False)
    ae.restore_weights()
    cx, cy = ae._load_device_cache()
    x, y = cx[:8].float(), cy[:8]

    def plain_step():
        with plain_fd_ops():
            ae._train_step(x, y)

    kern, plain, runs = alternated(plain_step, lambda: ae._train_step(x, y),
                                   20)
    print(f"phase 5 timing [{card}]: MOV AE train step (fwd+bwd+Adam) "
          f"flagship bf16 batch 8: kernels {kern:.3f} ms ({1e3 / kern:.1f} "
          f"steps/s), plain ops {plain:.3f} ms (p {runs[0]:.3f} k "
          f"{runs[1]:.3f} k {runs[2]:.3f} p {runs[3]:.3f}); end to end "
          f"(metrics.jsonl) streaming {mov['ae_steps_per_sec']['stream']}, "
          f"device cache {mov['ae_steps_per_sec']['cache']} steps/s",
          flush=True)
    n_fields = path.scenes * path.frames
    xb = cx[:32].float()
    with torch.inference_mode():
        enc_ms = cuda_ms(lambda: ae.model.encode(xb), 20)
    print(f"phase 5 timing [{card}]: MOV encode pass {n_fields} fields in "
          f"{mov['encode_s']:.2f} s = {n_fields / mov['encode_s']:.1f} "
          f"fields/s end to end (main(), .npz reads and code writes "
          f"included); encoder alone at batch 32 {enc_ms:.3f} ms = "
          f"{32e3 / enc_ms:.1f} fields/s", flush=True)

    nn = Trainer(load_config(mov["nn_run"]), run_dir=mov["nn_run"],
                 device=device, save_cfg=False)
    nn.restore_weights()
    z, p = (torch.from_numpy(a).to(device)
            for a in nn.codes.window_batch(8, path.w_num, step=1))
    nn_ms = cuda_ms(lambda: nn._train_step(z, p), 20)
    print(f"phase 5 timing [{card}]: MOV integrator train step (rollout of "
          f"w_num {path.w_num}, bwd, Adam) batch 8: {nn_ms:.3f} ms "
          f"({1e3 / nn_ms:.1f} steps/s)", flush=True)

    # A rollout over the published scene length from scene 0's first code,
    # on scene 0's whole walk (the synthetic scenes hold fewer frames).
    t = path.num_frames
    raw_p = np.stack([mov["walk"], np.arange(t)], 1).astype(np.float32)

    def roll():
        return rollout_trajectory(nn.model, ae.apply_decode,
                                  nn.codes.z[0][:1], raw_p, ae.manifest,
                                  decode_batch=32, device=device)

    roll()
    t0 = time.perf_counter()
    _, fields = roll()
    roll_s = time.perf_counter() - t0
    if fields.shape[0] != t or not np.isfinite(fields).all():
        raise AssertionError(f"400-frame rollout: {fields.shape}")
    print(f"phase 5 timing [{card}]: MOV rollout of {t} frames (the "
          f"published scene length; latent steps, decode in batches of 32, "
          f"fields back to the host): {roll_s * 1e3:.1f} ms = "
          f"{t / roll_s:.1f} frames/s", flush=True)
    try:
        profile_line(f"MOV AE train step batch 8 bf16 [{card}]",
                     lambda: ae._train_step(x, y), kern)
        with torch.inference_mode():
            profile_line(f"MOV encoder batch 32 bf16 [{card}]",
                         lambda: ae.model.encode(xb), enc_ms)
        profile_line(f"MOV integrator train step w_num {path.w_num} batch 8 "
                     f"[{card}]", lambda: nn._train_step(z, p), nn_ms)
        profile_line(f"MOV rollout {t} frames [{card}]", roll,
                     roll_s * 1e3, iters=1)
    except Exception as e:  # noqa: BLE001 - diagnostics only
        print(f"profile MOV: not measured ({type(e).__name__}: {e})")
    return {"ae_step_ms": kern, "nn_step_ms": nn_ms, "rollout_s": roll_s}


def phase_timing(device, weights: str, card: str, path: MainPath,
                 batches: tuple[int, ...], iters: int,
                 kernel_batches: tuple[int, ...]) -> dict:
    """Generator + curl at each of ``batches`` (the first timed against the
    plain curl and alone); the curl kernel alone at each of
    ``kernel_batches``, f32 and bf16, against its plain version."""
    import torch

    from deepfluids_tpu_torch.models import load_flax_npz
    from deepfluids_tpu_torch.train.losses import apply_curl

    model = flagship_model(path)
    load_flax_npz(weights, model)
    model.to(device)
    gen = torch.Generator(device=device).manual_seed(1)
    curl = next(iter(path.forward_launches))
    kernel, plain = apply_curl, plain_version(curl)
    grid = "x".join(map(str, path.resolution))
    out = {"curl": {}, "gen_curl_ms": {}}
    with torch.inference_mode():
        for k, b in enumerate(batches):
            p = torch.rand((b, 3), generator=gen, device=device) * 2 - 1
            if k == 0:
                ms, plain_ms, runs = alternated(
                    lambda: plain(model(p)), lambda: kernel(model(p)), iters)
                gen_only = cuda_ms(lambda: model(p), iters)
                out.update(fields_per_s=b / (ms / 1e3),
                           fields_per_s_plain_curl=b / (plain_ms / 1e3),
                           generator_ms=gen_only, batch=b)
                print(f"phase 5 timing [{card}]: GeneratorBE {grid} f"
                      f"{FLAGSHIP['filters']} c{FLAGSHIP['num_conv']} bf16 "
                      f"batch {b}: generator {gen_only:.3f} ms, +curl "
                      f"kernel {ms:.3f} ms = {out['fields_per_s']:.1f} "
                      f"fields/s, +plain curl {plain_ms:.3f} ms = "
                      f"{out['fields_per_s_plain_curl']:.1f} fields/s (p "
                      f"{runs[0]:.3f} k {runs[1]:.3f} k {runs[2]:.3f} p "
                      f"{runs[3]:.3f})", flush=True)
            else:
                ms = cuda_ms(lambda: kernel(model(p)), iters)
                print(f"phase 5 timing [{card}]: GeneratorBE {grid} batch "
                      f"{b} generator+curl kernel {ms:.3f} ms = "
                      f"{b / (ms / 1e3):.1f} fields/s", flush=True)
            out["gen_curl_ms"][b] = ms
    out["curl"] = kernel_timing(device, card, [curl], kernel_batches, path,
                                seed=3)
    return out


def kernel_bound(name: str, shape: tuple, dtype,
                 channels: int) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take
    for kernel ``name`` on ``shape`` (batch + spatial), moving ``channels``
    a point: each input read and each output written once at the HBM rate,
    or its f32 operations at the f32 peak, whichever is longer."""
    import torch

    points = math.prod(shape)
    elt = 4 if dtype == torch.float32 else 2
    by_bytes = points * channels * elt / HBM_BYTES_PER_S * 1e3
    by_ops = points * FLOPS_PER_POINT[name] / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def device_ms(calls: dict, iters: int) -> dict:
    """Device time per call of each of ``calls`` (label -> function), from
    the profiler's kernel rows: every kernel a call launches, no host time.
    The labels run in turns, first to last and back (plain, kernel,
    kernel, plain), ``iters`` calls each, in one profiled window; a
    label's rows are told apart by its own CUDA kernels' names, and the
    label "plain" takes every other row."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    order = list(calls) + list(calls)[::-1]
    for label in order:
        calls[label]()
    torch.cuda.synchronize()
    # Every kernel row must count a whole number of calls (2 * iters, or a
    # multiple for a plain version's kernels).  Late in a run, windows lost
    # one record each of a plain version's kernel (5 of 5 windows, in two
    # runs), probably the window's first: each window now opens with a
    # sentinel kernel that is not counted.  A window where a row lost more
    # than one record and more than 1 % of them (one read 0.0131 ms for a
    # kernel whose events time was 0.0392 ms, and half its plain version's
    # time) is measured again; a row short of fewer counts its whole
    # launches at the mean of the records it kept.
    # A window can also come back with no kernel row at all (the first
    # window of a run on the card, once in several runs): a label without
    # device time is measured again too.  If five windows fail, each label
    # is timed with CUDA events instead, in the same turns, and the line
    # says so.
    calls_per_row = 2 * iters
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for label in order:
                for _ in range(iters):
                    calls[label]()
            torch.cuda.synchronize()
        rows = [(ev, max(1, round(ev.count / calls_per_row)) * calls_per_row)
                for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA
                and SENTINEL_KERNEL not in ev.key]
        total = dict.fromkeys(calls, 0.0)
        for ev, want in rows:
            label = next((k for k in calls if k != "plain" and k in ev.key),
                         "plain")
            total[label] += ev.self_device_time_total * want / max(1,
                                                                   ev.count)
        if all(abs(ev.count - want) <= max(1, 0.01 * want)
               for ev, want in rows) and all(v > 0 for v in total.values()):
            return {k: v / calls_per_row / 1e3 for k, v in total.items()}
    lost = ", ".join(f"{ev.key[:40]} x{ev.count} of {want}"
                     for ev, want in rows) or "no kernel row"
    runs = {k: [] for k in calls}
    for label in order:
        runs[label].append(cuda_ms(calls[label], iters))
    print(f"device_ms: the profiler lost kernel records in five windows "
          f"({lost}); timed with CUDA events, the host's launch included",
          flush=True)
    return {k: min(v) for k, v in runs.items()}


def compiled_version(name: str, xs: list):
    """``torch.compile(plain_version(name), dynamic=False)``, compiled and
    checked on ``xs`` before any timing: its outputs within TOL_KERNEL
    (forwards) or TOL_GRAD (transposes) of the plain version's, and every
    kernel it launches one of inductor's (``COMPILED_LABEL``), so that a
    profiled window tells its rows from the plain version's.  (the
    function, seconds to compile, max abs error)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    plain = plain_version(name)
    fn = torch.compile(plain, dynamic=False)
    t0 = time.perf_counter()
    got = fn(*xs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    want = plain(*xs)
    pairs = (zip(got, want) if isinstance(want, tuple)
             else [(got, want)])
    err = max(float((g - w).abs().max()) for g, w in pairs)
    tol = TOL_GRAD if "bwd" in name else TOL_KERNEL
    if not err <= tol:
        raise AssertionError(f"torch.compile of {name}'s plain version is "
                             f"{err} from it (tol {tol})")
    # A window may lose its first kernel records (device_ms): it opens
    # with the sentinel, and the function runs a few times.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(3):
                fn(*xs)
            torch.cuda.synchronize()
        kernels = {ev.key for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and SENTINEL_KERNEL not in ev.key}
        if kernels:
            break
    if not kernels or any(COMPILED_LABEL not in k for k in kernels):
        raise AssertionError(f"torch.compile of {name}'s plain version "
                             f"launched {sorted(kernels)}: only inductor's "
                             f"{COMPILED_LABEL}* kernels can be told from the "
                             "plain version's in a window")
    return fn, secs, err


def kernel_timing(device, card: str, names: list[str],
                  batches: tuple[int, ...], path: MainPath,
                  seed: int) -> dict:
    """Each kernel alone at ``[b, *resolution, .]`` for each batch, f32 and
    bf16, against its plain version: device time from the profiler, inputs
    cold (a ring of input sets of RING_BYTES), and the kernel's bound.
    The jacobians' transposes also without the vorticity's cotangent, as
    the training loss calls them.  At the timed batch (the first of
    ``batches``), f32, the plain version under ``torch.compile`` joins the
    same window."""
    import torch

    from deepfluids_tpu_torch.ops import cuda_fd

    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name in names:
        fn, plain = getattr(cuda_fd, name), plain_version(name)
        # (label, kernel, plain version, input channels, channels moved)
        variants = [("", fn, plain, KERNELS[name][2], CHANNELS_MOVED[name])]
        if name in NO_VORT:
            cj, cw = NO_VORT[name]
            variants.append((
                " without vort", lambda gj, fn=fn: fn(gj, None),
                lambda gj, plain=plain, cw=cw: plain(
                    gj, gj.new_zeros(gj.shape[:-1] + (cw,))),
                [cj], CHANNELS_MOVED[name] - cw))
        # The kernel's CUDA function, as the profiler names it.
        cuda_name = name.replace("_fused", "") + "_kernel"
        for b in batches:
            shape = (b,) + tuple(path.resolution)
            for dtype in (torch.float32, torch.bfloat16):
                elt = 4 if dtype == torch.float32 else 2
                for what, kern_fn, plain_fn, chans, moved in variants:
                    n = max(2, -(-RING_BYTES // (math.prod(shape)
                                                 * sum(chans) * elt)))
                    ring = [[torch.randn(shape + (c,), generator=gen,
                                         device=device).to(dtype)
                             for c in chans] for _ in range(n)]
                    turn = {"plain": 0, cuda_name: 0, COMPILED_LABEL: 0}

                    def call(label, f):
                        def run():
                            f(*ring[turn[label] % n])
                            turn[label] += 1
                        return run

                    compiled = (b == batches[0] and dtype == torch.float32
                                and not what)
                    with torch.inference_mode():
                        calls = {"plain": call("plain", plain_fn),
                                 cuda_name: call(cuda_name, kern_fn)}
                        if compiled:
                            cfn, c_secs, c_err = compiled_version(name,
                                                                  ring[0])
                            calls[COMPILED_LABEL] = call(COMPILED_LABEL, cfn)
                        ms = device_ms(calls, iters=20)
                        wall = cuda_ms(call(cuda_name, kern_fn), 20)
                    kern, pl = ms[cuda_name], ms["plain"]
                    bound, by = kernel_bound(name, shape, dtype, moved)
                    out[(name + what, b, dtype)] = {
                        "ms": kern, "plain_ms": pl, "bound_ms": bound,
                        "bound_by": by}
                    if compiled:
                        c_ms = ms[COMPILED_LABEL]
                        out[(name, b, dtype)]["compiled_ms"] = c_ms
                        print(f"phase 5 timing [{card}]: {name} "
                              f"[{','.join(map(str, shape))}] f32 under "
                              f"torch.compile(dynamic=False): {c_ms:.4f} ms "
                              f"device (compiled in {c_secs:.1f} s, max abs "
                              f"err {c_err:.2e} from the plain version); "
                              f"kernel / compiled {kern / c_ms:.2f}",
                              flush=True)
                    print(f"phase 5 timing [{card}]: {name}{what} "
                          f"[{','.join(map(str, shape))}] {dtype}: kernel "
                          f"{kern:.4f} ms device "
                          f"({math.prod(shape) * moved * elt / kern / 1e6:.0f}"
                          f" GB/s, "
                          f"{bound / kern:.2f} of its {bound:.4f} ms bound "
                          f"by {by}), plain {pl:.4f} ms device; kernel "
                          f"{wall:.4f} ms a call with the host's launch "
                          f"(cold: a ring of {n} input sets, "
                          f"{n * math.prod(shape) * sum(chans) * elt >> 20}"
                          f" MB)", flush=True)
                    del ring
    if 1 in batches:
        # The floor: a launch at [1, *resolution] moves next to nothing, so
        # no kernel body at a larger batch can take less than its time.
        for (name, b, dtype), t in out.items():
            floor = out[(name, 1, dtype)]["ms"]
            if b != 1:
                print(f"phase 5 timing [{card}]: {name} batch {b} {dtype}: "
                      f"{t['bound_ms'] / t['ms']:.2f} of its bound, "
                      f"{max(t['bound_ms'], floor) / t['ms']:.2f} of max("
                      f"bound, the batch-1 floor {floor:.4f} ms)", flush=True)
    return out


def phase_train_timing(device, train: dict, card: str, path: MainPath,
                       batches: tuple[int, ...], kernels: list[str],
                       kernel_batches: tuple[int, ...]) -> dict:
    """Device ms of a train step (forward, backward, Adam), bf16, at each
    of ``batches``, through the kernels and through the plain ops; each of
    ``kernels`` alone against its plain version."""
    from deepfluids_tpu_torch.config import load_config
    from deepfluids_tpu_torch.train.trainer import Trainer

    cfg = load_config(train["run"])
    t = Trainer(cfg, run_dir=train["run"], device=device, save_cfg=False)
    cx, cy = t._load_device_cache()
    step_ms = {}
    for b in batches:
        x, y = cx[:b].float(), cy[:b]

        def plain_step():
            with plain_fd_ops():
                t._train_step(x, y)

        iters = 20 if b == 8 and path.potential == 1 else 10
        step_ms[b] = alternated(plain_step, lambda: t._train_step(x, y),
                                iters)
        kern, plain, runs = step_ms[b]
        print(f"phase 5 timing [{card}]: {path.name.upper()} train step "
              f"(fwd+bwd+Adam) flagship bf16 batch {b}: kernels {kern:.3f} "
              f"ms ({1e3 / kern:.1f} steps/s device), plain ops {plain:.3f} "
              f"ms (p {runs[0]:.3f} k {runs[1]:.3f} k {runs[2]:.3f} p "
              f"{runs[3]:.3f})", flush=True)
    print(f"phase 5 timing [{card}]: {path.name.upper()} train steps/s end "
          f"to end (metrics.jsonl, incl. host batches, logging, sample "
          f"dumps, checkpoints): streaming {train['steps_per_sec']['stream']}"
          f", device cache {train['steps_per_sec']['cache']}", flush=True)
    kern_ms = kernel_timing(device, card, kernels, kernel_batches, path,
                            seed=2)
    return {"step_ms": step_ms, "kernel_ms": kern_ms, "trainer": t}


def profile_line(what: str, fn, wall_ms: float, iters: int = 3) -> float:
    """Print device time by kernel of ``iters`` calls of ``fn``, the
    kernels a call launches and the idle share against ``wall_ms`` per
    call; returns the launches a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    # Kernel rows only: operator rows repeat their kernels' device time,
    # and a user annotation's device row (e.g. the optimizer step's) spans
    # the kernels inside it.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    rows = sorted(((e.self_device_time_total / iters / 1e3, e.key)
                   for e in events), reverse=True)
    launches = sum(e.count for e in events) / iters
    total = sum(r[0] for r in rows)
    top = "; ".join(f"{name[:60]} {ms:.3f} ms" for ms, name in rows[:8])
    fd_rows = "; ".join(f"{name[:40]} {ms:.4f} ms" for ms, name in rows
                        if "curl" in name or "jacobian" in name)
    print(f"profile {what}: kernels {total:.3f} ms/iter of {wall_ms:.3f} ms "
          f"wall (idle share {1 - total / wall_ms:.3f}), {launches:.0f} "
          f"kernel launches/iter; by kernel: {top}; FD kernels: "
          f"{fd_rows or 'none'}", flush=True)
    return launches


def profiles(device, serving: dict, timing: dict, train_timing: dict,
             train: dict, card: str) -> None:
    """Profile lines of 2D serving (batch 512), of a batch-8 train step of
    each path and of the 2D batch-8 step on the grain stream (its batch
    taken from the stream and copied to the card in the step); diagnostics
    only, the phases decide ok."""
    import torch

    from deepfluids_tpu_torch.config import load_config
    from deepfluids_tpu_torch.models import load_flax_npz
    from deepfluids_tpu_torch.train.losses import apply_curl
    from deepfluids_tpu_torch.train.trainer import Trainer

    try:
        model = flagship_model(PATH_2D)
        load_flax_npz(serving[PATH_2D.name]["weights"], model)
        model.to(device)
        p = torch.zeros((512, 3), device=device)
        with torch.inference_mode():
            profile_line(f"2D batch 512 fwd+curl [{card}]",
                         lambda: apply_curl(model(p)),
                         timing[PATH_2D.name]["gen_curl_ms"][512])
        for path in (PATH_2D, PATH_3D):
            tt = train_timing[path.name]
            t = tt["trainer"]
            x, y = t._load_device_cache()
            x, y = x[:8].float(), y[:8]
            profile_line(f"{path.name.upper()} train step batch 8 bf16 "
                         f"[{card}]", lambda: t._train_step(x, y),
                         tt["step_ms"][8][0])
    except Exception as e:  # noqa: BLE001
        print(f"profile: not measured ({type(e).__name__}: {e})")
    try:
        run = train[PATH_2D.name]["grain"]["run"]
        t = Trainer(load_config(run), run_dir=run, device=device,
                    save_cfg=False)
        block = t._chunk_blocks(10 ** 6, 0, 1)
        try:
            def grain_step():
                b = block(t.step)
                t._train_step(b["x"][0].to(device, non_blocking=True),
                              b["y"][0].to(device, non_blocking=True))

            # events around the steps: the card's idle gaps count
            profile_line(f"2D grain train step batch 8 bf16 (4 workers) "
                         f"[{card}]", grain_step, cuda_ms(grain_step, 20))
        finally:
            t._stream.close()
    except Exception as e:  # noqa: BLE001
        print(f"profile: not measured ({type(e).__name__}: {e})")


# The keys of the line the repo root's bench.py prints, in its order: the
# port's bench (python -m deepfluids_tpu_torch.bench) prints exactly these,
# and the same metric.
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "vs_baseline_pinned",
              "cpu_rate_pinned", "device_rate", "cpu_rate_median",
              "cpu_rates", "loadavg_1m"]
BENCH_METRIC = "2d_velocity_fields_per_sec_per_chip"
# The bench's device rate, at least, as a share of phase 5's batch-512
# serving rate in this process: less means a sync a batch or the plain curl.
BENCH_MIN_SHARE = 0.8


def phase_entry(device, card: str, serving_rate: float) -> dict:
    """Phase 13, the repo root's entry points: ``graft_entry.entry()`` on the
    card, its forward at the entry's own ``p`` and at a batch of 512, one
    curl launch a call, against the plain curl on the very stream function
    it took (f32, and the same forward on a bf16 one); ``bench``'s
    ``run_device_bench`` here, its launches counted; and the whole ``python
    -m deepfluids_tpu_torch.bench`` in a subprocess: its line's keys and
    metric, and both device rates at least ``BENCH_MIN_SHARE`` of
    ``serving_rate``."""
    import torch

    from deepfluids_tpu_torch import bench, graft_entry
    from deepfluids_tpu_torch.ops import cuda_fd

    fn, (model, p0) = graft_entry.entry()
    if p0.device != device or next(model.parameters()).device != device:
        raise AssertionError(f"entry() is not on {device}: {p0.device}")
    gen = torch.Generator(device=device).manual_seed(13)
    ps = [p0, torch.rand((512, 3), generator=gen, device=device) * 2 - 1]
    shapes, out = set(), {"launches": {}}
    cuda_fd.reset_launch_counts()
    with torch.inference_mode(), recording_kernel_shapes(shapes):
        us = [fn(model, p) for p in ps]
    torch.cuda.synchronize()
    out["launches"]["entry"] = dict(cuda_fd.launch_counts)
    want = expected_launches({"curl2d_fused": len(ps)})
    if out["launches"]["entry"] != want:
        raise AssertionError(f"entry's fn launched {out['launches']['entry']}"
                             f" in {len(ps)} calls, want {want}")
    if not shapes <= set(KERNEL_SHAPES[2]):
        raise AssertionError(f"entry gave the curl shapes phase 2 does not "
                             f"check: {shapes - set(KERNEL_SHAPES[2])}")
    for p, u in zip(ps, us):
        if u.shape != (p.shape[0], 128, 96, 2) or u.dtype != torch.float32:
            raise AssertionError(f"entry's fn gave {u.shape} {u.dtype}")
        if not bool(torch.isfinite(u).all()):
            raise AssertionError("entry's fn gave non-finite velocities")
    # The comparisons, at the batch of 512 (the entry's own p meets zero
    # biases, a zero field): fn against the plain curl on the stream
    # function the model handed it (a forward hook keeps it), then fn on
    # the same psi rounded to bf16.
    plain = plain_version("curl2d_fused")
    psis = []
    hook = model.register_forward_hook(lambda m, i, o: psis.append(o))
    try:
        err32 = check_kernel("curl2d_fused", lambda q: fn(model, q),
                             lambda q: plain(psis[-1]), [ps[1]], "entry f32")
    finally:
        hook.remove()
    psi16 = psis[-1].to(torch.bfloat16)
    err16 = check_kernel("curl2d_fused", lambda q: fn(lambda _: q, q), plain,
                         [psi16], "entry bf16")
    print(f"phase 13 entry [{card}]: graft_entry.entry() flagship bf16 on "
          f"{p0.device}, fn at batch {', '.join(str(p.shape[0]) for p in ps)}"
          f": finite, one curl2d_fused launch a call; against the plain "
          f"curl on the same psi at 512, max abs err f32 {err32:.3e}, bf16 "
          f"{err16:.3e} (bars {TOL_KERNEL:g}, one bf16 ulp)", flush=True)

    cuda_fd.reset_launch_counts()
    rate = bench.run_device_bench()
    torch.cuda.synchronize()
    out["launches"]["bench"] = dict(cuda_fd.launch_counts)
    want = expected_launches({"curl2d_fused": (bench.WARMUP + bench.ITERS)
                              * bench.CHUNKS})
    if out["launches"]["bench"] != want:
        raise AssertionError(f"run_device_bench launched "
                             f"{out['launches']['bench']}, want {want}")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deepfluids_tpu_torch.bench"], cwd=REPO,
        capture_output=True, text=True, timeout=900)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"python -m deepfluids_tpu_torch.bench exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    rec = json.loads(lines[-1])
    if len(lines) != 1 or list(rec) != BENCH_KEYS or (
            rec["metric"] != BENCH_METRIC) or not rec["value"] > 0:
        raise AssertionError(f"the bench printed {proc.stdout!r}, want one "
                             f"line of keys {BENCH_KEYS}, metric "
                             f"{BENCH_METRIC}, value > 0")
    floor = BENCH_MIN_SHARE * serving_rate
    for what, r in (("run_device_bench here", rate),
                    ("the bench's line", rec["value"])):
        if r < floor:
            raise AssertionError(
                f"{what}: {r:.1f} fields/s, below {BENCH_MIN_SHARE} x phase "
                f"5's batch-512 serving rate {serving_rate:.1f}")
    print(f"phase 13 bench [{card}]: run_device_bench here {rate:.1f} "
          f"fields/s ({rate / serving_rate:.4f} of phase 5's batch-512 "
          f"serving rate {serving_rate:.1f}; {bench.CHUNKS} x {bench.BATCH} "
          f"a call, one sync); python -m deepfluids_tpu_torch.bench in "
          f"{secs:.2f} s: {lines[-1]}", flush=True)
    out.update(rate=rate, line=rec)
    return out


def phase_sweep_on_device(device, serving: dict, timing: dict, card: str,
                          root: str) -> dict:
    """``sweep_on_device`` over the full 2D grid (21 x 5 x 200 = 21 000
    fields, 2.06 GB in f32) at batch 512 with the 2D serving run's flagship
    weights, timed twice; a batch copied back through its ring against
    ``sweep_generator`` on the same slice (deterministic cuDNN, so both
    run the same convolutions)."""
    import torch

    from deepfluids_tpu_torch.data import load_manifest
    from deepfluids_tpu_torch.infer import sweep
    from deepfluids_tpu_torch.infer.sweep import (
        param_grid,
        sweep_generator,
        sweep_on_device,
    )
    from deepfluids_tpu_torch.models import load_flax_npz
    from deepfluids_tpu_torch.ops import cuda_fd
    from deepfluids_tpu_torch.train.losses import apply_curl
    from deepfluids_tpu_torch.utils.parity import normalized_l2

    path = PATH_2D
    model = flagship_model(path)
    load_flax_npz(serving[path.name]["weights"], model)
    model.to(device)
    manifest = load_manifest(os.path.join(root, "data", path.dataset))
    raw = param_grid(manifest, path.param_counts, path.num_frames)
    bs = 512

    def apply_fn(p):
        return apply_curl(model(p))

    torch.backends.cudnn.deterministic = True
    secs, out = [], None
    for _ in range(2):
        out = None            # the first result's 2 GB go before the second
        cuda_fd.reset_launch_counts()
        before = dict(sweep.overlap_counts)
        t0 = time.perf_counter()
        out = sweep_on_device(apply_fn, manifest, raw, batch_size=bs,
                              device=device)
        secs.append(time.perf_counter() - t0)
        launches = dict(cuda_fd.launch_counts)
        overlap = {k: v - before[k] for k, v in sweep.overlap_counts.items()}
    n = len(raw)
    # A whole batch copied back through the ring.
    lo = bs * max(0, min(25, n // bs - 1))
    ref = np.concatenate(list(sweep_generator(
        apply_fn, manifest, raw[lo:lo + bs], batch_size=bs, device=device)))
    torch.backends.cudnn.deterministic = False
    # The grid in padded batches, the curl once a batch.
    batches = -(-n // bs)
    if (out.shape != (n,) + manifest.field_shape or out.dtype != np.float32
            or not np.isfinite(out).all()):
        raise AssertionError(f"sweep_on_device gave {out.shape} {out.dtype}")
    l2 = normalized_l2(out[lo:lo + bs], ref)
    if not (l2 < TOL_PARITY and launches == expected_launches(
            {"curl2d_fused": batches}) and sum(overlap.values()) == batches):
        raise AssertionError(f"sweep_on_device vs sweep_generator L2 {l2}, "
                             f"launches {launches}, want {batches} curls; "
                             f"ring copies {overlap}")
    rate = n / min(secs)
    device_rate = timing[path.name]["fields_per_s"]
    print(f"phase 8 sweep_on_device 2D: ok  the full {path.serve_counts} x "
          f"{path.num_frames} grid, {n} fields of 128x96x2 ({out.nbytes / 1e9:.2f} "
          f"GB f32) at batch {bs}, each batch copied back through a ring "
          f"of {sweep.RING_SLOTS} pinned batch slots into the output while "
          f"the card computes the next: {secs[0]:.3f} s / "
          f"{secs[1]:.3f} s = {rate:.1f} fields/s (phase 5's device rate of "
          f"generator + curl at batch 512: {device_rate:.1f} fields/s; "
          f"[{card}]); curl2d_fused {launches['curl2d_fused']} launches = "
          f"{batches} batches; ring copies {overlap['overlapped']} "
          f"overlapped, {overlap['exposed']} exposed; rows {lo}:{lo + bs} "
          f"vs sweep_generator L2 {l2:.2e} (tol {TOL_PARITY})", flush=True)
    return {"fields_per_s": rate, "secs": secs}


def phase_knobs3d(device) -> None:
    """One forward of config #5's generator (filters 128, num_conv 4) with
    every knob (Fourier embedding 8, spectral residuals 8, the grid decoder
    4 / 4 / 8), gains and bases drawn at random, curl applied, batch 2,
    f32, TF32 off: the card's fields against the same model's on the
    CPU."""
    import torch

    from deepfluids_tpu_torch.models import GeneratorBE, flax_init_
    from deepfluids_tpu_torch.ops import cuda_fd
    from deepfluids_tpu_torch.train.losses import apply_curl
    from deepfluids_tpu_torch.utils.parity import normalized_l2

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    path = PATH_3D
    model = flax_init_(GeneratorBE(
        tuple(path.resolution) + (3,), num_param=3, embed_bands=8,
        spectral_modes=8, grid_levels=4, grid_features=4, grid_rank=8,
        **FLAGSHIP), seed=5)
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if "gain_" in name or name.startswith("basis_"):
                prm.copy_(torch.randn(prm.shape, generator=gen) * 0.1)
    p = torch.rand((2, 3), generator=gen) * 2 - 1
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = apply_curl(model(p)).numpy()
    cpu_s = time.perf_counter() - t0
    model.to(device)
    cuda_fd.reset_launch_counts()
    with torch.inference_mode():
        got = apply_curl(model(p.to(device))).cpu().numpy()
    launches = {k: v for k, v in cuda_fd.launch_counts.items() if v}
    l2 = normalized_l2(got, ref)
    if not (l2 < TOL_PARITY and np.isfinite(got).all()
            and dict(cuda_fd.launch_counts) == expected_launches(
                {"curl3d_fused": 1})):
        raise AssertionError(f"3D knob forward card vs CPU: L2 {l2}, "
                             f"launches {launches}")
    print(f"phase 9 3D knobs forward: ok  GeneratorBE 32x64x112 f128 c4 with "
          f"--embed_bands 8 --spectral_modes 8 --decoder grid (4, 4, rank 8), "
          f"random gains and bases, {sum(q.numel() for q in model.parameters()) / 1e6:.2f}"
          f" M parameters, batch 2, f32, TF32 off, + curl3d kernel "
          f"(launches {launches}): card vs CPU fields L2 {l2:.2e} (tol "
          f"{TOL_PARITY}; the CPU forward took {cpu_s:.1f} s)", flush=True)


def phase_liquid_knob_timing(device, train: dict, serving: dict,
                             train_timing: dict, card: str) -> dict:
    """Config #3 and the knob path (printed only): the liquid train step at
    batch 8 and 64 with its idle share, liquid serving at batch 512, the
    knob step against the plain 2D "de" step at batch 8 and 64 with the
    kernels each launches, and the x-mirror's cost in a step; a profile
    line each."""
    import torch

    from deepfluids_tpu_torch.config import load_config
    from deepfluids_tpu_torch.models import load_flax_npz
    from deepfluids_tpu_torch.train.trainer import Trainer

    def trainer(name: str) -> Trainer:
        t = Trainer(load_config(train[name]["run"]), run_dir=train[name][
            "run"], device=device, save_cfg=False)
        t.restore_weights()
        return t

    def prof(what: str, fn, ms: float) -> float:
        """The profile line's launches a call (diagnostics: nan when the
        profiler fails)."""
        try:
            return profile_line(what, fn, ms)
        except Exception as e:  # noqa: BLE001 - diagnostics only
            print(f"profile {what}: not measured ({type(e).__name__}: {e})")
            return float("nan")

    out = {}
    liq, knobs, de = (trainer("liquid"), trainer("knobs"),
                      train_timing["2d"]["trainer"])
    liq_cache, knob_cache = liq._load_device_cache(), knobs._load_device_cache()
    de_cache = de._load_device_cache()
    for b in (8, 64):
        lx, ly = liq_cache[0][:b].float(), liq_cache[1][:b]
        ms = cuda_ms(lambda: liq._train_step(lx, ly), 20)
        launches = prof(
            f"LIQUID train step batch {b} bf16 [{card}]",
            lambda: liq._train_step(lx, ly), ms)
        out[("liquid_step", b)] = ms
        print(f"phase 5 timing [{card}]: LIQUID train step (fwd+bwd+Adam, "
              f"no curl, the x-mirror on) flagship bf16 batch {b}: "
              f"{ms:.3f} ms ({1e3 / ms:.1f} steps/s device), "
              f"{launches:.0f} kernel launches a step, no FD kernel",
              flush=True)
    model = flagship_model(PATH_LIQ)
    load_flax_npz(serving["liquid"]["weights"], model)
    model.to(device)
    p = torch.rand((512, 3), device=device) * 2 - 1
    with torch.inference_mode():
        ms = cuda_ms(lambda: model(p), 10)
        prof(f"LIQUID batch 512 fwd [{card}]", lambda: model(p), ms)
    out["liquid_serving_fields_per_s"] = 512e3 / ms
    print(f"phase 5 timing [{card}]: LIQUID GeneratorBE 128x96x1 f128 c4 "
          f"bf16 batch 512 (no curl): {ms:.3f} ms = {512e3 / ms:.1f} "
          f"fields/s", flush=True)
    for b in (8, 64):
        kx, ky = knob_cache[0][:b].float(), knob_cache[1][:b]
        dx, dy = de_cache[0][:b].float(), de_cache[1][:b]
        kern, plain, runs = alternated(
            lambda: de._train_step(dx, dy),
            lambda: knobs._train_step(kx, ky), 20 if b == 8 else 10)
        lk = prof(f"KNOBS train step batch {b} bf16 [{card}]",
                  lambda: knobs._train_step(kx, ky), kern)
        lp = prof(f"2D train step batch {b} bf16 (no knob) [{card}]",
                  lambda: de._train_step(dx, dy), plain)
        out[("knob_step", b)], out[("de_step", b)] = kern, plain
        print(f"phase 5 timing [{card}]: KNOBS train step (grid decoder, "
              f"embed 8, spectral 8, x-mirror) flagship bf16 batch {b}: "
              f"{kern:.3f} ms vs the 2D de step {plain:.3f} ms "
              f"({kern / plain:.2f}x; d {runs[0]:.3f} k {runs[1]:.3f} k "
              f"{runs[2]:.3f} d {runs[3]:.3f}); kernel launches a step "
              f"{lk:.0f} vs {lp:.0f}", flush=True)
    kx, ky = knob_cache[0][:8].float(), knob_cache[1][:8]
    flip = knobs._flip

    def unflipped():
        knobs._flip = None
        knobs._train_step(kx, ky)
        knobs._flip = flip

    on, off, runs = alternated(unflipped,
                               lambda: knobs._train_step(kx, ky), 20)
    out["flip_ms"] = on - off
    print(f"phase 5 timing [{card}]: the x-mirror in the KNOBS step at "
          f"batch 8: {on:.3f} ms with vs {off:.3f} ms without "
          f"({on - off:+.3f} ms; n {runs[0]:.3f} f {runs[1]:.3f} f "
          f"{runs[2]:.3f} n {runs[3]:.3f})", flush=True)
    return out


# The train step as a CUDA graph (train/graph.py): phase 5's
# --steps_per_call values, phase 14's steps of each graph-vs-body run and
# the step of its resume check's checkpoint, and the bar when a run is not
# bit-equal (of each parameter's largest entry; cuDNN may pick another
# algorithm under capture).
GRAPH_KS = (1, 8, 32)
GRAPH_PARITY_STEPS = 40
GRAPH_RESUME_AT = 20
TOL_GRAPH = 1e-6


@contextlib.contextmanager
def step_log():
    """The port's log lines of the train step's path and of each capture,
    collected while inside."""
    import logging

    seen: list[str] = []

    class Keep(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if msg.startswith(("train step path", "captured")):
                seen.append(msg)

    keep = Keep()
    logger = logging.getLogger("deepfluids_tpu_torch")
    logger.addHandler(keep)
    try:
        yield seen
    finally:
        logger.removeHandler(keep)


def graph_taken(seen: list[str], what: str) -> str:
    """The capture line of a run that took the graph path (its log lines
    ``seen``); raises if it did not."""
    caps = [m for m in seen if m.startswith("captured")]
    if not any(m.startswith("train step path: graph") for m in seen) or (
            not caps):
        raise AssertionError(f"{what} did not take the CUDA graph path: "
                             f"{seen}")
    return caps[-1]


def _graph_config(run: str, tag: str, root: str, **kw):
    """The config of phase 6/7's ``run`` as a fresh one-card training run
    from the device cache under ``root``, changed by ``kw``."""
    from deepfluids_tpu_torch.config import load_config

    return dataclasses.replace(
        load_config(run), is_train=True, load_path="", tag=tag,
        log_dir=os.path.join(root, "graph_logs"), device_data_cache=True,
        log_step=10 ** 6, save_step=10 ** 6, test_step=10 ** 6, **kw)


def _state_distance(got, want) -> tuple[bool, float, str]:
    """(bit-equal, the worst ``max |got - want| / max |want|`` over the
    parameters and Adam's moments, its name) of two trainers."""
    pairs = [(f"param {k}", got.model.state_dict()[k], v)
             for k, v in want.model.state_dict().items()]
    gs, ws = got.opt.state_dict()["state"], want.opt.state_dict()["state"]
    pairs += [(f"adam {i} {k}", gs[i][k], v)
              for i, st in ws.items() for k, v in st.items()]
    same, worst, name = True, 0.0, ""
    for k, a, b in pairs:
        if not bool((a == b).all()):
            same = False
            a, b = a.double(), b.double()
            d = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            if d > worst:
                worst, name = d, k
    return same, worst, name


def _held(got, want, what: str) -> str:
    """Bit-equal, or within TOL_GRAPH of each entry's scale (printed as
    such); raises otherwise."""
    same, worst, name = _state_distance(got, want)
    if same:
        return "bit-equal"
    if worst > TOL_GRAPH:
        raise AssertionError(f"{what}: {name} {worst:.3e} from the "
                             f"uncaptured body's (bar {TOL_GRAPH})")
    return f"not bit-equal, worst {name} {worst:.3e} (bar {TOL_GRAPH})"


def phase_graph(device, root: str, train: dict, mov: dict) -> None:
    """Phase 14: the CUDA graph's chunks against the same body uncaptured,
    at the flagship width from the same seed and batches: 2D "de" batch 8
    with the x-mirror, 3D "de" batch 2 and the AE on pair batches
    (``--ae_pred_w``), each 40 steps at --steps_per_call 1 and 8, the
    parameters and Adam's state bit for bit (or held at TOL_GRAPH, said
    so), the FD launches exact; then a 2D graph run checkpointed at step 20,
    trained on and restored there (the captured graph dropped), trained
    to 40, against the uninterrupted graph run."""
    import torch

    from deepfluids_tpu_torch.ops import cuda_fd
    from deepfluids_tpu_torch.train.trainer import Trainer

    cases = (
        ("2D", PATH_2D.step_launches,
         _graph_config(train["2d"]["run"], "g2d", root, batch_size=8,
                       augment_flip_x=True)),
        ("3D", PATH_3D.step_launches,
         _graph_config(train["3d"]["run"], "g3d", root, batch_size=2)),
        ("MOV AE pairs", PATH_MOV.step_launches,
         _graph_config(mov["run"], "gae", root, batch_size=8,
                       ae_pred_w=0.5)))
    n = GRAPH_PARITY_STEPS
    done, keep = [], None
    for label, step_launches, cfg in cases:
        cache = None
        for k in (1, 8):
            pair = []
            for path in ("graph", "body"):
                t = Trainer(dataclasses.replace(
                    cfg, steps_per_call=k, tag=f"{cfg.tag}_{path}{k}"),
                    device=device)
                if not t.capture:
                    raise AssertionError(f"{label}: not captured")
                t.capture = path == "graph"
                if cache is None:
                    cache = t._load_device_cache()
                t._device_cache = cache
                cuda_fd.reset_launch_counts()
                run = t._chunk_runner(n, 0, k)
                for _ in range(n // k):
                    run(k)
                torch.cuda.synchronize(device)
                want = expected_launches({name: n * c for name, c in
                                          step_launches.items()})
                if dict(cuda_fd.launch_counts) != want:
                    raise AssertionError(f"{label} {path} K={k} launched "
                                         f"{cuda_fd.launch_counts}, want "
                                         f"{want}")
                pair.append(t)
            g, e = pair
            done.append(f"{label} K={k} {_held(g, e, f'{label} K={k}')} "
                        f"(capture {g._chunks.capture_s:.2f} s, pool "
                        f"{g._chunks.pool_bytes / 2 ** 20:.0f} MB)")
            if label == "2D" and k == 1:
                keep = g
    # The resume check on the 2D cache path, K = 1.
    cfg = dataclasses.replace(cases[0][2], steps_per_call=1,
                              tag="g2d_resume", save_step=GRAPH_RESUME_AT)
    t = Trainer(cfg, device=device)
    t._device_cache = keep._device_cache
    t.train(num_steps=GRAPH_RESUME_AT)
    t.train(num_steps=8)
    held = t._chunks.graph is not None
    if not held or t.restore_checkpoint(GRAPH_RESUME_AT) != GRAPH_RESUME_AT:
        raise AssertionError("the resume check: no graph held or no "
                             "checkpoint")
    if t._chunks is not None:
        raise AssertionError("a restore kept the captured graph")
    t.train(num_steps=n - GRAPH_RESUME_AT)
    same, worst, name = _state_distance(t, keep)
    if not same:
        raise AssertionError(f"resumed at {GRAPH_RESUME_AT} under the graph "
                             f"!= {n} uninterrupted steps: {name} {worst:.3e}")
    print(f"phase 14 CUDA graph: ok  the graph against its body uncaptured "
          f"({n} steps from one seed, launches exact): {'; '.join(done)}; "
          f"{GRAPH_RESUME_AT} steps, a checkpoint, 8 more, restored at "
          f"{GRAPH_RESUME_AT} (the held graph dropped) and {n - GRAPH_RESUME_AT} "
          f"more = {n} uninterrupted, bit for bit", flush=True)


def kernel_ms(fn, calls: int) -> float:
    """Device time of ``calls`` calls of ``fn`` from the profiler's kernel
    rows, per call; nan when the profiler gave none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False))
    return total / 1e3 / calls if total else float("nan")


def _steady(t, capture: bool, k: int, steps: int, profile: bool = False
            ) -> dict:
    """The steady state of trainer ``t``'s chunk body, captured or not, at
    --steps_per_call ``k`` from the device cache: after a warm-up chunk
    and the capture, ``steps`` steps (whole chunks) timed end to end (host
    blocks, copies and replays or uncaptured bodies included); the host's
    time issuing them
    (its waits for a staging buffer included), peak memory and, with
    ``profile``, the kernels' ms a step over one more chunk (profiler)."""
    import torch

    t.capture = capture
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = t._chunk_runner(10 ** 9, t.step, k)
    run(k)
    run(k)
    chunks = max(1, steps // k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(chunks):
        aux = run(k)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / (chunks * k)
    loss = t._reported(aux)["loss"]
    if not np.isfinite(loss):
        raise AssertionError(f"capture {capture} K={k}: loss {loss}")
    g = t._chunks if capture else None
    return {"wall_ms": wall, "host_ms": host * 1e3 / (chunks * k),
            "steps_per_s": 1e3 / wall,
            "capture_s": g.capture_s if g else None,
            "pool_mb": g.pool_bytes / 2 ** 20 if g else None,
            "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
            "kernel_ms": kernel_ms(lambda: run(k), 1) / k if profile
            else None}


def phase_graph_timing(device, root: str, train: dict, mov: dict,
                       card: str) -> dict:
    """Phase 5 (printed only): the uncaptured chunk body at K = 1 against
    the CUDA graph at --steps_per_call 1, 8 and 32, from the device cache, flagship bf16:
    2D, liquid and knobs at batch 8 and 64, 3D and the MOV AE at 8; for
    each the wall and host ms a step, steps/s, the capture's seconds, the
    graph pool's and the peak's MB; the device ms of a step (the
    profiler's kernel rows over one replay at K = 8: every path runs the
    same kernels) and each path's idle share against it."""
    from deepfluids_tpu_torch.train.trainer import Trainer

    cases = (("2D", train["2d"]["run"], (8, 64)),
             ("LIQUID", train["liquid"]["run"], (8, 64)),
             ("KNOBS", train["knobs"]["run"], (8, 64)),
             ("3D", train["3d"]["run"], (8,)),
             ("MOV AE", mov["run"], (8,)))
    out = {}
    for label, run, batches in cases:
        cache = None
        for b in batches:
            cfg = _graph_config(run, f"time_{label}_{b}", root, batch_size=b)
            t = Trainer(cfg, run_dir=os.path.join(root, "graph_logs"),
                        device=device, save_cfg=False)
            if cache is None:
                cache = t._load_device_cache()
            t._device_cache = cache
            steps = 16 if b > 8 or label == "3D" else 32
            kd = max(k for k in GRAPH_KS if k <= 8)    # profiled: one replay
            res = {"body": _steady(t, False, 1, steps)}
            for k in GRAPH_KS:
                res[k] = _steady(t, True, k, max(steps, k),
                                 profile=k == kd)
            dev = res[kd]["kernel_ms"]
            for r in res.values():
                r.update(device_ms=dev, idle=1 - dev / r["wall_ms"])
            out[(label, b)] = res

            def fmt(r: dict) -> str:
                return (f"{r['wall_ms']:.3f} ms (host {r['host_ms']:.3f}, "
                        f"idle {r['idle']:.3f}) = {r['steps_per_s']:.1f} "
                        f"steps/s, peak {r['peak_mb']:.0f} MB")
            graphs = "; ".join(
                f"K={k} {fmt(res[k])}, capture {res[k]['capture_s']:.2f} s, "
                f"pool {res[k]['pool_mb']:.0f} MB" for k in GRAPH_KS)
            print(f"phase 5 graph [{card}]: {label} train step flagship "
                  f"{cfg.compute_dtype} batch {b}, device cache"
                  f"{', x-mirror' if cfg.augment_flip_x else ''}: kernels "
                  f"{dev:.3f} ms a step; body {fmt(res['body'])}; graph "
                  f"{graphs}", flush=True)
            del t
    return out


# Phase 10's cut of each published scene: (scene function kwargs, what the
# published scene has).  Full width and frame length everywhere except the
# 3D matched run; the scene counts are cut for the time limit.
DATAGEN_CUTS = {
    "2d_jacobi": (dict(num_pos=5, num_size=3, scene_batch=15,
                       num_frames=100),
                  "5 x 3 of the 21 x 5 scenes, 100 of 200 frames"),
    "2d_matched": (dict(num_pos=2, num_size=2, scene_batch=4,
                        projection="matched", name="smoke_matched",
                        num_frames=100),
                   "2 x 2 of the 21 x 5 scenes, 100 of 200 frames"),
    "3d_jacobi": (dict(num_vel=3, num_buo=1, num_frames=25),
                  "3 x 1 of the 5 x 3 scenes, one 25-frame segment of 250"),
    "3d_matched": (dict(num_vel=1, num_buo=1, num_frames=4,
                        projection="matched", name="smoke3_matched"),
                   "1 of the 5 x 3 scenes, 4 of 250 frames"),
    "liquid": (dict(num_pos=2, num_size=2, num_frames=60),
               "2 x 2 of the 10 x 4 scenes, 60 of 200 frames"),
    "mov": (dict(num_scenes=4, num_frames=64),
            "4 of 200 scenes, 64 of 400 frames"),
}
DATAGEN_TRAIN_STEPS = 200   # of main on the 2D set phase 10 wrote
TOL_STEP = 1e-5        # one smoke step, card vs CPU, normalized L2
TOL_LIQUID_STEP = 1e-4  # one FLIP step: the scatter's atomics reorder sums
TOL_MANIFOLD = 1e-3    # a matched frame's distance to range(curl2d)


def manifold_distance(frames, project) -> np.ndarray:
    """Relative distance of each of ``frames [N, ..., C]`` (a tensor on the
    card) to the range of the model's curl: the norm of what ``project``
    (``project_curl2d`` / ``3d``) removes, over the frame's.  The V-cycles
    solve to the f32 floor only, so the removed part is projected again
    twice: each pass takes off what the one before left on the manifold."""
    r = frames
    for _ in range(3):
        r = r - project(r)
    dims = tuple(range(1, frames.dim()))
    import torch

    norm = torch.linalg.vector_norm
    return (norm(r, dim=dims) / norm(frames, dim=dims).clamp(min=1e-30)
            ).cpu().numpy()


def _load_frames(ds: str, key: str, names: list[str]) -> np.ndarray:
    out = []
    for n in names:
        with np.load(os.path.join(ds, key, n)) as d:
            out.append(d["x"])
    return np.stack(out)


@contextlib.contextmanager
def recording_projection_shapes(shapes: set):
    """Adds to ``shapes`` every shape (batch + spatial) at which the matched
    projection hands a tensor on the card to a kernel wrapper."""
    from deepfluids_tpu_torch.datagen import projection

    batched = projection._batched

    def recording(fn, x, spatial, channels):
        if x.is_cuda:
            grid = tuple(x.shape[x.dim() - spatial - 1:-1])
            shapes.add((x.numel() // (math.prod(grid) * x.shape[-1]),) + grid)
        return batched(fn, x, spatial, channels)

    projection._batched = recording
    try:
        yield
    finally:
        projection._batched = batched


def _run_scene(ctx, tag: str, fn, kwargs: dict, want: dict) -> str:
    """A scene function on the card (its default device) from launch
    counts at 0; its launches must be ``want``.  Records its seconds, the
    seconds inside np.savez_compressed and the launches under ``tag`` and
    returns the dataset's directory."""
    import torch

    from deepfluids_tpu_torch.datagen import scenes
    from deepfluids_tpu_torch.ops import cuda_fd

    saved, save_frames = [0.0], scenes._save_frames

    def timed_save(*a, **k):
        t0 = time.perf_counter()
        save_frames(*a, **k)
        saved[0] += time.perf_counter() - t0

    scenes._save_frames = timed_save
    try:
        cuda_fd.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recording_projection_shapes(ctx.shapes):
            out = fn(ctx.data, **kwargs)
        ctx.secs[tag] = time.perf_counter() - t0
    finally:
        scenes._save_frames = save_frames
    ctx.save_s[tag] = saved[0]
    ctx.launches[tag] = dict(cuda_fd.launch_counts)
    if ctx.launches[tag] != expected_launches(want):
        raise AssertionError(f"datagen {tag} launched {ctx.launches[tag]}, "
                             f"want {want}")
    return out


def _check_set(ds: str, keys: tuple, scenes_n: int, frames: int,
               field_shape: tuple, counts) -> "Manifest":
    """The on-disk contract of a generated set: args.txt's fields and one
    file per scene and frame under each key."""
    from deepfluids_tpu_torch.data import load_manifest

    m = load_manifest(ds)
    for k in keys:
        n = len(os.listdir(os.path.join(ds, k)))
        if n != scenes_n * frames:
            raise AssertionError(f"{ds}/{k}: {n} files, want "
                                 f"{scenes_n * frames}")
    ok = (m.num_scenes == scenes_n and m.num_frames == frames
          and tuple(m.field_shape) == field_shape
          and m.param_counts == counts and m.param_names[-1] == "frame"
          and np.isfinite(m.v_range).all() and m.v_range[0] < m.v_range[1]
          and m.param_ranges[-1] == [0.0, float(frames - 1)])
    if not ok:
        raise AssertionError(f"{ds}: manifest {m}")
    return m


# The four liquid scenes of phase 10 (the corners of the published grid).
LIQUID_POS = [0.25, 0.25, 0.75, 0.75]
LIQUID_RAD = [0.06, 0.15, 0.06, 0.15]


def datagen_setups(ctx) -> None:
    """The 2D and 3D multigrid setups of the matched projection, each timed
    on its own line (built once on the card, cached)."""
    import torch

    from deepfluids_tpu_torch.datagen import projection
    from deepfluids_tpu_torch.ops import cuda_fd

    setups = {}
    for tag, op, shape in (("2D", "curl_ls", (128, 96)),
                           ("3D", "curl3_ls", (32, 64, 112, 3))):
        cuda_fd.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recording_projection_shapes(ctx.shapes):
            setups[tag] = projection._mg_setup(op, shape, torch.float32,
                                               ctx.device)
        torch.cuda.synchronize()
        probes = {k: v for k, v in cuda_fd.launch_counts.items() if v}
        print(f"phase 10 datagen [{ctx.card}]: {tag} matched-projection "
              f"multigrid setup ({op} on {shape}: levels "
              f"{setups[tag]['shapes']}, diagonal probes, 60 power "
              f"iterations a level, the coarsest level's dense probe and "
              f"pinv) {time.perf_counter() - t0:.2f} s on the card, kernel "
              f"launches {probes}", flush=True)
    # Applications of the fine operator in one V(2,2)-cycle: every level
    # but the coarsest smooths 4 times and takes one residual, and each of
    # these chains through the fine operator once.
    ctx.per_cycle = {k: 5 * (len(v["shapes"]) - 1)
                     for k, v in setups.items()}



def datagen_smoke2d(ctx) -> None:
    """``smoke_pos21_size5`` at 128x96 through the scene function, jacobi
    and matched: the set's contract, the frames' distance to the manifold
    and the launch counts."""
    import torch

    from deepfluids_tpu_torch.datagen import projection, scenes, smoke2d

    kw, cut = DATAGEN_CUTS["2d_jacobi"]
    f2 = ctx.f2 = kw.get("num_frames", 200)  # frames of both 2D runs
    ctx.ds_2d = _run_scene(ctx, "2d_jacobi", scenes.smoke_pos21_size5, kw,
                           {})
    m_j = _check_set(ctx.ds_2d, ("v", "d"), 15, f2, (128, 96, 2), [5, 3])
    kw_m, cut_m = DATAGEN_CUTS["2d_matched"]
    cycles = smoke2d.Smoke2DConfig().mg_cycles
    # per frame: the right-hand side's transposed curl, every V-cycle's
    # fine applications (one curl and one transposed curl each), the final
    # curl; one scene batch, so once for all its scenes
    n2 = f2 * (cycles * ctx.per_cycle["2D"] + 1)
    ds_m = _run_scene(ctx, "2d_matched", scenes.smoke_pos21_size5, kw_m,
                      {"curl2d_fused": n2, "curl2d_bwd": n2})
    _check_set(ds_m, ("v", "d"), 4, f2, (128, 96, 2), [2, 2])
    dist = {}
    for tag, ds, scene_ids in (("jacobi", ctx.ds_2d, ["0_0", "2_1", "4_2"]),
                               ("matched", ds_m, ["0_0", "1_1"])):
        names = [f"{s}_{f}.npz" for s in scene_ids for f in range(f2)]
        v = _load_frames(ds, "v", names)
        d = _load_frames(ds, "d", names).reshape(len(scene_ids), f2, -1)
        if not (np.isfinite(v).all() and np.isfinite(d).all()
                and (d[:, -1].sum(1) > d[:, 0].sum(1)).all()
                and (d[:, 0].sum(1) > 0).all()):
            raise AssertionError(f"2D {tag} frames: not finite, or the "
                                 f"density does not rise")
        vt = torch.from_numpy(v).to(ctx.device)
        dist[tag] = manifold_distance(
            vt, lambda x: projection.project_curl2d(x, cycles=12))
        if tag == "jacobi":
            # For context: the orthogonal distance to ker(div_f), the
            # manifold without the closed box's wall constraint.
            free = manifold_distance(
                vt, lambda x: projection.project_matched(x, cycles=12))
        if tag == "matched":
            wall = max(np.abs(v[:, :, (0, -1), 0]).max(),
                       np.abs(v[:, (0, -1), :, 1]).max())
            if not (dist[tag].max() < TOL_MANIFOLD and wall == 0.0):
                raise AssertionError(
                    f"matched 2D frames: distance to range(curl2d) up to "
                    f"{dist[tag].max():.2e} (tol {TOL_MANIFOLD}), wall "
                    f"through-flow {wall}")
    print(f"phase 10 datagen 2D: ok  smoke_pos21_size5 128x96 through the "
          f"scene function on its default device: jacobi {cut} in one "
          f"scene batch of 15 ({ctx.secs['2d_jacobi']:.2f} s, "
          f"{ctx.save_s['2d_jacobi']:.2f} s of it in np.savez_compressed; "
          f"no FD "
          f"launch); matched {cut_m} in one scene batch of 4 "
          f"({ctx.secs['2d_matched']:.2f} s, {ctx.save_s['2d_matched']:.2f} s "
          f"saving; curl2d_fused = curl2d_bwd = {n2} launches = {f2} frames "
          f"x ({cycles} V-cycles x {ctx.per_cycle['2D']} fine applications + "
          f"1), exact); files, args.txt (param_counts, v_range "
          f"{m_j.v_range[0]:.3f}..{m_j.v_range[1]:.3f}), finite, density "
          f"rising; relative distance of a frame to range(curl2d), median "
          f"over {3 * f2} / {2 * f2} frames: jacobi "
          f"{np.median(dist['jacobi']):.4f} "
          f"(the reference claims 0.247; to ker(div_f), without the "
          f"wall constraint, {np.median(free):.4f}), matched "
          f"{np.median(dist['matched']):.2e} (max "
          f"{dist['matched'].max():.2e}, tol {TOL_MANIFOLD}), matched wall "
          f"through-flow exactly 0", flush=True)



def datagen_smoke3d(ctx) -> None:
    """``smoke3_vel5_buo3`` at 32x64x112: a jacobi segment of three scenes
    and a few matched frames of one."""
    import torch

    from deepfluids_tpu_torch.datagen import projection, scenes, smoke3d

    kw3, cut3 = DATAGEN_CUTS["3d_jacobi"]
    f3 = ctx.f3 = kw3["num_frames"]
    ctx.ds_3d = _run_scene(ctx, "3d_jacobi", scenes.smoke3_vel5_buo3, kw3,
                           {})
    _check_set(ctx.ds_3d, ("v", "d"), 3, f3, (32, 64, 112, 3), [3, 1])
    kw3m, cut3m = DATAGEN_CUTS["3d_matched"]
    cycles3 = smoke3d.Smoke3DConfig().mg_cycles
    n3 = kw3m["num_frames"] * (cycles3 * ctx.per_cycle["3D"] + 1)
    ds_3m = _run_scene(ctx, "3d_matched", scenes.smoke3_vel5_buo3, kw3m,
                       {"curl3d_fused": n3, "curl3d_bwd": n3})
    _check_set(ds_3m, ("v", "d"), 1, kw3m["num_frames"], (32, 64, 112, 3),
               [1, 1])
    dist3 = {}
    for tag, ds, names in (
            ("jacobi", ctx.ds_3d, [f"{s}_0_{f}.npz" for s in range(3)
                              for f in (f3 // 5, f3 // 2, f3 - 1)]),
            ("matched", ds_3m, [f"0_0_{f}.npz" for f in range(
                kw3m["num_frames"])])):
        v = _load_frames(ds, "v", names)
        d = _load_frames(ds, "d", names)
        if not (np.isfinite(v).all() and np.isfinite(d).all()
                and d[-1].sum() > 0):
            raise AssertionError(f"3D {tag} frames are not finite")
        dist3[tag] = manifold_distance(
            torch.from_numpy(v).to(ctx.device),
            lambda x: projection.project_curl3d(x, cycles=cycles3))
    print(f"phase 10 datagen 3D: ok  smoke3_vel5_buo3 32x64x112: jacobi "
          f"{cut3} ({ctx.secs['3d_jacobi']:.2f} s, "
          f"{ctx.save_s['3d_jacobi']:.2f} s "
          f"saving; no FD launch); matched {cut3m} "
          f"({ctx.secs['3d_matched']:.2f} s; curl3d_fused = curl3d_bwd = {n3} "
          f"launches = {kw3m['num_frames']} frames x ({cycles3} V-cycles x "
          f"{ctx.per_cycle['3D']} + 1), exact); relative distance to "
          f"range(curl3d), median: jacobi {np.median(dist3['jacobi']):.4f}, "
          f"matched {np.median(dist3['matched']):.2e}", flush=True)



def datagen_liquid_mov(ctx) -> None:
    """``liquid_pos10_size4`` (with the particle and mass invariants read
    off every P2G scatter of that run) and ``smoke_mov`` (its params against
    numpy's knots)."""
    import torch

    from deepfluids_tpu_torch.datagen import liquid2d, scenes

    kwl, cutl = DATAGEN_CUTS["liquid"]
    fl = kwl["num_frames"]
    # The invariants are read off the scene function's own run: every P2G
    # scatter it makes reports its summed grid mass and the active count.
    p2g, seen = liquid2d._p2g, []

    def recording_p2g(py, px, pvy, pvx, active, h, w):
        vel, mass = p2g(py, px, pvy, pvx, active, h, w)
        seen.append((mass.sum(dim=(1, 2)), active.sum(dim=1)))
        return vel, mass

    liquid2d._p2g = recording_p2g
    try:
        ds_l = _run_scene(ctx, "liquid", scenes.liquid_pos10_size4, kwl, {})
    finally:
        liquid2d._p2g = p2g
    _check_set(ds_l, ("l", "v"), 4, fl, (128, 96, 1), [2, 2])
    ls = _load_frames(ds_l, "l", [f"{i}_{j}_{f}.npz" for i in range(2)
                                  for j in range(2) for f in (0, fl - 1)])
    if not (np.isfinite(ls).all() and (ls.reshape(8, -1).min(1) < 0).all()):
        raise AssertionError("liquid levelsets: not finite, or no liquid in "
                             "a first or last frame")
    masses = torch.stack([m for m, _ in seen])        # [scatters, 4]
    counts = torch.stack([c for _, c in seen])
    count = counts[0]
    worst_mass = float(((masses - counts).abs() / counts).max())
    if not (len(seen) >= fl and masses.shape[1] == 4
            and bool((count > 0).all()) and bool((counts == count).all())
            and worst_mass < 1e-5):
        raise AssertionError(
            f"liquid: {len(seen)} P2G scatters over {fl} frames, active "
            f"particles {counts.min(0).values.tolist()}.."
            f"{counts.max(0).values.tolist()}, summed mass off the count by "
            f"{worst_mass:.2e}")
    kwm, cutm = DATAGEN_CUTS["mov"]
    fm = kwm["num_frames"]
    n_knots = max(fm // 40, 2)
    ds_v = _run_scene(ctx, "mov", scenes.smoke_mov, kwm, {})
    m_v = _check_set(ds_v, ("v", "d"), 4, fm, (128, 96, 2), None)
    rng = np.random.default_rng(0)
    for s in range(4):
        knots = rng.uniform(0.2, 0.8, size=n_knots)
        want = np.stack([np.interp(np.linspace(0, n_knots - 1, fm),
                                   np.arange(n_knots), knots
                                   ).astype(np.float32),
                         np.arange(fm, dtype=np.float32)], axis=1)
        got = np.stack([np.load(os.path.join(ds_v, "v", f"{s}_{f}.npz"))["y"]
                        for f in range(fm)])
        if not np.array_equal(got, want):
            raise AssertionError(f"smoke_mov scene {s}: params differ from "
                                 f"numpy's knots")
    print(f"phase 10 datagen liquid+mov: ok  liquid_pos10_size4 128x96 "
          f"{cutl} ({ctx.secs['liquid']:.2f} s, {ctx.save_s['liquid']:.2f} s "
          f"saving): levelsets finite, liquid in every first and last "
          f"frame, {int(count.sum())} active particles of 4 scenes constant "
          f"and the summed grid mass within {worst_mass:.1e} of them in each "
          f"of the run's own {len(seen)} P2G scatters; smoke_mov 128x96 {cutm} ({ctx.secs['mov']:.2f} s, "
          f"{ctx.save_s['mov']:.2f} s saving): params [pos_x(t), frame] equal "
          f"numpy's default_rng(0) knots, {m_v.num_param} params; no FD "
          f"launch in either", flush=True)



def datagen_steps(ctx) -> None:
    """One f32 step of each solver from a shared mid-trajectory state, the
    card against the port on the CPU, and the matched projection through
    the kernels against the plain ops on the card."""
    import torch

    from deepfluids_tpu_torch.datagen import (liquid2d, projection, smoke2d,
                                              smoke3d)
    from deepfluids_tpu_torch.ops import cuda_fd
    from deepfluids_tpu_torch.utils.parity import normalized_l2

    cfg_l = liquid2d.Liquid2DConfig()
    def l2(a, b):
        return normalized_l2(a.cpu().numpy(), b.numpy())

    def both(fn, *xs):
        """``fn`` on the card and on the CPU, same inputs."""
        with torch.no_grad():
            return (fn(*[x.to(ctx.device) for x in xs]), fn(*xs))

    steps = {}
    mid = [f"2_1_{ctx.f2 // 2}.npz"]
    vel = torch.from_numpy(_load_frames(ctx.ds_2d, "v", mid))
    rho = torch.from_numpy(_load_frames(ctx.ds_2d, "d", mid))[..., 0]
    mask = smoke2d._source_mask(128, 96, torch.tensor([0.5]),
                                torch.tensor([0.08]), 0.08)
    for proj in ("jacobi", "matched"):
        cfg2 = smoke2d.Smoke2DConfig(projection=proj)
        (cv, cr), (hv, hr) = both(
            lambda v, r, m: smoke2d.step((v, r), m, cfg2), vel, rho, mask)
        steps[f"smoke2d {proj}"] = max(l2(cv, hv), l2(cr, hr))
    mid = [f"1_0_{ctx.f3 // 2}.npz"]
    vel3 = torch.from_numpy(_load_frames(ctx.ds_3d, "v", mid))
    rho3 = torch.from_numpy(_load_frames(ctx.ds_3d, "d", mid))[..., 0]
    cfg3 = smoke3d.Smoke3DConfig()
    (cv, cr), (hv, hr) = both(
        lambda v, r, m: smoke3d._step3((v, r), 1.0, 0.04, m, cfg3), vel3,
        rho3, smoke3d._source_mask3(32, 64, 112))
    steps["smoke3d jacobi"] = max(l2(cv, hv), l2(cr, hr))
    bad = {k: v for k, v in steps.items() if not v < TOL_STEP}
    # the liquid: a shared mid-trajectory particle state, made on the CPU
    one = torch.tensor([0.5]), torch.tensor([0.1])
    lpy, lpx, lpvy, lpvx, lact = liquid2d._seed_particles(
        128, 96, *one, cfg_l.basin_level)
    lstate = (lpy, lpx, lpvy, lpvx)
    with torch.no_grad():
        for _ in range(12):
            lstate, _ = liquid2d._step(lstate, lact, cfg_l)
    (cs, (cphi, cvel)), (hs, (hphi, hvel)) = both(
        lambda a, *st: liquid2d._step(st, a, cfg_l), lact, *lstate)
    steps["liquid"] = max([l2(cvel, hvel)] + [l2(a, b) for a, b in
                                              zip(cs, hs)])
    if bad or not steps["liquid"] < TOL_LIQUID_STEP:
        raise AssertionError(f"one solver step, card vs CPU: {steps}")
    # the matched projection through the kernels against the plain ops, at
    # the scene batches of the matched scene runs (4 in 2D, 1 in 3D)
    vel4 = torch.from_numpy(_load_frames(
        ctx.ds_2d, "v", [f"{s}_{ctx.f2 // 2}.npz"
                         for s in ("0_0", "2_1", "4_2", "1_2")]))
    kp = {}
    for tag, fn, x in (("2D", projection.project_curl2d, vel4.to(ctx.device)),
                       ("3D", projection.project_curl3d, vel3.to(ctx.device))):
        cuda_fd.reset_launch_counts()
        through = fn(x, cycles=8)
        launched = dict(cuda_fd.launch_counts)
        cuda_fd.reset_launch_counts()
        with plain_projection_ops():
            plain = fn(x, cycles=8)
        n = 8 * ctx.per_cycle[tag] + 1
        want = expected_launches({f"curl{tag[0]}d_fused": n,
                                  f"curl{tag[0]}d_bwd": n})
        if any(cuda_fd.launch_counts.values()) or launched != want:
            raise AssertionError(f"{tag} matched projection: launches "
                                 f"{launched} through the kernels (want "
                                 f"{n} each), "
                                 f"{dict(cuda_fd.launch_counts)} plain")
        kp[tag] = normalized_l2(through.cpu().numpy(), plain.cpu().numpy())
        if not kp[tag] <= TOL_KERNEL:
            raise AssertionError(f"{tag} matched projection, kernels vs "
                                 f"plain ops: L2 {kp[tag]:.2e}")
    print(f"phase 10 datagen steps: ok  one f32 step from a shared "
          f"mid-trajectory state, card vs the port on the CPU, normalized "
          f"L2: " + ", ".join(f"{k} {v:.1e}" for k, v in steps.items())
          + f" (tol {TOL_STEP}; the liquid's {TOL_LIQUID_STEP}, grid "
          f"velocity and particle state: its P2G scatter sums with atomics "
          f"on the card, in no fixed order); the matched projection (8 "
          f"V-cycles) through the kernels vs through the plain ops/fd.py "
          f"functions on the card: 2D [4,128,96] {kp['2D']:.1e}, 3D "
          f"[1,32,64,112] {kp['3D']:.1e} "
          f"(tol {TOL_KERNEL})", flush=True)



def datagen_loop(ctx) -> None:
    """The loop closed: ``main`` trains the flagship generator on the 2D
    set the card just wrote, and ``render_density_sweep`` advects a density
    through the trained generator's fields."""
    import torch

    from deepfluids_tpu_torch.config import load_config
    from deepfluids_tpu_torch.infer import render_density_sweep
    from deepfluids_tpu_torch.ops import cuda_fd
    from deepfluids_tpu_torch.train.trainer import Trainer
    from deepfluids_tpu_torch.utils.parity import normalized_l2

    logs = os.path.join(ctx.root, "logs")
    n_train = DATAGEN_TRAIN_STEPS
    dataset = os.path.basename(ctx.ds_2d)
    argv = ["--is_train", "True", "--arch", "de", "--data_dir", ctx.data,
            "--dataset", dataset, "--log_dir", logs, "--tag", "datagen",
            "--batch_size", "8", "--compute_dtype", "bfloat16",
            "--log_step", "20", "--save_step", str(n_train // 2),
            "--test_step", str(n_train // 2),
            "--num_worker", "4", "--filters", str(FLAGSHIP["filters"]),
            "--num_conv", str(FLAGSHIP["num_conv"]), "--max_step",
            str(n_train)]
    want = expected_launches({
        k: n_train * n + 2 * PATH_2D.forward_launches.get(k, 0)
        for k, n in PATH_2D.step_launches.items()})
    _, train_s, ctx.launches["train"] = _drive(
        ctx.device, argv, want, "training on the generated 2D set")
    run = os.path.join(logs, f"{dataset}_datagen")
    first, last = _falls(_metrics(run), n_train,
                         "training on the generated set")
    t = Trainer(load_config(run), run_dir=run, device=ctx.device,
                save_cfg=False)
    t.restore_weights()
    scene = np.array([[0.5, 0.08]], np.float32)       # scene 2_1
    cuda_fd.reset_launch_counts()
    with torch.inference_mode():
        rendered = render_density_sweep(t.apply, t.manifest, scene, ctx.f2)
    ctx.launches["render"] = dict(cuda_fd.launch_counts)
    sim_d = _load_frames(ctx.ds_2d, "d",
                         [f"2_1_{f}.npz" for f in range(ctx.f2)])
    if not (rendered.shape == (1, ctx.f2, 128, 96)
            and np.isfinite(rendered).all()
            and rendered[0, -1].sum() > rendered[0, 0].sum()
            and ctx.launches["render"] == expected_launches(
                {"curl2d_fused": 1})):
        raise AssertionError(f"render_density_sweep: {rendered.shape}, "
                             f"launches {ctx.launches['render']}")
    render_l2 = normalized_l2(rendered[0], sim_d[..., 0])
    print(f"phase 10 datagen loop: ok  main --arch de --is_train True "
          f"flagship bf16 batch 8 on the {15 * ctx.f2} frames the card just "
          f"wrote ({dataset}): {n_train} steps in {train_s:.2f} s, loss "
          f"{first:.4f} (step 20) -> {last:.4f} (step {n_train}), a 2D "
          f"step's "
          f"launches exact; render_density_sweep of scene 2_1 ({ctx.f2} "
          f"frames) "
          f"through the trained generator on the card (curl2d_fused once): "
          f"density vs the set's own d/ frames normalized L2 "
          f"{render_l2:.3f} (no gate: {n_train} steps of training)",
          flush=True)



def datagen_timing(ctx) -> dict:
    """Printed only: each solver alone in scene-frames/s at phase 10's
    scene batches, ``np.savez_compressed``'s share of the scene functions'
    wall time, and a profile line (idle share, launches) of a 2D jacobi
    and a 2D matched frame."""
    import torch

    from deepfluids_tpu_torch.datagen import liquid2d, smoke2d, smoke3d

    def frames_per_s(fn, frames: int, scenes_n: int) -> float:
        fn(2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(frames)
        torch.cuda.synchronize()
        return scenes_n * frames / (time.perf_counter() - t0)

    pos15 = torch.linspace(0.2, 0.8, 15)
    rad15 = torch.full((15,), 0.08)
    rates = {
        "2D jacobi, 15 scenes": frames_per_s(
            lambda n: smoke2d.simulate_smoke2d_batch(
                pos15, rad15, smoke2d.Smoke2DConfig(num_frames=n)), 40, 15),
        "2D matched, 4 scenes": frames_per_s(
            lambda n: smoke2d.simulate_smoke2d_batch(
                pos15[:4], rad15[:4], smoke2d.Smoke2DConfig(
                    num_frames=n, projection="matched")), 20, 4),
        "3D jacobi, 3 scenes": frames_per_s(
            lambda n: smoke3d.simulate_smoke3d_batch(
                [0.5, 1.0, 1.5], [0.04] * 3,
                smoke3d.Smoke3DConfig(num_frames=n)), 10, 3),
        "3D matched, 1 scene": frames_per_s(
            lambda n: smoke3d.simulate_smoke3d_batch(
                [1.0], [0.08], smoke3d.Smoke3DConfig(
                    num_frames=n, projection="matched")), 3, 1),
        "liquid, 4 scenes": frames_per_s(
            lambda n: liquid2d.simulate_liquid2d_batch(
                LIQUID_POS, LIQUID_RAD, liquid2d.Liquid2DConfig(num_frames=n)),
            20, 4),
    }
    print(f"phase 10 datagen timing [{ctx.card}]: solver alone (no copy, no "
          f"save), scene-frames/s: "
          + "; ".join(f"{k} {v:.1f}" for k, v in rates.items()), flush=True)
    total = sum(ctx.secs.values())
    print(f"phase 10 datagen timing [{ctx.card}]: np.savez_compressed takes "
          f"{sum(ctx.save_s.values()):.2f} s of the scene functions' "
          f"{total:.2f} s ({sum(ctx.save_s.values()) / total:.2f} of their "
          f"wall time); by scene: " + "; ".join(
              f"{k} {ctx.save_s[k]:.2f}/{ctx.secs[k]:.2f} s"
              for k in ctx.secs),
          flush=True)
    v15 = torch.zeros((15, 128, 96, 2), device=ctx.device)
    v15[..., 1] = 0.3
    r15 = torch.rand((15, 128, 96), device=ctx.device)
    m15 = smoke2d._source_mask(128, 96, pos15.to(ctx.device),
                               rad15.to(ctx.device), 0.08)
    for proj, s in (("jacobi", 15), ("matched", 4)):
        cfg2 = smoke2d.Smoke2DConfig(projection=proj)

        def one_frame():
            with torch.no_grad():
                smoke2d.step((v15[:s], r15[:s]), m15[:s], cfg2)

        # Outside the try below: a failed launch in the frame itself is a
        # failure, only the profiler's own is tolerated.
        one_frame()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            one_frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 5 * 1e3
        try:
            profile_line(f"datagen 2D {proj} frame, {s} scenes [{ctx.card}]",
                         one_frame, wall_ms)
        except Exception as e:  # noqa: BLE001 - diagnostics only
            print(f"profile datagen 2D {proj} frame: not measured "
                  f"({type(e).__name__}: {e})")
    return rates


def phase_datagen(device, root: str, card: str) -> dict:
    """Phase 10: the datagen on the card through the scene functions, its
    checks, the loop closed through ``main``, and its timing lines.
    Returns the kernel launches of each datagen path."""
    import types

    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = types.SimpleNamespace(
        device=device, root=root, card=card,
        data=os.path.join(root, "datagen"), launches={}, secs={}, save_s={},
        shapes=set())
    datagen_setups(ctx)
    datagen_smoke2d(ctx)
    datagen_smoke3d(ctx)
    datagen_liquid_mov(ctx)
    datagen_steps(ctx)
    datagen_loop(ctx)
    rates = datagen_timing(ctx)
    # Every shape at which the setups and the scene runs gave a kernel
    # wrapper a tensor must be one phase 2 held the kernels against their
    # plain versions at.
    shapes = ctx.shapes
    unchecked = shapes - set(KERNEL_SHAPES[2]) - set(KERNEL_SHAPES[3])
    if unchecked or not shapes:
        raise AssertionError(f"the matched projection gave the kernels "
                             f"{sorted(shapes)}; not among phase 2's shapes: "
                             f"{sorted(unchecked)}")
    print(f"phase 10 datagen shapes: ok  the matched projection's setups "
          f"and scene runs gave the curl kernels "
          f"{sorted(shapes)}, each among the shapes of phase 2's "
          f"kernel-vs-plain check", flush=True)
    return {"launches": ctx.launches, "rates": rates, "secs": ctx.secs}


# --- phase 11: the tools and the trainer's operational flags ---------------

# (timed calls, warm-up calls) of each bench_suite surface here: the
# surfaces' own defaults, three sweeps for e2e_sweep2d.
BENCH_RUNS = {"infer2d": (5, 2), "infer3d": (3, 2), "train2d": (10, 2),
              "train3d": (5, 1), "rollout": (5, 2), "rollout_decode": (3, 2),
              "e2e_sweep2d": (2, 1)}
# e2e_sweep2d's cut for the time limit: frames a scene of the 200.
E2E_FRAMES = 40
TOOLS_CUTS = {
    "e2e_sweep2d": f"21x5x{E2E_FRAMES} of 21x5x200 fields",
    "supervise": "120 steps (killed at 70, checkpoints every 50)",
    "regen_all": "2x1 scenes x 8 frames of 21x5x200",
    "solver_consistency 2d": "20 of 100 frames, ensemble 2 of 5",
    "solver_consistency matched": "10 of 100 frames, ensemble 2 of 5",
}
SUP_STEPS, SUP_DIE, SUP_SAVE = 120, 70, 50
TOL_SUPERVISED_LOSS = 0.25   # relative, killed run vs uninterrupted, bf16
PROFILE_STEPS = (5, 8)
KERNELS_2D = ("curl2d_kernel", "jacobian2d_kernel", "curl2d_bwd_kernel",
              "jacobian2d_bwd_kernel")


def bench_call_launches(name: str) -> dict:
    """The kernel launches of one timed call of a bench_suite surface at
    the shapes phase 11 runs it."""
    return {
        "infer2d": {"curl2d_fused": 16},
        "infer3d": {"curl3d_fused": 4},
        "train2d": {k: 16 * n for k, n in PATH_2D.step_launches.items()},
        "train3d": {k: 4 * n for k, n in PATH_3D.step_launches.items()},
        "rollout": {},
        "rollout_decode": {"curl2d_fused": 200},
        "e2e_sweep2d": {"curl2d_fused": -(-21 * 5 * E2E_FRAMES // 128)},
    }[name]


@contextlib.contextmanager
def recording_kernel_shapes(shapes: set):
    """Adds to ``shapes`` the shape (batch + spatial) of every kernel
    launch."""
    from deepfluids_tpu_torch.ops import cuda_fd

    launch = cuda_fd._launch

    def recording(name, entry, ins, out_channels):
        shapes.add(tuple(ins[0].shape[:-1]))
        return launch(name, entry, ins, out_channels)

    cuda_fd._launch = recording
    try:
        yield
    finally:
        cuda_fd._launch = launch


def _counted(ctx, tag: str, fn, want: dict | None):
    """``fn()`` from launch counts at 0, its launches kept under ``tag``;
    they must be ``want`` (a dict of the kernels launched; None: any)."""
    import torch

    from deepfluids_tpu_torch.ops import cuda_fd

    cuda_fd.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording_kernel_shapes(ctx.shapes):
        out = fn()
    torch.cuda.synchronize()
    ctx.secs[tag] = time.perf_counter() - t0
    ctx.launches[tag] = dict(cuda_fd.launch_counts)
    if want is not None and ctx.launches[tag] != expected_launches(want):
        raise AssertionError(f"tools {tag} launched {ctx.launches[tag]}, "
                             f"want {want}")
    return out


def tools_bench(ctx) -> None:
    """Each bench_suite surface once at its full shapes."""
    from deepfluids_tpu_torch.tools import bench_suite

    for name, (iters, warmup) in BENCH_RUNS.items():
        call = bench_call_launches(name)
        kw = {"num_frames": E2E_FRAMES} if name == "e2e_sweep2d" else {}
        # The sweep warms up with one batch outside its timed region; the
        # others make warm-up calls, the timed calls and one call under the
        # flop counter.
        calls = iters if name == "e2e_sweep2d" else warmup + iters + 1
        total = {k: n * calls + (warmup if name == "e2e_sweep2d" else 0)
                 for k, n in call.items()}
        rec = _counted(ctx, f"bench_{name}", lambda: bench_suite.run(
            name, ctx.device, ctx.out, iters=iters, warmup=warmup, **kw),
            total)
        if rec["launches"] != call or rec["backend"] != "cuda":
            raise AssertionError(f"bench {name}: a timed call launched "
                                 f"{rec['launches']}, want {call}: {rec}")
        secs = rec["seconds_per_call"]
        if len(secs) != iters or not min(secs) > 0:
            raise AssertionError(f"bench {name}: seconds {secs}")
        ctx.bench[name] = rec
        cut = f" (cut: {TOOLS_CUTS[name]})" if name in TOOLS_CUTS else ""
        print(f"phase 11 bench_suite {name} [{ctx.card}]: ok  "
              f"{rec['value']} {rec['metric']} ({rec['value_min']}.."
              f"{rec['value_max']} over {iters} timed calls of "
              f"{min(secs) * 1e3:.2f}..{max(secs) * 1e3:.2f} ms); "
              f"{rec['detail']}{cut}; launches a timed call {call or 'none'}"
              f", exact; conv+matmul "
              f"{rec.get('tflops_per_sec', 'not counted')} TFLOP/s",
              flush=True)


def _flagship_2d_flags(ctx, tag: str, max_step: int) -> list[str]:
    """``main`` flags of a flagship 2D run (bf16, batch 8, device cache) on
    phase 6's synthetic set."""
    return ["--is_train", "True", "--arch", "de", "--data_dir",
            ctx.train["2d"]["data_dir"], "--dataset", PATH_2D.dataset,
            "--log_dir", ctx.logs, "--tag", tag, "--batch_size", "8",
            "--compute_dtype", "bfloat16", "--device_data_cache", "true",
            "--num_worker", "4", "--filters", str(FLAGSHIP["filters"]),
            "--num_conv", str(FLAGSHIP["num_conv"]), "--max_step",
            str(max_step)]


def _step_launches(steps: int, dumps: int) -> dict:
    return {k: steps * n + dumps * PATH_2D.forward_launches.get(k, 0)
            for k, n in PATH_2D.step_launches.items()}


def tools_supervise(ctx) -> None:
    """``supervise`` around a flagship 2D run killed in the middle, against
    the same run uninterrupted in this process."""
    import io

    from deepfluids_tpu_torch.tools import supervise

    sched = ["--log_step", "10", "--save_step", str(SUP_SAVE), "--test_step",
             str(SUP_SAVE)]
    killed = _flagship_2d_flags(ctx, "chip_sup", SUP_STEPS) + sched + [
        "--die_at_step", str(SUP_DIE)]
    said = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(said):
        rc = supervise.supervise(killed, max_restarts=2, backoff=0.5)
    sup_s = time.perf_counter() - t0
    said = said.getvalue()
    run = os.path.join(ctx.logs, f"{PATH_2D.dataset}_chip_sup")
    rows = _metrics(run)
    # the fault strikes before the step's own checkpoint
    resumed = (SUP_DIE - 1) // SUP_SAVE * SUP_SAVE
    want_steps = (list(range(10, SUP_DIE + 1, 10))
                  + list(range(resumed + 10, SUP_STEPS + 1, 10)))
    ckpts = sorted(int(n) for n in os.listdir(os.path.join(run,
                                                           "checkpoint")))
    if not (rc == 0 and "relaunch #1" in said and "relaunch #2" not in said
            and "child completed after 1 restart(s)" in said
            and os.path.exists(os.path.join(run, ".fault_injected"))
            and [r["step"] for r in rows] == want_steps
            and ckpts[-1] == SUP_STEPS):
        raise AssertionError(f"supervise: rc {rc}, said {said!r}, metrics "
                             f"steps {[r['step'] for r in rows]}, "
                             f"checkpoints {ckpts}")
    # The same run uninterrupted, here: its launches are exact (the
    # children's are counted in their own processes).
    ref = _flagship_2d_flags(ctx, "chip_sup_ref", SUP_STEPS) + sched
    _, ref_s, _ = _counted(
        ctx, "supervise_ref", lambda: _drive(
            ctx.device, ref, expected_launches(_step_launches(
                SUP_STEPS, SUP_STEPS // SUP_SAVE)), "the uninterrupted run"),
        _step_launches(SUP_STEPS, SUP_STEPS // SUP_SAVE))
    ctx.ref_run = os.path.join(ctx.logs, f"{PATH_2D.dataset}_chip_sup_ref")
    ref_rows = _metrics(ctx.ref_run)
    loss, ref_loss = rows[-1]["loss"], ref_rows[-1]["loss"]
    if not (np.isfinite(loss) and loss < rows[0]["loss"]
            and abs(loss - ref_loss) <= TOL_SUPERVISED_LOSS * ref_loss):
        raise AssertionError(f"supervised loss {loss} vs uninterrupted "
                             f"{ref_loss} (first {rows[0]['loss']})")
    ctx.supervise = {"supervised_s": sup_s, "uninterrupted_s": ref_s}
    print(f"phase 11 supervise [{ctx.card}]: ok  flagship 2D main() bf16 "
          f"batch 8 --device_data_cache in child processes, "
          f"--die_at_step {SUP_DIE} of {SUP_STEPS} (cut: "
          f"{TOOLS_CUTS['supervise']}): exit 0 after exactly one restart, "
          f".fault_injected present, resumed from step {resumed}, metrics "
          f"steps {want_steps[0]}..{SUP_DIE} then {resumed + 10}.."
          f"{SUP_STEPS}, checkpoints {ckpts}; loss at step {SUP_STEPS} "
          f"{loss:.4f} vs {ref_loss:.4f} uninterrupted in this process "
          f"(relative tol {TOL_SUPERVISED_LOSS}: bf16 on the card is not "
          f"bit-repeatable); {sup_s:.1f} s supervised (two process starts) "
          f"vs {ref_s:.1f} s uninterrupted", flush=True)


def tools_profile(ctx) -> None:
    """``--profile_steps`` on a short flagship run: the Chrome trace holds
    rows of the four 2D kernels.  A window that came back without them is
    run again (the profiler has lost records on this machine before)."""
    lo, hi = PROFILE_STEPS
    counts = {}
    for attempt in range(3):
        tag = f"chip_prof{attempt}"
        flags = _flagship_2d_flags(ctx, tag, 12) + [
            "--log_step", "4", "--save_step", "1000", "--test_step", "1000",
            "--profile_steps", f"{lo},{hi}", "--use_tensorboard", "true"]
        _counted(ctx, "profile_steps", lambda: _drive(
            ctx.device, flags, expected_launches(_step_launches(12, 0)),
            "the profiled run"), _step_launches(12, 0))
        trace = os.path.join(ctx.logs, f"{PATH_2D.dataset}_{tag}", "profile",
                             f"steps_{lo}_{hi}.trace.json")
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        names = [e.get("name", "") for e in events
                 if e.get("cat") == "kernel"]
        # "void curl2d_kernel<float>(...)": the name after a space or "::"
        counts = {k: sum(bool(re.search(rf"(^|[ :]){k}\b", n))
                         for n in names) for k in KERNELS_2D}
        if all(counts.values()):
            break
        print(f"phase 11 profile_steps: window {attempt} came back with "
              f"{len(names)} kernel rows, {counts}; running it again",
              flush=True)
    else:
        raise AssertionError(f"--profile_steps: no row of the hand-written "
                             f"kernels in three windows: {counts}")
    # --use_tensorboard on the same run: an event file beside
    # metrics.jsonl where the writer's dependency is installed, else the
    # run trained on with a warning (it reached step 12 either way).
    import importlib.util

    events = glob.glob(os.path.join(os.path.dirname(os.path.dirname(trace)),
                                    "events.out.tfevents.*"))
    has_tb = importlib.util.find_spec("tensorboard") is not None
    if has_tb != bool(events):
        raise AssertionError(f"--use_tensorboard: tensorboard installed "
                             f"{has_tb}, event files {events}")
    steps = hi - lo + 1
    print(f"phase 11 --use_tensorboard [{ctx.card}]: ok  tensorboard "
          f"{'installed' if has_tb else 'not installed'}: "
          f"{len(events)} event file"
          f"{f' of {os.path.getsize(events[0])} bytes' if events else 's'} "
          f"beside metrics.jsonl", flush=True)
    print(f"phase 11 --profile_steps {lo},{hi} [{ctx.card}]: ok  "
          f"{os.path.basename(trace)} ({os.path.getsize(trace) >> 10} KiB) "
          f"parses, {len(names)} kernel rows, of the hand-written kernels "
          f"{counts} ({steps} steps x 1/2/1/1 = "
          f"{[steps * n for n in (1, 2, 1, 1)]} expected), window "
          f"{attempt}", flush=True)


def tools_debug_nans(ctx) -> None:
    """``--debug_nans`` on a run whose newest checkpoint was poisoned with
    a NaN raises and names the step; the same run without the flag trains
    on."""
    import shutil

    import torch

    outcomes = {}
    for flag in ("true", "false"):
        run = os.path.join(ctx.logs, f"chip_nan_{flag}")
        shutil.copytree(ctx.ref_run, run)
        ckpt = os.path.join(run, "checkpoint", str(SUP_STEPS), "state.pt")
        state = torch.load(ckpt, map_location="cpu", weights_only=True)
        key = next(iter(state["params"]))
        state["params"][key].view(-1)[0] = float("nan")
        torch.save(state, ckpt)
        flags = _flagship_2d_flags(ctx, "unused", SUP_STEPS + 2) + [
            "--load_path", run, "--debug_nans", flag, "--log_step", "1",
            "--save_step", "1000", "--test_step", "1000"]
        try:
            result = _counted(ctx, f"debug_nans_{flag}", lambda: _drive(
                ctx.device, flags, expected_launches(_step_launches(
                    1 if flag == "true" else 2, 0)), "the poisoned run"),
                None)[0]
            outcomes[flag] = f"trained on, loss {result['loss']}"
        except FloatingPointError as e:
            outcomes[flag] = f"raised: {e}"
    if not (outcomes["true"].startswith("raised")
            and f"step {SUP_STEPS + 1}" in outcomes["true"]
            and outcomes["false"] == "trained on, loss nan"):
        raise AssertionError(f"--debug_nans: {outcomes}")
    print(f"phase 11 --debug_nans [{ctx.card}]: ok  a NaN written into "
          f"{key} of the step-{SUP_STEPS} checkpoint: with the flag "
          f"{outcomes['true']}; without it {outcomes['false']}", flush=True)


def tools_eval(ctx) -> None:
    """``eval_run`` on phase 6's 2D run and phase 7's integrator,
    ``rollout_eval`` on phase 7's rollout, ``latent_predictability`` on its
    codes."""
    from deepfluids_tpu_torch.tools import (
        eval_run,
        latent_predictability,
        rollout_eval,
    )

    common = ["--out", ctx.out]
    # 64 samples at --test_batch_size 32: the curl once a generated batch.
    de = _counted(ctx, "eval_run_de", lambda: eval_run.main(
        [ctx.train["2d"]["run"], "64", "chip_smoke"] + common),
        {"curl2d_fused": 2})
    mov, path = ctx.mov, PATH_MOV
    # The integrator: 8 sampled frames of every scene decoded in one batch
    # for the predicted and for the true codes, then scene 0's rollout and
    # its AE floor in batches of 32.
    nn = _counted(ctx, "eval_run_nn", lambda: eval_run.main(
        [mov["nn_run"], "128", "chip_smoke", "--ae_load_path", mov["run"]]
        + common), {"curl2d_fused": 2 + 2 * -(-path.frames // 32)})
    roll = _counted(ctx, "rollout_eval", lambda: rollout_eval.main(
        [mov["nn_run"], "chip_smoke"] + common), {})
    ds = os.path.join(mov["data_dir"], path.dataset)
    pred = _counted(ctx, "latent_predictability",
                    lambda: latent_predictability.main(
                        [ds, str(path.z_num), "4", "", "chip_smoke"]
                        + common), {})
    want = mov["rollout"]["rollout_field_l2"]
    if not (de["metric"] == "eval_de" and np.isfinite(de["l2_mean"])
            and de["step"] == PATH_2D.resume_steps
            and de["num_samples"] == 64
            and nn["metric"] == "eval_nn" and nn["step"] == path.nn_resume
            and np.isfinite(nn["z_mae"]) and np.isfinite(nn["field_rmse"])
            and nn["rollout_steps"] == path.frames
            and "rollout_field_l2" in nn and "ae_floor_field_l2" in nn):
        raise AssertionError(f"eval_run: de {de}, nn {nn}")
    # rollout_eval scores the file main wrote with main's own scorer.
    got = {k: roll[k] for k in want}
    if got != want or roll["metric"] != "rollout_field_l2":
        raise AssertionError(f"rollout_eval {got} != main's {want}")
    if not (pred["holdout_scenes"] == 4
            and len(pred["r2_holdout_per_scene"]) == 4
            and np.isfinite(pred["r2_holdout_median"])
            and pred["r2_train_median"] <= 1.0):
        raise AssertionError(f"latent_predictability: {pred}")
    print(f"phase 11 eval tools [{ctx.card}]: ok  eval_run 2D run (step "
          f"{de['step']}, 64 samples): l2_mean {de['l2_mean']:.4f} rmse "
          f"{de['rmse']:.4f}, curl2d_fused 2 = 2 batches; eval_run "
          f"integrator (step {nn['step']}, {nn['num_samples']} scenes, "
          f"--ae_load_path): z_mae {nn['z_mae']:.4f}, field_rmse "
          f"{nn['field_rmse']:.4f}, rollout_field_l2 median "
          f"{nn['rollout_field_l2']['l2_median']} (AE floor "
          f"{nn['ae_floor_field_l2']['l2_median']}), curl2d_fused "
          f"{ctx.launches['eval_run_nn']['curl2d_fused']}; rollout_eval "
          f"l2_median {roll['l2_median']} = main()'s "
          f"{want['l2_median']} (scene {roll['scene']}, "
          f"{roll['rollout_steps']} frames); latent_predictability "
          f"(holdout 4 of {PATH_MOV.scenes}): R2 train "
          f"{pred['r2_train_median']} holdout {pred['r2_holdout_median']}",
          flush=True)


def tools_weights_io(ctx) -> None:
    """``export_run`` of phase 6's 2D run, read back bit for bit."""
    from deepfluids_tpu_torch.config import load_config
    from deepfluids_tpu_torch.tools import weights_io
    from deepfluids_tpu_torch.train.trainer import Trainer

    run = ctx.train["2d"]["run"]
    path = _counted(ctx, "weights_io", lambda: weights_io.export_run(
        run, os.path.join(ctx.root, "export.npz")), {})
    t = Trainer(load_config(run), run_dir=run, device=ctx.device,
                save_cfg=False)
    t.restore_checkpoint()
    template = weights_io.model_template(t.model)
    n = 0
    for mode in ("exact", "by_shape"):
        got = weights_io.flatten_params(weights_io.import_npz(
            path, template, mode=mode))
        if sorted(got) != sorted(template):
            raise AssertionError(f"weights_io {mode}: keys differ")
        for k, v in template.items():
            if not np.array_equal(got[k], v):
                raise AssertionError(f"weights_io {mode}: {k} differs")
        n = len(got)
    # and into a freshly initialised model, which then generates the same
    fresh = Trainer(load_config(run), run_dir=run, device=ctx.device,
                    save_cfg=False)
    weights_io.import_into_model(path, fresh.model)
    import torch

    for k, v in t.model.state_dict().items():
        if not torch.equal(fresh.model.state_dict()[k], v):
            raise AssertionError(f"weights_io: {k} differs after the load")
    print(f"phase 11 weights_io [{ctx.card}]: ok  export_run of the step-"
          f"{t.step} checkpoint -> {os.path.getsize(path) >> 10} KiB, "
          f"import_npz exact and by_shape: {n} tensors bit for bit, and "
          f"loaded into a freshly initialised model its state_dict is the "
          f"checkpoint's", flush=True)


def tools_regen_all(ctx) -> None:
    """``regen_all`` at a cut grid: generate (a datagen child process on
    the card), verify, ``--verify_only``, and a removed file refused."""
    from deepfluids_tpu_torch.tools import regen_all

    name = "smoke_pos21_size5_m"
    data = os.path.join(ctx.root, "fleet")
    argv = ["--only", name, "--num-a", "2", "--num-b", "1", "--num-frames",
            "8", "--data_dir", data, "--log_dir", ctx.logs, "--out",
            ctx.out]
    t0 = time.perf_counter()
    regen_all.main(argv)
    gen_s = time.perf_counter() - t0
    regen_all.main(argv + ["--verify_only"])
    victim = os.path.join(data, name, "d", "1_0_7.npz")
    os.remove(victim)
    try:
        regen_all.main(argv + ["--verify_only"])
        code = 0
    except SystemExit as e:
        code = e.code
    if not code or "d: 15 files, expected 16" not in str(code):
        raise AssertionError(f"regen_all accepted a fleet with a file "
                             f"removed: exit {code!r}")
    with open(ctx.out) as f:
        rows = [r for r in map(json.loads, f)
                if r.get("metric") == "datagen_fleet"]
    if not (len(rows) == 2 and rows[0]["files"] == {"v": 16, "d": 16}
            and rows[0]["backend"] == "cuda" and rows[0]["cut"]
            and "wall_s" in rows[0] and "wall_s" not in rows[1]):
        raise AssertionError(f"regen_all records: {rows}")
    print(f"phase 11 regen_all [{ctx.card}]: ok  --only {name} (cut: "
          f"{TOOLS_CUTS['regen_all']}, matched): generated by a datagen "
          f"child on the card and verified in {gen_s:.1f} s (the child "
          f"{rows[0]['wall_s']} s), 16 + 16 files, sample |v| mean "
          f"{rows[0]['sample_mean_abs']:.4f}; --verify_only passes; with "
          f"{os.path.basename(victim)} removed it exits with "
          f"{str(code)[:90]!r}", flush=True)


def tools_solver_consistency(ctx) -> None:
    """``solver_consistency`` 2D with the float64 CG on the card, and the
    matched study, which launches the curl kernels."""
    from deepfluids_tpu_torch.tools import solver_consistency

    rec = _counted(ctx, "solver_consistency_2d",
                   lambda: solver_consistency.main(
                       ["2d", "--frames", "20", "--ensemble", "2", "--out",
                        ctx.out]), {})
    res = rec["div_residual_vs_unprojected"]
    if not (rec["cg_compact_residual_rel"] < 1e-5
            and res["jacobi_20"] > res["jacobi_50"] > res["jacobi_100"]
            and rec["backend"] == "cuda"
            and rec["resolution"] == [128, 96]):
        raise AssertionError(f"solver_consistency 2d: {rec}")
    # 10 frames x (8 V-cycles x 15 fine applications + 1) of the curl and
    # of its transpose, the two scenes as the batch; the multigrid setup is
    # phase 10's (cached), or built here with its 189 probes.
    frames = 10
    m = _counted(ctx, "solver_consistency_matched",
                 lambda: solver_consistency.main(
                     ["matched", "--frames", str(frames), "--ensemble", "2",
                      "--out", ctx.out]), None)
    got = ctx.launches["solver_consistency_matched"]
    per_run = frames * (8 * 15 + 1)
    fd_other = {k: v for k, v in got.items()
                if k not in ("curl2d_fused", "curl2d_bwd") and v}
    if (got["curl2d_fused"] != got["curl2d_bwd"] or fd_other
            or got["curl2d_fused"] not in (per_run, per_run + 189)
            or not np.isfinite(m["ke_stat_rel_matched_vs_cg"])):
        raise AssertionError(f"solver_consistency matched: launches {got}, "
                             f"want {per_run} (+189 with the setup); {m}")
    print(f"phase 11 solver_consistency [{ctx.card}]: ok  2d at 128x96 (cut:"
          f" {TOOLS_CUTS['solver_consistency 2d']}) in {rec['secs']} s: "
          f"float64 CG compact residual {rec['cg_compact_residual_rel']:.2e}"
          f", divergence left vs unprojected {res}, velocity distance to "
          f"the converged field {rec['vel_rel_l2_to_converged']}, KE gap "
          f"jacobi vs cg {rec['ke_stat_rel_jacobi_vs_cg']} (chaos control "
          f"{rec['ke_stat_rel_chaos_control']}), no FD launch; matched "
          f"(cut: {TOOLS_CUTS['solver_consistency matched']}) in "
          f"{m['secs']} s: KE gap matched vs cg "
          f"{m['ke_stat_rel_matched_vs_cg']}, jacobi vs cg "
          f"{m['ke_stat_rel_jacobi_vs_cg']}; curl2d_fused = curl2d_bwd = "
          f"{got['curl2d_fused']} launches", flush=True)


def tools_make_goldens(ctx) -> None:
    """``make_goldens --check`` on the card, TF32 off."""
    from deepfluids_tpu_torch.tools import make_goldens

    out = os.path.join(ctx.root, "goldens")
    res = _counted(ctx, "make_goldens", lambda: make_goldens.main(
        ["--out", out, "--check"]),
        {"curl2d_fused": 2, "jacobian2d_fused": 1, "curl3d_fused": 1,
         "jacobian3d_fused": 1})
    worst = max(res["max_l2"].values())
    if not worst < TOL_PARITY or len(os.listdir(out)) != 4:
        raise AssertionError(f"make_goldens --check: {res}")
    print(f"phase 11 make_goldens --check [{ctx.card}]: ok  fd2d, fd3d, "
          f"smoke2d, generator2d computed on the card into "
          f"{os.path.basename(out)}/ (never tests/golden), max [B] "
          f"normalized L2 vs the reference's dumps {worst:.2e} (gate "
          f"{TOL_PARITY})", flush=True)


def phase_tools(device, root: str, card: str, train: dict,
                mov: dict) -> dict:
    """Phase 11: the tools and the trainer's operational flags on the card,
    through their entry points.  Returns the kernel launches of each tool
    path and the bench records."""
    import types

    import torch

    torch.backends.cudnn.allow_tf32 = True   # as a user's run finds them
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = types.SimpleNamespace(
        device=device, root=root, card=card, train=train, mov=mov,
        logs=os.path.join(root, "tools_logs"),
        out=os.path.join(root, "BENCHMARKS_torch.jsonl"), launches={},
        secs={}, shapes=set(), bench={}, supervise={}, ref_run="")
    for fn in (tools_bench, tools_supervise, tools_profile, tools_debug_nans,
               tools_eval, tools_weights_io, tools_regen_all,
               tools_solver_consistency, tools_make_goldens):
        timed(f"phase 11 {fn.__name__}", fn, ctx)
    unchecked = ctx.shapes - set(KERNEL_SHAPES[2]) - set(KERNEL_SHAPES[3])
    if unchecked or not ctx.shapes:
        raise AssertionError(f"the tools gave the kernels {sorted(ctx.shapes)}"
                             f"; not among phase 2's shapes: "
                             f"{sorted(unchecked)}")
    with open(ctx.out) as f:
        records = [json.loads(ln) for ln in f]
    bad = [r for r in records if r.get("backend") != "cuda"
           or r.get("power_limit_w") is None or not r.get("ts")]
    if bad or os.path.exists(os.path.join(REPO, "BENCHMARKS_torch.jsonl")):
        raise AssertionError(f"tool records: {len(bad)} without the card's "
                             f"stamp, e.g. {bad[:1]}; or a record file was "
                             f"left in the checkout")
    print(f"phase 11 tools: ok  {len(records)} records in --out, each "
          f"stamped cuda / {records[0]['device']} / "
          f"{records[0]['power_limit_w']} W; every shape the tools gave a "
          f"kernel ({sorted(ctx.shapes)}) is among phase 2's", flush=True)
    return {"launches": ctx.launches, "bench": ctx.bench,
            "supervise": ctx.supervise}


# --- phase 12: several ranks -------------------------------------------------

PAR_SHARDS = (2, 4, 8)    # blocks of the simulated shards (a)
PAR_STEPS = 3             # steps of each run through main (b, c)
PAR_TIMED = 20            # timed train steps of each loop
PAR_TIMED_KNOBS = 5       # ... and of each loop of the knobs (e)
TOL_PAR_LOSS = 1e-5       # relative, a run on ranks vs the plain loop
# (e): the generator's knobs on ranks, each model's flags: the spectral
# residuals alone, the grid decoder's basis injection alone, and every knob
# of the knob path
PAR_KNOBS = {"spectral": ("--spectral_modes", "8"),
             "grid": ("--decoder", "grid", "--grid_levels", "4",
                      "--grid_features", "4", "--grid_rank", "8"),
             "knobs": KNOB_FLAGS}
SPATIAL = ("--spatial_shard", "true")
# One rank of phase 12's groups: the jobs of a spec file, each a list of
# main's flags and a mode ("main": main.cli; "grads": the loss and the
# gradients of one global batch from the run's weights.npz, with cuDNN off,
# and with "smooth" the models' leaky ReLU swapped for the smooth stand-in;
# "timed": ms per train step), with the batch dims and the rows (axis 1) of
# each kernel's input and the launches of each job; rank 0 writes the
# gradients.
PAR_WORKER = r"""
import json, sys, time
import numpy as np, torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from deepfluids_tpu_torch import main as entry, parallel
from deepfluids_tpu_torch.config import get_config
from deepfluids_tpu_torch.models import activation
from deepfluids_tpu_torch.ops import cuda_fd
from deepfluids_tpu_torch.train.trainer import Trainer
leaky = activation.bias_leaky_relu
seen, rows = set(), {}
launch = cuda_fd._launch
def recording(name, entry_, ins, outs):
    seen.add(int(ins[0].shape[0]))
    rows.setdefault(name, set()).add(int(ins[0].shape[1]))
    return launch(name, entry_, ins, outs)
cuda_fd._launch = recording
dev = parallel.init_distributed("cuda")
rank = parallel.world()[0]
results = []
for job in json.load(open(sys.argv[1])):
    cuda_fd.reset_launch_counts()
    seen.clear()
    rows.clear()
    activation.bias_leaky_relu = (activation.bias_smooth if job.get("smooth")
                                  else leaky)
    out = {"name": job["name"]}
    if job["mode"] == "main":
        entry.cli(job["argv"] + ["--device", "cuda"])
    else:
        t = Trainer(get_config(job["argv"]), run_dir=job["run_dir"],
                    device=dev, save_cfg=False)
        t.restore_weights()
        if job["mode"] == "grads":
            d = np.load(job["batch"])
            torch.backends.cudnn.enabled = False
            loss, grads = t._loss_and_grads(d["a"], d["b"])
            torch.backends.cudnn.enabled = True
            out["loss"] = loss
            if rank == 0:
                np.savez(job["out"], **grads)
        else:
            t.capture = False
            run = t._chunk_runner(job["steps"] + 2, 0, 1)
            for _ in range(2):
                run(1)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(job["steps"]):
                run(1)
            torch.cuda.synchronize(dev)
            out["ms"] = (time.perf_counter() - t0) * 1e3 / job["steps"]
    torch.cuda.synchronize(dev)
    out["launches"] = dict(cuda_fd.launch_counts)
    out["batch_dims"] = sorted(seen)
    out["rows"] = {k: sorted(v) for k, v in rows.items()}
    results.append(out)
print("PAR_RESULT " + json.dumps({"rank": rank, "jobs": results}),
      flush=True)
"""


def par_simulated(device) -> dict:
    """(a) The flagship fields cut into n blocks in this process: kernels
    #1-#8 on the haloed blocks, put back together, bit-equal to the
    whole-field kernels, forward and backward, each launched n times."""
    import torch

    from deepfluids_tpu_torch.ops import cuda_fd
    from deepfluids_tpu_torch.parallel import halo

    gen = torch.Generator(device).manual_seed(12)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device)

    cases = {   # kernel: (forward, backward, input, cotangents)
        "curl2d": (cuda_fd.curl2d_fused, cuda_fd.curl2d_bwd,
                   rand(8, 128, 96, 1), [rand(8, 128, 96, 2)]),
        "jacobian2d": (cuda_fd.jacobian2d_fused, halo._jac2d_bwd,
                       rand(8, 128, 96, 2),
                       [rand(8, 128, 96, 4), rand(8, 128, 96, 1)]),
        "curl3d": (cuda_fd.curl3d_fused, cuda_fd.curl3d_bwd,
                   rand(8, 32, 64, 112, 3), [rand(8, 32, 64, 112, 3)]),
        "jacobian3d": (cuda_fd.jacobian3d_fused, halo._jac3d_bwd,
                       rand(8, 32, 64, 112, 3),
                       [rand(8, 32, 64, 112, 9), rand(8, 32, 64, 112, 3)]),
    }
    launches = {"2d": expected_launches({}), "3d": expected_launches({})}

    def rows(blocks, i):
        return (blocks[i - 1][:, -1:] if i > 0 else None,
                blocks[i + 1][:, :1] if i < len(blocks) - 1 else None)

    for name, (fwd, bwd, x, gs) in cases.items():
        whole = fwd(x)
        whole = whole if isinstance(whole, tuple) else (whole,)
        whole_dx = bwd(*gs)
        for n in PAR_SHARDS:
            xb = [b.contiguous() for b in x.chunk(n, 1)]
            gb = [[b.contiguous() for b in g.chunk(n, 1)] for g in gs]
            cuda_fd.reset_launch_counts()
            outs, dxs = [], []
            for i in range(n):
                o = halo.halo_forward(fwd, xb[i], rows(xb, i), i, n)
                outs.append(o if isinstance(o, tuple) else (o,))
                dxs.append(halo.halo_backward(
                    bwd, [g[i] for g in gb], [rows(g, i) for g in gb], i,
                    n))
            torch.cuda.synchronize()
            counts = dict(cuda_fd.launch_counts)
            fname = name + "_fused"
            bname = name + "_bwd"
            if counts != expected_launches({fname: n, bname: n}):
                raise AssertionError(f"(a) {name} over {n} blocks launched "
                                     f"{counts}, want {n} of each")
            for k, w in enumerate(whole):
                if not torch.equal(torch.cat([o[k] for o in outs], 1), w):
                    raise AssertionError(f"(a) {name} over {n} blocks: "
                                         f"output {k} != the whole field's")
            if not torch.equal(torch.cat(dxs, 1), whole_dx):
                raise AssertionError(f"(a) {name} over {n} blocks: the "
                                     "backward != the whole field's")
            nd = name[-2:]
            for k, v in counts.items():
                launches[nd][k] += v
    print(f"phase 12 (a) simulated shards: ok  kernels #1-#8 on the "
          f"haloed blocks of 2D [8,128,96] and 3D [8,32,64,112] fields cut "
          f"into {PAR_SHARDS} blocks (one process): outputs and backwards "
          f"bit-equal (f32) to the whole-field kernels; launches exactly n "
          f"of the forward and n of the backward kernel per cut", flush=True)
    return launches


def _par_spawn(ranks: int, backend: str, jobs: list[dict], path: str,
               env: dict | None = None) -> list[dict]:
    """``PAR_WORKER`` in ``ranks`` ranks on the card; each rank's results."""
    from deepfluids_tpu_torch.tools import launch_multihost

    with open(path, "w") as f:
        json.dump(jobs, f)
    saved = dict(os.environ)
    os.environ.update(env or {})
    try:
        rcs, outs = launch_multihost.spawn(
            [sys.executable, "-c", PAR_WORKER, path], ranks, backend,
            capture=True, timeout=600)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    res = []
    for rank, (rc, out) in enumerate(zip(rcs, outs)):
        line = [ln for ln in out.splitlines()
                if ln.startswith("PAR_RESULT ")]
        if rc or not line:
            raise AssertionError(f"phase 12 rank {rank} of {ranks} "
                                 f"({backend}) exit {rc}:\n{out[-4000:]}")
        res.append({j["name"]: j for j in json.loads(line[0][11:])["jobs"]})
    return res


def _grad_errors(got: dict, want: dict) -> tuple[str, float, float]:
    """Gradients against the replicated ones at the JAX tests' bar
    (``assert_allclose(rtol=1e-5, atol=1e-5)``, tests/test_train.py): the
    parameter with the largest excess ``|got - want| - 1e-5 |want|``, that
    excess (within the bar when <= 1e-5), and its error relative to the
    parameter's largest entry.  That relative error is not held to 1e-5:
    at the leaky ReLU's kink a pre-activation within rounding of zero takes
    either slope, so two exact computations that round otherwise disagree
    by a point's whole contribution (~1e-3 of a conv kernel's largest
    gradient entry, tests/test_torch_parallel.py's layouts on the CPU)."""
    if set(got) != set(want):
        raise AssertionError(f"gradient keys {sorted(got)} != "
                             f"{sorted(want)}")
    excess = {k: float((np.abs(got[k] - want[k])
                        - TOL_GRAD * np.abs(want[k])).max()) for k in want}
    worst = max(excess, key=excess.get)
    rel = float(np.abs(got[worst] - want[worst]).max()) / float(
        np.abs(want[worst]).max())
    return worst, excess[worst], rel


def _smooth_errors(got: dict, want: dict) -> tuple[str, float]:
    """Gradients against the one-process ones, both with the smooth
    activation: the parameter with the largest error relative to its own
    largest entry, and that error.  conv_out's bias lies in the curl's null
    space (its gradient is rounding noise), and a spectral gain's gradient
    is a cancelling sum over the spectrum, so both are held against the
    largest entry of all."""
    if set(got) != set(want):
        raise AssertionError(f"gradient keys {sorted(got)} != "
                             f"{sorted(want)}")
    scale = max(float(np.abs(w).max()) for w in want.values())
    errs = {k: float(np.abs(got[k] - w).max()) / (
        scale if k.endswith(("conv_out/bias", "gain_re", "gain_im"))
        else float(np.abs(w).max())) for k, w in want.items()}
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def _par_flags(data_dir: str, logs: str, tag: str, batch: int,
               steps: int) -> list[str]:
    """main's flags of a flagship 2D f32 run (l2 loss, the device cache)
    on phase 6's synthetic set."""
    return ["--is_train", "True", "--arch", "de", "--data_dir", data_dir,
            "--dataset", PATH_2D.dataset, "--log_dir", logs, "--tag", tag,
            "--batch_size", str(batch), "--compute_dtype", "float32",
            "--loss_norm", "l2", "--device_data_cache", "true",
            "--num_worker", "4", "--filters", str(FLAGSHIP["filters"]),
            "--num_conv", str(FLAGSHIP["num_conv"]), "--max_step",
            str(steps), "--log_step", "1", "--save_step", "1000",
            "--test_step", "1000"]


def _par_losses(logs: str, tag: str) -> list[float]:
    return [r["loss"] for r in _metrics(os.path.join(
        logs, f"{PATH_2D.dataset}_{tag}"))]


def _check_grads(name: str, res: list[dict], path: str, ref: tuple,
                 smooth: bool, one_step: dict) -> tuple:
    """A grads job of ``res`` (every rank's results; the gradients rank 0
    wrote to ``path``) against its one-process reference ``(loss,
    gradients)``: the loss within
    TOL_PAR_LOSS, the gradients at rtol / atol TOL_GRAD (leaky) or within
    TOL_GRAD of each parameter's largest entry (smooth), one step's
    launches on every rank.  Returns the errors."""
    with np.load(path) as d:
        got = {k: d[k] for k in d.files}
    loss, want = ref
    errs = (_smooth_errors(got, want) if smooth
            else _grad_errors(got, want)[:2])
    rel = abs(res[0][name]["loss"] - loss) / abs(loss)
    bad = [r for r, x in enumerate(res) if x[name]["launches"] != one_step]
    if bad or errs[1] > TOL_GRAD or rel > TOL_PAR_LOSS:
        raise AssertionError(f"(e) {name}: loss {res[0][name]['loss']} vs "
                             f"{loss}, gradient error {errs}, launches "
                             f"{[x[name]['launches'] for x in res]}, want "
                             f"{one_step} each")
    return rel, *errs


def par_knobs(device, root: str, card: str, ctx: dict) -> dict:
    """(e) The generator's knobs on ranks at the flagship width (f32, l2,
    TF32 off; gradients with cuDNN off): on the gloo pair, the spectral
    residuals and the basis injection under --spatial_shard (one batch's
    gradients from random gains and bases, leaky and smooth, against this
    process's) and the knob path (KNOB_FLAGS) through main; on four gloo
    ranks, rows x channels (--spatial_shard --num_model_shards 2, 2 x 2):
    the knob model's gradients, main, its checkpoint restored in one
    process bit for bit and resumed there for a step.  The kernels read
    the rows of their rank's block, every rank launches one step's kernels
    a step.  Returns the launches of each path and the step times."""
    from deepfluids_tpu_torch.config import get_config
    from deepfluids_tpu_torch.main import main
    from deepfluids_tpu_torch.models import state_dict_to_flax
    from deepfluids_tpu_torch.ops import cuda_fd
    from deepfluids_tpu_torch.train.trainer import Trainer

    pair, refs, rows = ctx["pair"], ctx["refs"], ctx["rows"]
    one_step, logs, data_dir = ctx["one_step"], ctx["logs"], ctx["data_dir"]
    main_step = {k: PAR_STEPS * v for k, v in one_step.items()}

    def check(name: str, res: list[dict], ref: tuple) -> tuple:
        return _check_grads(name, res, os.path.join(root, f"par_{name}.npz"),
                            ref, name.startswith("ssp"), one_step)

    def held_rows(res: list[dict], names: list[str], block) -> None:
        for r, x in enumerate(res):
            for name in names:
                if x[name]["rows"] != rows[block(r)]:
                    raise AssertionError(
                        f"(e) {name} rank {r}: the kernels' inputs had "
                        f"{x[name]['rows']} rows, want {rows[block(r)]}")

    errs = {}
    for name in ("spectral", "grid"):
        _, leaky, smooth = refs[name]
        errs[f"sp_{name}"] = check(f"sp_{name}", pair, leaky)
        errs[f"ssp_{name}"] = check(f"ssp_{name}", pair, smooth)
    if any(x["main_knobs"]["launches"] != main_step for x in pair):
        raise AssertionError(f"(e) main_knobs launched "
                             f"{[x['main_knobs']['launches'] for x in pair]}"
                             f", want {main_step} a rank")
    held_rows(pair, ["sp_spectral", "sp_grid", "ssp_spectral", "ssp_grid",
                     "main_knobs"], lambda r: r)
    rel_pair = ctx["same"](_par_losses(logs, "par_gloo_knobs"),
                           ctx["plain"], "(e) the knob path on the pair")
    print(f"phase 12 (e) the knobs on the gloo pair, --spatial_shard: ok  "
          f"one f32 batch of 8 from random gains and bases, cuDNN off: "
          + "; ".join(f"{n} loss within {e[0]:.2e}, gradients "
                      + (f"within {e[2]:.2e} of the largest entry ({e[1]})"
                         if n.startswith("ssp") else
                         f"worst excess {e[2]:.2e} ({e[1]})")
                      for n, e in errs.items())
          + f"; main with {' '.join(KNOB_FLAGS)} --spatial_shard true: "
          f"{PAR_STEPS} losses within {rel_pair:.2e} of the plain loop's, "
          f"launches {main_step} a rank; the kernels read "
          f"{pair[0]['sp_spectral']['rows']} rows on rank 0 and "
          f"{pair[1]['sp_spectral']['rows']} on rank 1", flush=True)

    # four gloo ranks: 2 rows x 2 channels
    t0 = time.perf_counter()
    quad_flags = list(KNOB_FLAGS) + list(SPATIAL) + ["--num_model_shards",
                                                     "2"]
    quad = _par_spawn(4, "gloo", [
        {"name": f"{pre}sptp_knobs", "mode": "grads", "smooth": pre == "s",
         "run_dir": ctx["runs"][f"par_{pre}sptp_knobs"],
         "batch": ctx["batch"],
         "out": os.path.join(root, f"par_{pre}sptp_knobs.npz"),
         "argv": _par_flags(data_dir, logs, f"par_g_{pre}sptp", 8, 1)
         + quad_flags} for pre in ("", "s")] + [
        {"name": "main_quad", "mode": "main",
         "argv": _par_flags(data_dir, logs, "par_quad", 8, PAR_STEPS)
         + quad_flags},
        {"name": "timed_quad", "mode": "timed", "steps": PAR_TIMED_KNOBS,
         "run_dir": ctx["runs"]["par_time_knobs4"],
         "argv": _par_flags(data_dir, logs, "par_t4k", 8, 1000)
         + quad_flags}], os.path.join(root, "par_quad.json"),
        {"NVIDIA_TF32_OVERRIDE": "0"})
    quad_s = time.perf_counter() - t0
    _, leaky, smooth = refs["knobs"]
    errs4 = {"sptp_knobs": check("sptp_knobs", quad, leaky),
             "ssptp_knobs": check("ssptp_knobs", quad, smooth)}
    if any(x["main_quad"]["launches"] != main_step for x in quad):
        raise AssertionError(f"(e) main_quad launched "
                             f"{[x['main_quad']['launches'] for x in quad]}"
                             f", want {main_step} a rank")
    held_rows(quad, ["sptp_knobs", "ssptp_knobs", "main_quad"],
              lambda r: r // 2)
    rel_quad = ctx["same"](_par_losses(logs, "par_quad"), ctx["plain"],
                           "(e) the knob path on 2 x 2 ranks")
    # the 2 x 2 checkpoint in one process: bit for bit, then a step more
    run = os.path.join(logs, f"{PATH_2D.dataset}_par_quad")
    one_flags = _par_flags(data_dir, logs, "par_quad", 8, PAR_STEPS + 1)
    one_flags += list(KNOB_FLAGS)
    t = Trainer(get_config(one_flags), run_dir=run, device=device,
                save_cfg=False)
    if t.restore_checkpoint() != PAR_STEPS:
        raise AssertionError("(e) the 2 x 2 checkpoint's step")
    with np.load(os.path.join(run, "weights.npz")) as d:
        written = {k: d[k] for k in d.files}
    restored = state_dict_to_flax(t.model.state_dict())
    if set(written) != set(restored) or any(
            not np.array_equal(written[k], v) for k, v in restored.items()):
        raise AssertionError("(e) the 2 x 2 checkpoint restored in one "
                             "process != its weights.npz")
    cuda_fd.reset_launch_counts()
    main(get_config(one_flags + ["--load_path", run]), device=device)
    resumed = dict(cuda_fd.launch_counts)
    rows_run = _metrics(run)
    if [r["step"] for r in rows_run] != list(range(1, PAR_STEPS + 2)) or (
            not np.isfinite(rows_run[-1]["loss"])) or resumed != one_step:
        raise AssertionError(f"(e) resumed in one process: metrics "
                             f"{rows_run}, launches {resumed}")
    times = {"gloo2_knobs_ms": max(x["timed_knobs"]["ms"] for x in pair),
             "gloo4_knobs_ms": max(x["timed_quad"]["ms"] for x in quad)}
    print(f"phase 12 (e) the knobs on 4 gloo ranks, 2 rows x 2 channels: "
          f"ok  one f32 batch of 8 ({' '.join(KNOB_FLAGS)}, random gains and "
          f"bases, cuDNN off): "
          + "; ".join(f"{n} loss within {e[0]:.2e}, gradients "
                      + (f"within {e[2]:.2e} of the largest entry ({e[1]})"
                         if n.startswith("ssp") else
                         f"worst excess {e[2]:.2e} ({e[1]})")
                      for n, e in errs4.items())
          + f"; main {PAR_STEPS} steps: losses within {rel_quad:.2e} of the "
          f"plain loop's, launches {main_step} a rank; the kernels read "
          f"{[x['main_quad']['rows']['curl2d_fused'] for x in quad]} rows "
          f"(ranks 0-3); its checkpoint restored in one process bit for "
          f"bit and resumed to step {PAR_STEPS + 1} (loss "
          f"{rows_run[-1]['loss']:.5f}, launches {resumed}); the group's "
          f"processes {quad_s:.2f} s", flush=True)
    print(f"phase 12 (e) step times [{card}]: knob path f32 train step "
          f"(recorded, not targets): two gloo ranks --spatial_shard batch 8 "
          f"{times['gloo2_knobs_ms']:.2f} ms; four gloo ranks 2 rows x 2 "
          f"channels batch 8 {times['gloo4_knobs_ms']:.2f} ms", flush=True)

    def summed(res: list[dict], name: str) -> dict:
        return {k: sum(x[name]["launches"][k] for x in res)
                for k in one_step}

    return {"launches": {"sp_spectral_grads_2d": summed(pair, "sp_spectral"),
                         "sp_grid_grads_2d": summed(pair, "sp_grid"),
                         "sp_knobs_2d": summed(pair, "main_knobs"),
                         "sptp_knobs_grads_2d": summed(quad, "sptp_knobs"),
                         "sptp_knobs_2d": summed(quad, "main_quad"),
                         "sptp_resume_2d": resumed},
            "times": times}


def phase_parallel(device, root: str, card: str, train: dict) -> dict:
    """Phase 12: the parallel layer on the card.  Returns the launches of
    each of its paths and the step times."""
    import shutil

    import torch

    from deepfluids_tpu_torch.config import get_config
    from deepfluids_tpu_torch.main import main
    from deepfluids_tpu_torch.models import activation
    from deepfluids_tpu_torch.ops import cuda_fd
    from deepfluids_tpu_torch.tools import dryrun
    from deepfluids_tpu_torch.train.trainer import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the launcher's one-rank demo runs beside (a) and the plain runs
    demo = subprocess.Popen(
        [sys.executable, "-m", "deepfluids_tpu_torch.tools.launch_multihost",
         "--num_processes", "1"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    launches = {}
    sim = timed("phase 12 (a)", par_simulated, device)
    launches["sp_sim_2d"], launches["sp_sim_3d"] = sim["2d"], sim["3d"]
    data_dir = train["2d"]["data_dir"]
    logs = os.path.join(root, "par_logs")
    no_tf32 = {"NVIDIA_TF32_OVERRIDE": "0"}
    step = expected_launches(PATH_2D.step_launches)

    def run_main(tag: str, batch: int, extra=()) -> list[float]:
        cuda_fd.reset_launch_counts()
        main(get_config(_par_flags(data_dir, logs, tag, batch, PAR_STEPS)
                        + list(extra)), device=device)
        want = {k: PAR_STEPS * v for k, v in step.items()}
        if dict(cuda_fd.launch_counts) != want:
            raise AssertionError(f"the plain loop {tag} launched "
                                 f"{cuda_fd.launch_counts}, want {want}")
        return _par_losses(logs, tag)

    def same(got: list[float], want: list[float], what: str) -> float:
        rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        if len(got) != len(want) or rel > TOL_PAR_LOSS:
            raise AssertionError(f"{what}: losses {got} vs the plain loop "
                                 f"{want}")
        return rel

    # (b) a one-rank NCCL group through main, against the plain loop
    t0 = time.perf_counter()
    plain8 = run_main("par_plain8", 8)
    plain16 = run_main("par_plain16", 16)
    ref = Trainer(get_config(_par_flags(data_dir, logs, "par_ref", 8, 1)),
                  device=device)
    ref.save_checkpoint()              # weights.npz of the grads jobs
    a, b = ref.bm.step_batch(1)
    batch_npz = os.path.join(root, "par_batch.npz")
    np.savez(batch_npz, a=a, b=b)
    # The gradients are compared with cuDNN off (convolutions as cuBLAS
    # GEMMs, f32, TF32 off) on both sides: cuDNN picks its algorithms by
    # shape, and the algorithms of a half batch or a haloed block round
    # otherwise than the whole batch's.  The floor: the same process's
    # gradient as the mean of two half batches.
    torch.backends.cudnn.enabled = False
    want_loss, want_grads = ref._loss_and_grads(a, b)
    halves = [ref._loss_and_grads(a[h:h + 4], b[h:h + 4])[1] for h in (0, 4)]
    floor = _grad_errors({k: (halves[0][k] + halves[1][k]) / 2
                          for k in want_grads}, want_grads)
    gmax = max(float(np.abs(g).max()) for g in want_grads.values())
    with activation_as(activation.bias_smooth):
        smooth_loss, smooth_grads = ref._loss_and_grads(a, b)
    # (e)'s references: each knob model from seeded random gains and bases
    # (zero at init), its leaky and smooth gradients in this process
    knob_refs = {}
    gen = torch.Generator().manual_seed(10)
    for name, extra in PAR_KNOBS.items():
        kref = Trainer(get_config(_par_flags(data_dir, logs,
                                             f"par_ref_{name}", 8, 1)
                                  + list(extra)), device=device)
        with torch.no_grad():
            for n, p in kref.model.named_parameters():
                if n.split(".")[-1].startswith(("gain_", "basis_")):
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
        kref.save_checkpoint()
        leaky_ref = kref._loss_and_grads(a, b)
        with activation_as(activation.bias_smooth):
            knob_refs[name] = (kref.run_dir, leaky_ref,
                               kref._loss_and_grads(a, b))
    torch.backends.cudnn.enabled = True
    for name, (loss_l, loss_s) in {
            "plain": (want_loss, smooth_loss),
            **{k: (v[1][0], v[2][0]) for k, v in knob_refs.items()}}.items():
        if abs(loss_s - loss_l) <= TOL_PAR_LOSS * abs(loss_l):
            raise AssertionError(f"the smooth stand-in is not live ({name}):"
                                 f" loss {loss_s} vs the leaky {loss_l}")
    plain_knobs = run_main("par_plain_knobs", 8, KNOB_FLAGS)
    prep_s = time.perf_counter() - t0
    timed_jobs = {}
    for tag in ("par_time1", "par_time2", "par_sp", "par_tp", "par_dp",
                "par_sdp", "par_ssp", "par_stp"):
        run = os.path.join(root, "par_runs", tag)
        os.makedirs(run)
        shutil.copy(os.path.join(ref.run_dir, "weights.npz"), run)
        timed_jobs[tag] = run
    for tag, name in (("par_sp_spectral", "spectral"),
                      ("par_ssp_spectral", "spectral"),
                      ("par_sp_grid", "grid"), ("par_ssp_grid", "grid"),
                      ("par_time_knobs2", "knobs"),
                      ("par_time_knobs4", "knobs"),
                      ("par_sptp_knobs", "knobs"),
                      ("par_ssptp_knobs", "knobs")):
        run = os.path.join(root, "par_runs", tag)
        os.makedirs(run)
        shutil.copy(os.path.join(knob_refs[name][0], "weights.npz"), run)
        timed_jobs[tag] = run
    # the plain loop's step time, in this process
    plain_t = Trainer(get_config(_par_flags(data_dir, logs, "par_tp0", 8,
                                            1000)),
                      run_dir=timed_jobs["par_time1"], device=device,
                      save_cfg=False)
    plain_t.restore_weights()
    plain_t.capture = False
    run = plain_t._chunk_runner(PAR_TIMED + 2, 0, 1)
    for _ in range(2):
        run(1)
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    for _ in range(PAR_TIMED):
        run(1)
    torch.cuda.synchronize(device)
    plain_ms = (time.perf_counter() - t1) * 1e3 / PAR_TIMED
    out, _ = demo.communicate(timeout=600)
    if demo.returncode or "one process agrees" not in out:
        raise AssertionError(f"(b) launch_multihost --num_processes 1:\n"
                             f"{out[-3000:]}")
    t1 = time.perf_counter()
    nccl = _par_spawn(1, "nccl", [
        {"name": "main", "mode": "main",
         "argv": _par_flags(data_dir, logs, "par_nccl", 8, PAR_STEPS)
         + ["--num_data_shards", "1"]},
        {"name": "timed", "mode": "timed", "steps": PAR_TIMED,
         "run_dir": timed_jobs["par_time1"],
         "argv": _par_flags(data_dir, logs, "par_t1", 8, 1000)}],
        os.path.join(root, "par_nccl.json"), no_tf32)[0]
    nccl_s = time.perf_counter() - t1
    rel_b = same(_par_losses(logs, "par_nccl"), plain8,
                 "(b) one-rank NCCL main")
    want = {k: PAR_STEPS * v for k, v in step.items()}
    if nccl["main"]["launches"] != want:
        raise AssertionError(f"(b) launched {nccl['main']['launches']}, "
                             f"want {want}")
    launches["dp_nccl_2d"] = nccl["main"]["launches"]
    print(f"phase 12 (b) one-rank NCCL group: ok  launch_multihost "
          f"--num_processes 1 (NCCL, the card) agrees with one process; "
          f"main --arch de flagship 2D f32 (filters "
          f"{FLAGSHIP['filters']}, num_conv {FLAGSHIP['num_conv']}, 128x96, "
          f"batch 8, l2, TF32 off) as a one-rank NCCL group: {PAR_STEPS} "
          f"losses within {rel_b:.2e} of the plain loop's (tol "
          f"{TOL_PAR_LOSS}), launches {nccl['main']['launches']} exact; "
          f"wall {time.perf_counter() - t0:.2f} s (the plain runs, the "
          f"reference gradients and the timed plain loop {prep_s:.2f} s; "
          f"the NCCL rank's process {nccl_s:.2f} s)", flush=True)

    # (c) two gloo ranks on the one card
    t1 = time.perf_counter()
    dp_flags = ["--num_data_shards", "2"]
    layouts = {"dp": dp_flags, "sp": ["--spatial_shard", "true"],
               "tp": ["--num_model_shards", "2"]}
    grads_jobs = [
        {"name": pre + name, "mode": "grads", "smooth": pre == "s",
         "run_dir": timed_jobs[f"par_{pre}{name}"], "batch": batch_npz,
         "out": os.path.join(root, f"par_{pre}{name}.npz"),
         "argv": _par_flags(data_dir, logs, f"par_g_{pre}{name}", 8, 1)
         + flags}
        for pre in ("", "s") for name, flags in layouts.items()]
    # (e) on the pair: the spectral and the grid model under
    # --spatial_shard (leaky and smooth), and the knob path through main
    knob_jobs = [
        {"name": f"{pre}sp_{name}", "mode": "grads", "smooth": pre == "s",
         "run_dir": timed_jobs[f"par_{pre}sp_{name}"], "batch": batch_npz,
         "out": os.path.join(root, f"par_{pre}sp_{name}.npz"),
         "argv": _par_flags(data_dir, logs, f"par_g_{pre}sp_{name}", 8, 1)
         + list(PAR_KNOBS[name]) + list(SPATIAL)}
        for pre in ("", "s") for name in ("spectral", "grid")]
    pair = _par_spawn(2, "gloo", [
        {"name": "main", "mode": "main",
         "argv": _par_flags(data_dir, logs, "par_gloo", 16, PAR_STEPS)
         + dp_flags},
        *grads_jobs,
        {"name": "timed", "mode": "timed", "steps": PAR_TIMED,
         "run_dir": timed_jobs["par_time2"],
         "argv": _par_flags(data_dir, logs, "par_t2", 16, 1000)
         + dp_flags},
        *knob_jobs,
        {"name": "main_knobs", "mode": "main",
         "argv": _par_flags(data_dir, logs, "par_gloo_knobs", 8, PAR_STEPS)
         + list(KNOB_FLAGS) + list(SPATIAL)},
        {"name": "timed_knobs", "mode": "timed", "steps": PAR_TIMED_KNOBS,
         "run_dir": timed_jobs["par_time_knobs2"],
         "argv": _par_flags(data_dir, logs, "par_t2k", 8, 1000)
         + list(KNOB_FLAGS) + list(SPATIAL)}],
        os.path.join(root, "par_gloo.json"), no_tf32)
    rel_c = same(_par_losses(logs, "par_gloo"), plain16,
                 "(c) two gloo ranks at global batch 16")
    for r, res in enumerate(pair):
        if res["main"]["launches"] != want or res["main"]["batch_dims"] != [
                8]:
            raise AssertionError(f"(c) rank {r} launched "
                                 f"{res['main']['launches']} on batches "
                                 f"{res['main']['batch_dims']}, want {want} "
                                 "on 8 rows")
    one_step = expected_launches(PATH_2D.step_launches)
    used = [k for k, v in one_step.items() if v]
    # The kernels' inputs: the whole 128 rows unless --spatial_shard; there
    # rank 0's forward kernels read its 64 rows and the successor's first
    # (65), its backward ones 64 + 2 (the transposed stencil's tail), and
    # the last rank's forward its 64 (the kernel's own edge), its backward
    # the predecessor's row + 64.
    height = PATH_2D.resolution[0]
    half = height // 2
    sp_rows = [{k: [half + 2 if k.endswith("_bwd") else half + 1]
                for k in used},
               {k: [half + 1 if k.endswith("_bwd") else half] for k in used}]
    whole_rows = {k: [height] for k in used}
    for r, res in enumerate(pair):
        for name in ("main", "dp", "tp", "sp", "sdp", "stp", "ssp"):
            want_rows = sp_rows[r] if name.endswith("sp") else whole_rows
            if res[name]["rows"] != want_rows:
                raise AssertionError(f"(c) {name} rank {r}: the kernels' "
                                     f"inputs had {res[name]['rows']} rows, "
                                     f"want {want_rows}")
    errs, smooth = {}, {}
    for name in layouts:
        with np.load(os.path.join(root, f"par_{name}.npz")) as d:
            got = {k: d[k] for k in d.files}
        errs[name] = (pair[0][name]["loss"], *_grad_errors(got, want_grads))
        launches[f"{name}_grads_2d"] = {
            k: sum(res[name]["launches"][k] for res in pair)
            for k in one_step}
        with np.load(os.path.join(root, f"par_s{name}.npz")) as d:
            got = {k: d[k] for k in d.files}
        smooth[name] = (pair[0]["s" + name]["loss"],
                        *_smooth_errors(got, smooth_grads))
    print(f"phase 12 (c) gradients, cuDNN off, largest entry {gmax:.3e}; "
          f"worst |diff| - 1e-5 |g| (relative to that parameter's largest "
          f"entry): floor (two half batches in one process) "
          f"{floor[1]:.2e} ({floor[0]}, {floor[2]:.2e}); "
          + "; ".join(f"{n} loss {e[0]!r} vs {want_loss!r}, {e[2]:.2e} "
                      f"({e[1]}, {e[3]:.2e})" for n, e in errs.items()),
          flush=True)
    print(f"phase 12 (c) gradients with the smooth stand-in for the leaky "
          f"ReLU, cuDNN off, each parameter's error relative to its largest "
          f"entry (conv_out's bias: to the largest of all): "
          + "; ".join(f"{n} loss {e[0]!r} vs {smooth_loss!r}, {e[2]:.2e} "
                      f"({e[1]})" for n, e in smooth.items()), flush=True)
    for name, (loss, worst, err) in smooth.items():
        bad = [r for r, res in enumerate(pair)
               if res["s" + name]["launches"] != one_step]
        if bad or err > TOL_GRAD or abs(loss - smooth_loss) > (
                TOL_PAR_LOSS * abs(smooth_loss)):
            got = [res["s" + name]["launches"] for res in pair]
            raise AssertionError(f"(c) smooth {name}: loss {loss} vs "
                                 f"{smooth_loss}, gradient error {err} "
                                 f"({worst}) relative to the parameter's "
                                 f"largest entry, launches of ranks {got}, "
                                 f"want {one_step} each")
    for name, (loss, worst, err, _) in errs.items():
        bad = [r for r, res in enumerate(pair)
               if res[name]["launches"] != one_step]
        if bad or err > TOL_GRAD or abs(loss - want_loss) > (
                TOL_PAR_LOSS * abs(want_loss)):
            raise AssertionError(f"(c) {name}: loss {loss} vs {want_loss}, "
                                 f"gradient error {err} ({worst}), "
                                 f"launches of ranks "
                                 f"{[res[name]['launches'] for res in pair]}"
                                 f", want {one_step} each")
    launches["dp_2d"] = {k: sum(res["main"]["launches"][k] for res in pair)
                         for k in one_step}
    tp_vs_dp = abs(errs["tp"][0] - errs["dp"][0]) / abs(errs["dp"][0])
    if tp_vs_dp > TOL_PAR_LOSS:
        raise AssertionError(f"(c) TP loss {errs['tp'][0]} != DP "
                             f"{errs['dp'][0]}")
    print(f"phase 12 (c) two gloo ranks on the card: ok  main "
          f"--num_data_shards 2 at global batch 16: {PAR_STEPS} losses "
          f"within {rel_c:.2e} of one rank at 16, each rank launching "
          f"{want} on its 8 rows; one f32 batch of 8 from shared weights: "
          + "; ".join(f"{n} loss {errs[n][0]!r} (plain {want_loss!r}), "
                      f"gradients within rtol/atol {TOL_GRAD} (worst excess "
                      f"{errs[n][2]:.2e}, {errs[n][1]})"
                      for n in ("dp", "sp", "tp"))
          + f"; with the smooth activation every parameter within "
          f"{TOL_GRAD} of its largest entry (worst "
          f"{max(e[2] for e in smooth.values()):.2e}); --spatial_shard over "
          f"2 ranks: the kernels read {pair[0]['sp']['rows']} rows on rank 0 "
          f"and {pair[1]['sp']['rows']} on rank 1 (64 a rank + halo); "
          f"--num_model_shards 2 first-step loss within {tp_vs_dp:.2e} of "
          f"DP's; wall {time.perf_counter() - t1:.2f} s", flush=True)

    knobs = timed("phase 12 (e)", par_knobs, device, root, card, {
        "pair": pair, "refs": knob_refs, "batch": batch_npz, "logs": logs,
        "data_dir": data_dir, "runs": timed_jobs, "plain": plain_knobs,
        "rows": sp_rows, "one_step": one_step, "same": same})
    launches.update(knobs["launches"])

    # (d) the dry run's stages in two ranks on the card
    t1 = time.perf_counter()
    lines = dryrun.dryrun_multichip(2, "cuda")
    print(f"phase 12 (d) dryrun_multichip(2, 'cuda'): ok  {len(lines)} "
          f"stages; wall {time.perf_counter() - t1:.2f} s", flush=True)
    times = {"plain_ms": plain_ms, "nccl1_ms": nccl["timed"]["ms"],
             "gloo2_ms": max(r["timed"]["ms"] for r in pair),
             **knobs["times"]}
    print(f"phase 12 step times [{card}]: flagship 2D f32 train step "
          f"(recorded, not targets): plain loop batch 8 "
          f"{times['plain_ms']:.2f} ms; one-rank NCCL group batch 8 "
          f"{times['nccl1_ms']:.2f} ms; two gloo ranks on the one card, "
          f"global batch 16 (8 a rank) {times['gloo2_ms']:.2f} ms",
          flush=True)
    return {"launches": launches, "times": times}


def timed(label: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall time printed under ``label``."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"  {label} wall {time.perf_counter() - t0:.2f} s", flush=True)
    return out


def run(device, card: str) -> list[dict]:
    """Every phase on ``device``; the kernels' entries of the JSON line."""
    import torch

    t_start = time.perf_counter()
    timed("phase 1", phase_build, card)
    worst = timed("phase 2", phase_kernels, device)
    timed("phase 2 epilogue", phase_epilogue, device, card)
    timed("phase 3", phase_golden, device)
    serving, train, timing, train_timing = {}, {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        # torch.compile's caches (phase 5) go with the run
        os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                              os.path.join(root, "inductor"))
        os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(root, "triton"))
        for path in PATHS:
            tag = path.name.upper()
            if path.serve_counts:
                serving[path.name] = timed(f"phase 4 {tag}", phase_serving,
                                           device, root, path)
            train[path.name] = timed(f"phase 6 {tag}", phase_train, device,
                                     root, path)
            # A path without kernels is held against the CPU instead.
            parity = (phase_train_parity if path.step_launches
                      else phase_cpu_parity)
            timed(f"phase 6 parity {tag}", parity, device, train[path.name],
                  path)
        mov = timed("phase 7 MOV", phase_train_mov, device, root, PATH_MOV)
        timed("phase 6 parity MOV", phase_train_parity, device, mov,
              PATH_MOV)
        timed("phase 14", phase_graph, device, root, train, mov)
        # The 2D kernels also at [1,128,96]: the card's floor for their
        # launch configuration.
        timing["2d"] = timed("phase 5 2D serving", phase_timing, device,
                             serving["2d"]["weights"], card, PATH_2D,
                             (512, 32), 10, (512, 32, 8, 1))
        train_timing["2d"] = timed(
            "phase 5 2D training", phase_train_timing, device, train["2d"],
            card, PATH_2D, (8, 64),
            ["jacobian2d_fused", "curl2d_bwd", "jacobian2d_bwd"], (512, 8, 1))
        timed("phase 5 MOV", phase_mov_timing, device, mov, card, PATH_MOV)
        timing["3d"] = timed("phase 5 3D serving", phase_timing, device,
                             serving["3d"]["weights"], card, PATH_3D, (32,),
                             5, (32, 8))
        train_timing["3d"] = timed(
            "phase 5 3D training", phase_train_timing, device, train["3d"],
            card, PATH_3D, (8,),
            ["jacobian3d_fused", "curl3d_bwd", "jacobian3d_bwd"], (32, 8))
        timed("phase 5 LIQUID/KNOBS", phase_liquid_knob_timing, device,
              train, serving, train_timing, card)
        timed("phase 5 GRAPH", phase_graph_timing, device, root, train, mov,
              card)
        entry = timed("phase 13", phase_entry, device, card,
                      timing["2d"]["fields_per_s"])
        timed("phase 8", phase_sweep_on_device, device, serving, timing,
              card, root)
        timed("phase 9", phase_knobs3d, device)
        datagen = timed("phase 10", phase_datagen, device, root, card)
        tools = timed("phase 11", phase_tools, device, root, card, train,
                      mov)
        par = timed("phase 12", phase_parallel, device, root, card, train)
        timed("profiles", profiles, device, serving, timing, train_timing,
              train, card)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "grain"))
    if leaked:
        raise AssertionError(f"the port imported jax or grain: "
                             f"{leaked[:5]}")
    kernels = []
    for name, (src, replaces, _, nd) in KERNELS.items():
        path = PATH_2D if nd == 2 else PATH_3D
        by_path = {}
        for p in PATHS:
            # The knob path is served from its trained run (phase 6).
            by_path[f"serving_{p.name}"] = (
                serving[p.name]["launches"][name] if p.name in serving
                else train[p.name]["served"][name])
            by_path[f"train_{p.name}"] = sum(
                r["launches"][name] for r in train[p.name]["runs"])
            if train[p.name]["grain"]:
                by_path[f"train_{p.name}_grain"] = sum(
                    r["launches"][name] for r in
                    train[p.name]["grain"]["runs"])
        by_path["train_mov"] = sum(r["launches"][name] for r in
                                   mov["ae_runs"] + mov["nn_runs"])
        by_path["serving_mov"] = sum(s[name] for s in mov["serving"])
        # Phase 10: the datagen's scene functions, the training run on the
        # set they wrote and the density rendering through its generator.
        for tag, counts in datagen["launches"].items():
            by_path[f"datagen_{tag}"] = counts[name]
        # Phase 11: each tool's launches in this process (the supervised
        # children's and the fleet's datagen child's are their own).
        for tag, counts in tools["launches"].items():
            by_path[f"tools_{tag}"] = counts[name]
        # Phase 12: the simulated shards (sp_sim_*), the one-rank NCCL run
        # (dp_nccl_2d), the two gloo ranks' runs (dp_2d, and one batch
        # each of dp_grads_2d, sp_grads_2d, tp_grads_2d) and the knobs'
        # (e): on the pair one batch each of sp_spectral_grads_2d and
        # sp_grid_grads_2d and the knob path through main (sp_knobs_2d), on
        # 2 x 2 ranks one batch (sptp_knobs_grads_2d), main
        # (sptp_knobs_2d) and its resume in one process (sptp_resume_2d);
        # summed over ranks.
        for tag, counts in par["launches"].items():
            by_path[tag] = counts[name]
        # Phase 13: entry()'s forward and bench's run_device_bench in this
        # process (the bench subprocess's launches are its own).
        for tag, counts in entry["launches"].items():
            by_path[tag] = counts[name]
        par_paths = (("sp_sim_3d",) if nd == 3 else (
            "sp_sim_2d", "dp_nccl_2d", "dp_2d", "dp_grads_2d",
            "sp_grads_2d", "tp_grads_2d", "sp_spectral_grads_2d",
            "sp_grid_grads_2d", "sp_knobs_2d", "sptp_knobs_grads_2d",
            "sptp_knobs_2d", "sptp_resume_2d"))
        if any(by_path[p] == 0 for p in par_paths):
            raise AssertionError(f"{name} never launched on a phase 12 "
                                 f"path: {by_path}")
        bench = "tools_bench_train2d" if nd == 2 else "tools_bench_train3d"
        if by_path[bench] == 0:
            raise AssertionError(f"{name} never launched on the bench_suite "
                                 f"train surface: {by_path}")
        matched = "datagen_2d_matched" if nd == 2 else "datagen_3d_matched"
        if name.startswith("curl") and by_path[matched] == 0:
            raise AssertionError(f"{name} never launched on the matched "
                                 f"datagen path: {by_path}")
        if by_path["serving_liquid"] or by_path["train_liquid"]:
            raise AssertionError(f"{name} launched on config #3's path, "
                                 f"which has no curl: {by_path}")
        if by_path[f"train_{path.name}"] == 0 or (
                name in path.forward_launches
                and by_path[f"serving_{path.name}"] == 0):
            raise AssertionError(f"{name} never launched on the "
                                 f"{path.name} path: {by_path}")
        if nd == 2 and by_path["train_2d_grain"] == 0:
            raise AssertionError(f"{name} never launched on the 2D grain "
                                 f"path: {by_path}")
        for other in ("mov", "knobs"):
            if nd == 2 and (by_path[f"train_{other}"] == 0 or (
                    name in PATH_2D.forward_launches
                    and by_path[f"serving_{other}"] == 0)):
                raise AssertionError(f"{name} never launched on the {other} "
                                     f"path: {by_path}")
        # The time at the timed shape: 2D [512,128,96,.], 3D
        # [32,32,64,112,.], f32; no single PyTorch call computes the
        # edge-replicated difference or its transpose (torch.gradient takes
        # central differences, torch.diff drops the last row), so no
        # library time; compiled_ms is the plain version under
        # torch.compile in the same window.
        b = 512 if nd == 2 else 32
        times = (timing[path.name]["curl"] if name in path.forward_launches
                 else train_timing[path.name]["kernel_ms"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"deepfluids_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": worst[name],
            **times[(name, b, torch.float32)], "library_ms": None})
    print(f"total wall {time.perf_counter() - t_start:.2f} s", flush=True)
    return kernels


def activation_readings(device, card: str) -> None:
    """``python3 chip_smoke.py readings``: what sizes K_F64 and what the
    models' activation costs, on the card.  Phase 6 LIQUID's readings
    (:func:`cpu_parity_readings`) at two trained states: the run trained
    with the models' activation and the run trained with ``F.leaky_relu``
    (the slope at exactly 0), each read with the activation it trained
    with; then a flagship 2D bf16 batch-8 train step with each activation:
    its kernel launches and kernel time (profiler) and its device ms (CUDA
    events, alternated)."""
    import torch
    import torch.nn.functional as F

    from deepfluids_tpu_torch.config import get_config
    from deepfluids_tpu_torch.train.trainer import Trainer

    acts = {"the models' activation": None,
            "F.leaky_relu": with_bias(F.leaky_relu)}
    with tempfile.TemporaryDirectory(prefix="chip_readings_") as root:
        for k, (label, act) in enumerate(acts.items()):
            sub = os.path.join(root, str(k))
            os.makedirs(sub)
            with activation_as(act):
                train = phase_train(device, sub, PATH_LIQ)
                r = cpu_parity_readings(device, train, PATH_LIQ, act)
            g = {n: v[1] for n, v in r.items() if isinstance(v, tuple)}
            same = {n: _worst_l2(g[n], g[n + "_f64"])
                    for n in ("card", "cpu", "card_slope01")}
            own = {n: _worst_l2(g[n], g["f64"]) for n in ("card", "cpu")}
            print(f"readings LIQUID trained with {label} [{card}]: against "
                  f"float64 on each side's branches card {same['card'][1]:.4e}"
                  f" ({same['card'][0]}), CPU {same['cpu'][1]:.4e} "
                  f"({same['cpu'][0]}), ratio "
                  f"{same['card'][1] / same['cpu'][1]:.4f}; on float64's own "
                  f"branches card {own['card'][1]:.4e} ({own['card'][0]}), "
                  f"CPU {own['cpu'][1]:.4e} ({own['cpu'][0]}), ratio "
                  f"{own['card'][1] / own['cpu'][1]:.4f}; branches that "
                  f"differ from float64's {r['flips']}; exact zeros "
                  f"{r['zeros']}; card vs CPU "
                  f"{_worst_l2(g['card'], g['cpu'])[1]:.4e}; smooth card vs "
                  f"CPU {_worst_l2(g['card_smooth'], g['cpu_smooth'])[1]:.4e}"
                  f"; slope 0.1 control ratio "
                  f"{same['card_slope01'][1] / same['cpu'][1]:.1f}",
                  flush=True)
        data_dir = make_train_dataset(root, PATH_2D)
        t = Trainer(get_config([
            "--is_train", "True", "--arch", "de", "--data_dir", data_dir,
            "--dataset", PATH_2D.dataset, "--log_dir",
            os.path.join(root, "logs"), "--batch_size", "8",
            "--compute_dtype", "bfloat16", "--device_data_cache", "true",
            "--filters", str(FLAGSHIP["filters"]), "--num_conv",
            str(FLAGSHIP["num_conv"])]), device=device)
        cx, cy = t._load_device_cache()
        x, y = cx[:8].float(), cy[:8]
        steps = {}
        for label, act in acts.items():
            def step(act=act):
                with activation_as(act):
                    t._train_step(x, y)
            steps[label] = step
            profile_line(f"2D train step bf16 batch 8, {label} [{card}]",
                         step, cuda_ms(step, 20))
        new, old, runs = alternated(steps["F.leaky_relu"],
                                    steps["the models' activation"], 20)
        print(f"readings 2D train step bf16 batch 8 [{card}]: device ms the "
              f"models' activation {new:.3f}, F.leaky_relu {old:.3f} "
              f"(F, models', models', F: {', '.join(f'{v:.3f}' for v in runs)})",
              flush=True)


def train_path_side(tree: str) -> None:
    """``python3 chip_smoke.py side <tree>``: one side of a parent/change
    comparison inside one call, the tree at ``tree`` (``.``, or another
    commit unpacked by ``git archive`` into a git-ignored directory)
    measured by its own ``chip_smoke.py``: the 2D training path through
    ``main`` (``phase_train``: streaming, cached and grain steps/s end to
    end), its eager bf16 step at batch 8 and 64 and the 3D eager step at
    8 (CUDA events, best of three and two), a batch-8 step's launches
    (profile line) and, where the tree has the CUDA graph (``_steady``),
    the graph's steady step at K = 1.  Prints one ``SIDE {json}`` line.
    Run the sides in turns (parent, change, change, parent)."""
    import dataclasses
    import importlib

    import torch

    root = os.path.abspath(tree)
    os.chdir(root)
    sys.path.insert(0, root)
    cs = importlib.import_module("chip_smoke")
    from deepfluids_tpu_torch.config import get_config, load_config
    from deepfluids_tpu_torch.train.trainer import Trainer

    dev = torch.device("cuda", 0)
    cs.phase_build(cs.card_line())
    out = {"tree": tree}
    with tempfile.TemporaryDirectory(prefix="side_") as tmp:
        train = cs.phase_train(dev, tmp, cs.PATH_2D)
        out.update(train["steps_per_sec"], grain=train["grain"][
            "steps_per_sec"])
        t = Trainer(load_config(train["run"]), run_dir=train["run"],
                    device=dev, save_cfg=False)
        cx, cy = t._load_device_cache()
        for b in (8, 64):
            x, y = cx[:b].float(), cy[:b]
            out[f"eager{b}_ms"] = min(cs.cuda_ms(
                lambda: t._train_step(x, y), 20) for _ in range(3))
        x, y = cx[:8].float(), cy[:8]
        out["launches8"] = cs.profile_line(
            f"side {tree} 2D step batch 8", lambda: t._train_step(x, y),
            out["eager8_ms"])
        data3 = cs.make_train_dataset(tmp, cs.PATH_3D)
        t3 = Trainer(get_config([
            "--is_train", "True", "--arch", "de", "--data_dir", data3,
            "--dataset", cs.PATH_3D.dataset, "--log_dir",
            os.path.join(tmp, "logs3d"), "--batch_size", "8",
            "--compute_dtype", "bfloat16", "--device_data_cache", "true",
            "--filters", str(cs.FLAGSHIP["filters"]), "--num_conv",
            str(cs.FLAGSHIP["num_conv"])]), device=dev)
        x3, y3 = (a[:8] for a in t3._load_device_cache())
        x3 = x3.float()
        out["eager3d8_ms"] = min(cs.cuda_ms(
            lambda: t3._train_step(x3, y3), 10) for _ in range(2))
        if hasattr(cs, "_steady"):
            for b in (8, 64):
                tb = Trainer(dataclasses.replace(
                    t.c, batch_size=b, device_data_cache=True),
                    run_dir=train["run"], device=dev, save_cfg=False)
                tb._device_cache = t._device_cache
                out[f"graph{b}_ms"] = cs._steady(
                    tb, "graph", 1, 32 if b == 8 else 16)["wall_ms"]
            out["graph3d8_ms"] = cs._steady(t3, "graph", 1, 16)["wall_ms"]
    print("SIDE " + json.dumps(out), flush=True)


def main() -> None:
    # The smoke runs on one card: show CUDA only the first visible one, so
    # the device count reported last is the card the run used.
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    os.environ["CUDA_VISIBLE_DEVICES"] = visible
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    if sys.argv[1:2] == ["side"] and len(sys.argv) == 3:
        train_path_side(sys.argv[2])
        return
    card = card_line()
    if sys.argv[1:] == ["readings"]:
        phase_build(card)
        activation_readings(torch.device("cuda", 0), card)
        return
    if sys.argv[1:] == ["epilogue"]:
        phase_build(card)
        phase_epilogue(torch.device("cuda", 0), card)
        return
    kernels = run(torch.device("cuda", 0), card)
    print(json.dumps({"kernels": kernels}))
    count = torch.cuda.device_count()
    if count != 1:
        raise AssertionError(f"{count} cards visible, the smoke uses one")
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": count}}))


if __name__ == "__main__":
    main()
