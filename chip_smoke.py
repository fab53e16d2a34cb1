"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the repo root, one card, no args

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
     card, at the serving and training shapes and odd ones (3D: ragged
     bricks, rows of no 16-byte multiple, unaligned storage), f32 and bf16,
     jacobian3d_bwd also without the vorticity's cotangent, plus the fd2d
     and fd3d goldens; the backward kernels refuse extents < 3; gradients
     through ``curl2d_p`` / ``jacobian2d_p`` / ``curl3d_p`` /
     ``jacobian3d_p`` (also with one output unused) against autograd of
     the plain ops;
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
     must be exact per step (zero for the liquid).  Then one f32 train
     step through the kernels against the same step through the plain ops
     (loss and every parameter's gradient), or, for the liquid, which has
     no kernel, the card's step against the CPU's;
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
     of their launch configuration), config #4's AE step, encode pass,
     integrator step and a 400-frame rollout, the liquid step (batch 8 and
     64) and serving (batch 512), the knob step against the plain 2D step
     (batch 8 and 64) with the kernels each launches, the x-mirror's cost,
     and profile lines by kernel;
  8. ``sweep_on_device`` over the full 2D grid (21 000 fields, 2 GB) at
     batch 512, a batch against ``sweep_generator``, and its fields/s;
  9. one forward of config #5's generator with every knob (random gains
     and bases, f32, curl applied) on the card against the CPU;
 10. the datagen, through the scene functions at each configuration's full
     width (scene and frame counts cut for the time limit, the cut
     printed): ``smoke_pos21_size5`` at 128x96 x 200 frames, a 5 x 3
     sub-grid in one scene batch with the jacobi projection and 2 x 2
     with the matched one (frames finite, density rising, the manifest's
     fields, every frame's distance to range(curl2d), matched frames
     under 1e-3 with zero wall through-flow, launch counts of the curl
     kernels exact for the matched run and zero for the jacobi one);
     ``smoke3_vel5_buo3`` at 32x64x112 (3 scenes x a 50-frame segment
     jacobi, 1 scene x 4 frames matched, the 3D multigrid setup timed);
     ``liquid_pos10_size4`` (4 scenes x 60 frames, particles and P2G mass
     conserved) and ``smoke_mov`` (4 x 64, params equal to numpy's
     knots); one step of each solver on the card against the port on the
     CPU from a shared state; the matched projection through the kernels
     against the plain ops; then ``main --is_train True`` on the 2D set
     the card just wrote (loss falling) and ``render_density_sweep`` of a
     scene through the trained generator against the set's d/ frames; and
     the solvers' frames/s, idle shares and launches a frame (printed
     only).

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
# Kernel-check shapes (batch + spatial).  2D: 8 is the training batch, 32
# the serving sweep's (--test_batch_size), 512 the timed one; 4 is the
# matched datagen's scene batch, 16 and 64 its multigrid setup's probe
# batches (diagonal colours, the coarsest level's dense probe); (4, 2, 5) is
# below the backward kernels' minimum extent.  3D: config #5's grid at the
# same batches and at 48 (the 3D setup's probe batch), odd extents, the smallest backward grid, D, H or W = 2, and
# for the backward kernels' bricks: rows whose bytes are no multiple of 16
# (W = 37, 113, 5, 11), ragged last bricks along z and y, D below one brick
# of planes (3, 4), and W wider than a brick's plane (1100: column tiles).
KERNEL_SHAPES = {
    2: [(1, 128, 96), (4, 128, 96), (8, 128, 96), (16, 128, 96),
        (32, 128, 96), (64, 128, 96), (512, 128, 96),
        (3, 8, 8), (2, 16, 12), (4, 2, 5)],
    3: [(1, 32, 64, 112), (8, 32, 64, 112), (32, 32, 64, 112),
        (48, 32, 64, 112),
        (2, 5, 6, 7), (1, 3, 3, 3), (1, 2, 6, 7), (1, 5, 2, 7),
        (1, 5, 6, 2), (2, 9, 13, 37), (1, 33, 65, 113), (3, 4, 7, 5),
        (2, 3, 9, 11), (1, 4, 5, 1100)],
}
# Shapes at which the 3D kernels also take inputs whose storage starts one
# element past an aligned address (a view into a larger buffer).
UNALIGNED_SHAPES = [(2, 9, 13, 37), (8, 32, 64, 112)]


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
    forward_launches={"curl2d_fused": 1})
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
    resume_steps=150, log_step=10, save_step=50, train_flags=KNOB_FLAGS)
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
# jacobian2d_bwd 4 + 1 -> 2; curl3d 3 -> 3, jacobian3d 3 -> 9 + 3,
# curl3d_bwd 3 -> 3, jacobian3d_bwd 9 + 3 -> 3 (9 -> 3 without the
# vorticity's cotangent, as the training loss calls it).
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
            if nd == 2:
                continue
            # Storage one element past an aligned address.
            for shape in UNALIGNED_SHAPES:
                xs = [torch.randn(math.prod(shape) * c + 1, generator=gen,
                                  device=device).to(dtype)[1:].view(
                                      shape + (c,))
                      for c in KERNELS[name][2]]
                seen[name] = max(seen[name], check_kernel(
                    name, getattr(cuda_fd, name), plain, xs,
                    f"{shape} unaligned"))
    # jacobian3d_bwd without the vorticity's cotangent (the training loss's
    # call): J's alone, against the plain version given zeros.
    no_vort = {torch.float32: 0.0, torch.bfloat16: 0.0}
    plain = plain_version("jacobian3d_bwd")
    for dtype in no_vort:
        for shape in KERNEL_SHAPES[3]:
            if min(shape[1:]) < 3:
                continue
            gj = torch.randn(shape + (9,), generator=gen,
                             device=device).to(dtype)
            no_vort[dtype] = max(no_vort[dtype], check_kernel(
                "jacobian3d_bwd", lambda g: cuda_fd.jacobian3d_bwd(g, None),
                lambda g: plain(g, g.new_zeros(g.shape[:-1] + (3,))), [gj],
                f"{shape} without a vorticity cotangent"))
    # Gradients through the autograd Functions against autograd of the
    # plain ops: the JAX tests' shapes and the flagship training batches.
    grad_err = {2: 0.0, 3: 0.0}
    # Autograd through jacobian3d_p with one output unused: its cotangent
    # arrives as None (J's alone; the vorticity's alone, J's made zeros).
    for shape in ((2, 5, 6, 7), (8, 32, 64, 112)):
        x = torch.randn(shape + (3,), generator=gen, device=device)
        for used in (0, 1):
            cot = torch.randn(shape + ((9, 3)[used],), generator=gen,
                              device=device)
            grads = []
            for f in (cuda_fd.jacobian3d_p, fd.jacobian3d):
                a = x.clone().requires_grad_()
                f(a)[used].backward(cot)
                grads.append(a.grad)
            err = float((grads[0] - grads[1]).abs().max())
            if not err <= TOL_GRAD:
                raise AssertionError(f"autograd through jacobian3d_p, only "
                                     f"output {used} used, {shape}: {err}")
            grad_err[3] = max(grad_err[3], err)
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
        extra = ("" if nd == 2 else
                 f" + unaligned storage at {UNALIGNED_SHAPES}; "
                 f"jacobian3d_bwd without a vorticity cotangent max abs err "
                 f"f32 {no_vort[torch.float32]} bf16 "
                 f"{no_vort[torch.bfloat16]}")
        print(f"phase 2 kernel vs plain {nd}D: ok  {len(names)} kernels x "
              f"{len(KERNEL_SHAPES[nd])} shapes x f32/bf16{extra}; f32 max "
              f"abs err { {n: worst[n] for n in names} } (tol fwd "
              f"{TOL_KERNEL}, bwd {TOL_GRAD}); bf16 within one ulp of f32 "
              f"math (max abs err { {n: bf16_worst[n] for n in names} }); "
              f"bwd refuses extent < 3; autograd vs plain autograd "
              f"(jacobian3d_p also with one output unused) max abs err "
              f"{grad_err[nd]:.3e} (tol {TOL_GRAD}); fd{nd}d golden (u, J, "
              f"vort) L2 {golden[nd][0]:.3e}, interior div "
              f"{golden[nd][1]:.3e}", flush=True)
    return worst


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
    width."""
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
        _, secs, launches = _drive(
            device, argv, per_step(steps, dumps),
            f"{path.name} training ({steps} steps, {dumps} sample dumps)")
        runs.append({"secs": secs, "launches": launches, "steps": steps})

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
          f"{path.forward_launches} per sample dump, exact in both runs; "
          f"checkpoints {ckpts}; sample PNGs {samples}; served 24 fields from "
          f"weights.npz (eval l2_mean {result['eval']['l2_mean']:.4f}); "
          f"steps/s end to end (metrics.jsonl) streaming {rate['stream']}, "
          f"device cache {rate['cache']}", flush=True)
    return {"run": run, "data_dir": data_dir, "runs": runs,
            "steps_per_sec": rate, "served": served}


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


def phase_cpu_parity(device, train: dict, path: MainPath) -> None:
    """A path without kernels (config #3): one f32 train step of the
    trained run on the card (TF32 off, deterministic cuDNN) against the
    same step on the CPU in this process: the loss within 1e-5 relative,
    every gradient at normalized L2 < 1e-3; no FD kernel launched.  The
    step takes the l2 loss: L1's sign flips wherever a residual is within
    rounding of zero, which put one gradient 7.3e-4 from the CPU's.  Both
    are also held (printed only) against the same network in float64 on
    the CPU (the loss on its f32 output), to show which side the
    difference is on."""
    import copy

    import torch

    from deepfluids_tpu_torch.config import load_config
    from deepfluids_tpu_torch.ops import cuda_fd
    from deepfluids_tpu_torch.train.trainer import Trainer
    from deepfluids_tpu_torch.utils.parity import normalized_l2

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg = load_config(train["run"])
    cfg.compute_dtype, cfg.loss_norm = "float32", "l2"
    b = path.parity_batch
    results = []
    cuda_fd.reset_launch_counts()
    for dev in (device, torch.device("cpu"), None):
        if dev is None:     # the CPU trainer's network in float64
            model = copy.deepcopy(t.model).double()
            model.compute_dtype = torch.float64
        else:
            t = Trainer(cfg, run_dir=train["run"], device=dev,
                        save_cfg=False)
            t.restore_weights()
            model = t.model
            x, y = (torch.from_numpy(a[:b]).to(dev)
                    for a in t.bm.step_batch(1))
        loss, _ = t._loss_fn(model, x, y)
        loss.backward()
        results.append((loss.item(), {n: p.grad.cpu().double().numpy()
                                      for n, p in model.named_parameters()}))
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    (lc, gc), (lh, gh), (_, g64) = results
    launches = dict(cuda_fd.launch_counts)
    err = {n: normalized_l2(gc[n], gh[n]) for n in gc}
    worst = max(err, key=err.get)
    vs64 = [max(normalized_l2(g[n], g64[n]) for n in g64) for g in (gc, gh)]
    if not (abs(lc - lh) <= 1e-5 * abs(lh) and err[worst] < TOL_PARITY
            and launches == expected_launches({})):
        raise AssertionError(f"card vs CPU train step: loss {lc} vs {lh}, "
                             f"gradient L2 {err}, launches {launches}")
    print(f"phase 6 parity {path.name.upper()}: ok  one f32 train step (l2) "
          f"at the flagship width, batch {b}, card (TF32 off, deterministic "
          f"cuDNN) vs CPU: loss {lc!r} vs {lh!r} (relative "
          f"{abs(lc - lh) / abs(lh):.2e}, tol 1e-5); every gradient within "
          f"normalized L2 {err[worst]:.2e} ({worst}; tol {TOL_PARITY}); "
          f"against the float64 network, worst gradient L2 card "
          f"{vs64[0]:.2e}, CPU {vs64[1]:.2e}; no FD kernel (the path has "
          f"none)", flush=True)


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
        _, secs, launches = _drive(device, argv, want, "AE training")
        ae_runs.append({"secs": secs, "launches": launches, "steps": steps})
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
          f"dump, sample PNGs {samples}; encode pass {len(codes)} code "
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


def kernel_timing(device, card: str, names: list[str],
                  batches: tuple[int, ...], path: MainPath,
                  seed: int) -> dict:
    """Each kernel alone at ``[b, *resolution, .]`` for each batch, f32 and
    bf16, against its plain version: device time from the profiler, inputs
    cold (a ring of input sets of RING_BYTES), and the kernel's bound.
    jacobian3d_bwd also without the vorticity's cotangent, as the training
    loss calls it."""
    import torch

    from deepfluids_tpu_torch.ops import cuda_fd

    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name in names:
        fn, plain = getattr(cuda_fd, name), plain_version(name)
        # (label, kernel, plain version, input channels, channels moved)
        variants = [("", fn, plain, KERNELS[name][2], CHANNELS_MOVED[name])]
        if name == "jacobian3d_bwd":
            variants.append((
                " without vort", lambda gj: fn(gj, None),
                lambda gj: plain(gj, gj.new_zeros(gj.shape[:-1] + (3,))),
                [9], CHANNELS_MOVED[name] - 3))
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
                    turn = {"plain": 0, cuda_name: 0}

                    def call(label, f):
                        def run():
                            f(*ring[turn[label] % n])
                            turn[label] += 1
                        return run

                    with torch.inference_mode():
                        ms = device_ms({"plain": call("plain", plain_fn),
                                        cuda_name: call(cuda_name, kern_fn)},
                                       iters=20)
                        wall = cuda_ms(call(cuda_name, kern_fn), 20)
                    kern, pl = ms[cuda_name], ms["plain"]
                    bound, by = kernel_bound(name, shape, dtype, moved)
                    out[(name + what, b, dtype)] = {
                        "ms": kern, "plain_ms": pl, "bound_ms": bound,
                        "bound_by": by}
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
             card: str) -> None:
    """Profile lines of 2D serving (batch 512) and of a batch-8 train step
    of each path; diagnostics only, the phases decide ok."""
    import torch

    from deepfluids_tpu_torch.models import load_flax_npz
    from deepfluids_tpu_torch.train.losses import apply_curl

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


def phase_sweep_on_device(device, serving: dict, timing: dict, card: str,
                          root: str) -> dict:
    """``sweep_on_device`` over the full 2D grid (21 x 5 x 200 = 21 000
    fields, 2.06 GB in f32) at batch 512 with the 2D serving run's flagship
    weights, timed twice; a batch of its second segment against
    ``sweep_generator`` on the same slice (deterministic cuDNN, so both
    run the same convolutions)."""
    import torch

    from deepfluids_tpu_torch.data import load_manifest
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
        t0 = time.perf_counter()
        out = sweep_on_device(apply_fn, manifest, raw, batch_size=bs,
                              device=device)
        secs.append(time.perf_counter() - t0)
        launches = dict(cuda_fd.launch_counts)
    n = len(raw)
    # A whole batch of the second of the two 1 GiB segments.
    lo = bs * max(0, min(25, n // bs - 1))
    ref = np.concatenate(list(sweep_generator(
        apply_fn, manifest, raw[lo:lo + bs], batch_size=bs, device=device)))
    torch.backends.cudnn.deterministic = False
    # sweep_on_device's segments: as many batches as fit in 1 GiB, the
    # last segment padded to the same shape; the curl once a batch.
    per_seg = min(max(1, (1 << 30) // (4 * math.prod(manifest.field_shape)
                                       * bs)), -(-n // bs))
    batches = -(-n // (per_seg * bs)) * per_seg
    if (out.shape != (n,) + manifest.field_shape or out.dtype != np.float32
            or not np.isfinite(out).all()):
        raise AssertionError(f"sweep_on_device gave {out.shape} {out.dtype}")
    l2 = normalized_l2(out[lo:lo + bs], ref)
    if not (l2 < TOL_PARITY and launches == expected_launches(
            {"curl2d_fused": batches})):
        raise AssertionError(f"sweep_on_device vs sweep_generator L2 {l2}, "
                             f"launches {launches}, want {batches} curls")
    rate = n / min(secs)
    device_rate = timing[path.name]["fields_per_s"]
    print(f"phase 8 sweep_on_device 2D: ok  the full {path.serve_counts} x "
          f"{path.num_frames} grid, {n} fields of 128x96x2 ({out.nbytes / 1e9:.2f} "
          f"GB f32) at batch {bs}, segments of <= 1 GiB on the card copied "
          f"once each into a pinned host buffer: {secs[0]:.3f} s / "
          f"{secs[1]:.3f} s = {rate:.1f} fields/s (phase 5's device rate of "
          f"generator + curl at batch 512: {device_rate:.1f} fields/s; "
          f"[{card}]); curl2d_fused {launches['curl2d_fused']} launches = "
          f"{batches} batches of {-(-batches // per_seg)} segments; rows "
          f"{lo}:{lo + bs} "
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


# Phase 10's cut of each published scene: (scene function kwargs, what the
# published scene has).  Full width and frame length everywhere except the
# 3D matched run; the scene counts are cut for the time limit.
DATAGEN_CUTS = {
    "2d_jacobi": (dict(num_pos=5, num_size=3, scene_batch=15),
                  "5 x 3 of the 21 x 5 scenes, all 200 frames"),
    "2d_matched": (dict(num_pos=2, num_size=2, scene_batch=4,
                        projection="matched", name="smoke_matched"),
                   "2 x 2 of the 21 x 5 scenes, all 200 frames"),
    "3d_jacobi": (dict(num_vel=3, num_buo=1, num_frames=50),
                  "3 x 1 of the 5 x 3 scenes, one 50-frame segment of 250"),
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
    timed("phase 3", phase_golden, device)
    serving, train, timing, train_timing = {}, {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
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
        timed("phase 8", phase_sweep_on_device, device, serving, timing,
              card, root)
        timed("phase 9", phase_knobs3d, device)
        datagen = timed("phase 10", phase_datagen, device, root, card)
        timed("profiles", profiles, device, serving, timing, train_timing,
              card)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax"))
    if leaked:
        raise AssertionError(f"the port imported jax: {leaked[:5]}")
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
        by_path["train_mov"] = sum(r["launches"][name] for r in
                                   mov["ae_runs"] + mov["nn_runs"])
        by_path["serving_mov"] = sum(s[name] for s in mov["serving"])
        # Phase 10: the datagen's scene functions, the training run on the
        # set they wrote and the density rendering through its generator.
        for tag, counts in datagen["launches"].items():
            by_path[f"datagen_{tag}"] = counts[name]
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
        # library time.
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


def main() -> None:
    # The smoke runs on one card: show CUDA only the first visible one, so
    # the device count reported last is the card the run used.
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    os.environ["CUDA_VISIBLE_DEVICES"] = visible
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    card = card_line()
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
