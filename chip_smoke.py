"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the repo root, one card, no args

Drives the port's serving and training paths, 2D (configs #1/#2,
smoke_pos21_size5) and 3D (config #5, smoke3_vel5_buo3), through the entry
point a user calls and checks every kernel on the way.  Phases, one line
each (or a few), each followed by its wall time; any failure raises and the
script exits non-zero:

  1. device and build: the card, its power limit, nvcc build of csrc/*.cu;
  2. each of the eight kernels against its plain PyTorch version on the
     card, at the serving and training shapes and odd ones, f32 and bf16,
     plus the fd2d and fd3d goldens; the backward kernels refuse extents
     < 3; gradients through ``curl2d_p`` / ``jacobian2d_p`` / ``curl3d_p``
     / ``jacobian3d_p`` against autograd of the plain ops;
  3. the generator goldens, 2D and 3D: Flax-init weights (tests/golden)
     through the port's GeneratorBE and the curl kernels, against JAX;
  4. the serving path at full width, 2D and 3D:
     ``deepfluids_tpu_torch.main.main`` on a synthetic dataset under the
     published manifest with the flagship GeneratorBE (bf16, seeded random
     weights): 21 x 5 x 20 = 2100 fields of 128x96, and 5 x 3 x 8 = 120
     fields of 32x64x112 (8 of the 250 frames, for the time limit); the
     curl kernel must launch once per batch and nothing else;
  6. the training path at full width, 2D and 3D: ``main --is_train True``
     trains the flagship GeneratorBE (bf16, batch 8) on a learnable
     synthetic set (the curl of a Gaussian potential blob moved by the
     parameters), resumes from its last checkpoint with
     ``--device_data_cache``, and serves a small grid from the run's
     weights.npz; the loss must fall, sample PNGs must be written and every
     kernel's launch count must be exact per step.  Then one f32 train
     step through the kernels against the same step through the plain ops
     (loss and every parameter's gradient);
  5. timing (printed only): generator + curl throughput (2D batch 512, 3D
     batch 32), the device time of a train step (2D batch 8 and 64, 3D
     batch 8; kernels and plain ops), train steps/s end to end, each kernel
     alone against its plain version, and profile lines by kernel.

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
# the serving sweep's (--test_batch_size), 512 the timed one; (4, 2, 5) is
# below the backward kernels' minimum extent.  3D: config #5's grid at the
# same batches, odd extents, the smallest backward grid, and D, H or W = 2.
KERNEL_SHAPES = {
    2: [(1, 128, 96), (8, 128, 96), (32, 128, 96), (512, 128, 96),
        (3, 8, 8), (2, 16, 12), (4, 2, 5)],
    3: [(1, 32, 64, 112), (8, 32, 64, 112), (32, 32, 64, 112),
        (2, 5, 6, 7), (1, 3, 3, 3), (1, 2, 6, 7), (1, 5, 2, 7),
        (1, 5, 6, 2)],
}


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

    @property
    def potential(self) -> int:
        """Channels of the generator's output: psi (2D) or Psi (3D)."""
        return 1 if len(self.resolution) == 2 else 3

    @property
    def channels(self) -> int:
        """Velocity channels: one per spatial axis."""
        return len(self.resolution)


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
PATHS = (PATH_2D, PATH_3D)
# The flagship width of both paths (the config.py defaults).
FLAGSHIP = {"filters": 128, "num_conv": 4}

# name -> (csrc file, the TPU kernel it replaces, its inputs' channels, the
# spatial dims it takes)
KERNELS = {
    "curl2d_fused": ("fd2d.cu", "deepfluids_tpu/ops/pallas_fd.py:98", [1], 2),
    "jacobian2d_fused": ("fd2d.cu", "deepfluids_tpu/ops/pallas_fd.py:143",
                         [2], 2),
    "curl2d_bwd": ("fd2d.cu", "deepfluids_tpu/ops/pallas_fd.py:323", [2], 2),
    "jacobian2d_bwd": ("fd2d.cu", "deepfluids_tpu/ops/pallas_fd.py:387",
                       [4, 1], 2),
    "curl3d_fused": ("fd3d.cu", "deepfluids_tpu/ops/pallas_fd.py:214", [3],
                     3),
    "jacobian3d_fused": ("fd3d.cu", "deepfluids_tpu/ops/pallas_fd.py:255",
                         [3], 3),
    "curl3d_bwd": ("fd3d.cu", "deepfluids_tpu/ops/pallas_fd.py:470", [3], 3),
    "jacobian3d_bwd": ("fd3d.cu", "deepfluids_tpu/ops/pallas_fd.py:520",
                       [9, 3], 3),
}
# Channels each kernel must read and write once per point (its minimum
# traffic): curl2d 1 -> 2, jacobian2d 2 -> 4 + 1, curl2d_bwd 2 -> 1,
# jacobian2d_bwd 4 + 1 -> 2; curl3d 3 -> 3, jacobian3d 3 -> 9 + 3,
# curl3d_bwd 3 -> 3, jacobian3d_bwd 9 + 3 -> 3.
CHANNELS_MOVED = {"curl2d_fused": 3, "jacobian2d_fused": 7,
                  "curl2d_bwd": 3, "jacobian2d_bwd": 7, "curl3d_fused": 6,
                  "jacobian3d_fused": 15, "curl3d_bwd": 6,
                  "jacobian3d_bwd": 15}


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


def expected_launches(counts: dict) -> dict:
    """Every kernel's launch count: ``counts``, zero for the others."""
    from deepfluids_tpu_torch.ops import cuda_fd

    return {**dict.fromkeys(cuda_fd.launch_counts, 0), **counts}


def phase_build(card: str) -> dict:
    from deepfluids_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    with open(os.path.join(_build.build_dir(), "build.log")) as f:
        ptxas = [ln.strip() for ln in f
                 if "registers" in ln or "Compiling entry" in ln]
    print(f"phase 1 device+build: ok  card: {card}  nvcc build+load "
          f"{secs:.2f} s  ptxas: {' | '.join(ptxas)}", flush=True)
    return {"build_s": secs}


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
        tol = TOL_GRAD if bwd else TOL_KERNEL
        plain = plain_version(name)
        for dtype in (torch.float32, torch.bfloat16):
            for shape in KERNEL_SHAPES[nd]:
                xs = kernel_inputs(name, shape, dtype, gen, device)
                if bwd and min(shape[1:]) < 3:
                    try:
                        getattr(cuda_fd, name)(*xs)
                    except ValueError:
                        continue
                    raise AssertionError(f"{name} accepted extent < 3: "
                                         f"{shape}")
                with torch.inference_mode():
                    got = getattr(cuda_fd, name)(*xs)
                    want = plain(*xs)
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                for g, wt in zip(got, want):
                    if g.shape != wt.shape or g.dtype != dtype:
                        raise AssertionError(f"{name} gave {g.shape} "
                                             f"{g.dtype}, want {wt.shape}")
                    diff = (g.float() - wt.float()).abs()
                    err = float(diff.max())
                    if dtype == torch.float32:
                        ok = err <= tol
                        worst[name] = max(worst[name], err)
                    else:   # within one bf16 ulp of the f32 math
                        ok = bool((diff <= BF16_ULP * wt.float().abs()
                                   ).all())
                        bf16_worst[name] = max(bf16_worst[name], err)
                    if not ok:
                        raise AssertionError(f"{name} {dtype} {shape}: "
                                             f"max abs err {err}")
    # Gradients through the autograd Functions against autograd of the
    # plain ops: the JAX tests' shapes and the flagship training batches.
    grad_err = {2: 0.0, 3: 0.0}
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
        print(f"phase 2 kernel vs plain {nd}D: ok  {len(names)} kernels x "
              f"{len(KERNEL_SHAPES[nd])} shapes x f32/bf16; f32 max abs err "
              f"{ {n: worst[n] for n in names} } (tol fwd {TOL_KERNEL}, bwd "
              f"{TOL_GRAD}); bf16 within one ulp of f32 math (max abs err "
              f"{ {n: bf16_worst[n] for n in names} }); bwd refuses extent "
              f"< 3; autograd vs plain autograd max abs err "
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
        v_range=list(v_range), data_type="velocity",
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
    os.makedirs(os.path.join(ds, "v"))
    lo = [r[0] for r in path.param_ranges]
    for k in range(files):
        scene, frame = divmod(k, 3)
        np.savez_compressed(
            os.path.join(ds, "v", f"{scene}_0_{frame}.npz"),
            x=rng.standard_normal(tuple(path.resolution) + (
                path.channels,)).astype(np.float32),
            y=np.array([lo[0] + 0.03 * scene, lo[1], frame], np.float32))
    run = os.path.join(root, f"run_{path.name}")
    save_config(Config(data_dir=data_dir, dataset=path.dataset,
                       compute_dtype="bfloat16", **FLAGSHIP), run)
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
    n_data = len(glob.glob(os.path.join(root, "data", path.dataset, "v",
                                        "*.npz")))
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
                             f"{launches}, expected {expect}: the curl once "
                             f"per batch ({batches}) and nothing else")

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

    # The first batch again, through the plain curl: same fields.
    model = flagship_model(path)
    load_flax_npz(os.path.join(run, "weights.npz"), model)
    model.to(device)
    manifest = load_manifest(os.path.join(root, "data", path.dataset))
    raw = param_grid(manifest, [int(c) for c in counts.split(",")], frames)
    p = torch.from_numpy(manifest.normalize_params(raw[:bs])).to(device)
    curl = fd.curl2d if path.potential == 1 else fd.curl3d
    with torch.inference_mode():
        ref = manifest.denormalize_field(curl(model(p)).cpu().numpy())
    torch.backends.cudnn.deterministic = False
    got = np.stack([np.load(os.path.join(out_dir, f"0_{k}.npz"))["x"]
                    for k in range(min(bs, frames))])
    l2 = normalized_l2(got, ref[:len(got)])
    if not l2 < TOL_PARITY:
        raise AssertionError(f"sweep fields vs plain curl: L2 {l2} >= "
                             f"{TOL_PARITY}")
    curl_name = next(iter(path.forward_launches))
    cut = ("" if frames == path.num_frames else
           f" ({frames} of the {path.num_frames} frames, cut for the time "
           f"limit)")
    print(f"phase 4 serving path {path.name.upper()}: ok  main() "
          f"--test_counts {counts} --test_frames {frames}{cut}: {n_fields} "
          f"fields of {'x'.join(map(str, field_shape))}, {len(pngs)} PNGs + "
          f"GIF in {secs:.2f} s ({n_fields / secs:.1f} fields/s end to end "
          f"incl. build/load/eval/writes); {curl_name} launches "
          f"{launches[curl_name]} = {batches} batches, no other kernel; eval "
          f"l2_mean {ev['l2_mean']:.4f}; sweep vs plain-curl L2 {l2:.2e}",
          flush=True)
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


def make_train_dataset(root: str, path: MainPath) -> str:
    """A learnable synthetic dataset of ``path``'s shape under its published
    manifest (v_range from the fields); its data dir."""
    data_dir = os.path.join(root, f"train_data_{path.name}")
    ds = os.path.join(data_dir, path.dataset)
    os.makedirs(os.path.join(ds, "v"))
    fields = _train_fields_2d if path.potential == 1 else _train_fields_3d
    vmax = 0.0
    for name, x, y in fields(path):
        vmax = max(vmax, float(np.abs(x).max()))
        np.savez(os.path.join(ds, "v", name), x=x, y=y)
    save_path_manifest(path, ds, (-4.0, 4.0) if path.potential == 1
                       else (-vmax, vmax))
    return data_dir


def _metrics(run: str) -> list[dict]:
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def phase_train(device, root: str, path: MainPath) -> dict:
    """Train, resume and serve ``path`` through ``main`` at the flagship
    width."""
    import torch

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
             "--num_conv", str(FLAGSHIP["num_conv"])]
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
                      "--device_data_cache", "true"],
             n1 - n0, n1 // save - n0 // save)):
        cuda_fd.reset_launch_counts()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        main(get_config(argv), device=device)
        torch.cuda.synchronize(device)
        secs = time.perf_counter() - t0
        launches = dict(cuda_fd.launch_counts)
        if launches != per_step(steps, dumps):
            raise AssertionError(f"{path.name} training launched "
                                 f"{launches}, want {per_step(steps, dumps)}"
                                 f" for {steps} steps and {dumps} sample "
                                 f"dumps")
        runs.append({"secs": secs, "launches": launches, "steps": steps})

    rows = _metrics(run)
    steps = [r["step"] for r in rows]
    want = list(range(path.log_step, n1 + 1, path.log_step))
    if steps != want:   # the resume must start at the saved step
        raise AssertionError(f"metrics steps {steps}, want {want}")
    losses = [r["loss"] for r in rows]
    first, last = rows[0]["loss"], rows[n0 // path.log_step - 1]["loss"]
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"loss did not fall: {losses}")
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
    n_data = len(glob.glob(os.path.join(data_dir, path.dataset, "v",
                                        "*.npz")))
    batches = 1 + -(-min(128, n_data) // 32)
    want = expected_launches({k: batches * n for k, n in
                              path.forward_launches.items()})
    if not (np.isfinite(result["eval"]["l2_mean"]) and served == want):
        raise AssertionError(f"serving the trained run: {result['eval']}, "
                             f"launches {served}, want {want}")
    rate = {"stream": rows[n0 // path.log_step - 1]["steps_per_sec"],
            "cache": rows[-1]["steps_per_sec"]}
    nonzero = {k: v for k, v in runs[0]["launches"].items() if v}
    print(f"phase 6 training path {path.name.upper()}: ok  main() --is_train "
          f"True flagship GeneratorBE bf16 batch 8 on {n_data} synthetic "
          f"frames (made in {data_s:.2f} s): {n0} steps in "
          f"{runs[0]['secs']:.2f} s, resumed at step {n0} with "
          f"--device_data_cache to {n1} in {runs[1]['secs']:.2f} s; loss "
          f"{first:.4f} (step {path.log_step}) -> {last:.4f} (step {n0}) -> "
          f"{losses[-1]:.4f} (step {n1}); launches of the first run "
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
    # conv_out's bias against the largest entry of all gradients, since the
    # curl annihilates a constant potential and its gradient is rounding
    # noise.
    scale = max(float(g.abs().max()) for g in gp.values())
    err = {n: float((gk[n] - gp[n]).abs().max()) / (
        scale if n == "conv_out.bias" else float(gp[n].abs().max()))
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


def kernel_timing(device, card: str, names: list[str],
                  batches: tuple[int, ...], path: MainPath,
                  seed: int) -> dict:
    """Each kernel alone at ``[b, *resolution, .]`` for each batch, f32 and
    bf16, against its plain version, alternated."""
    import torch

    from deepfluids_tpu_torch.ops import cuda_fd

    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name in names:
        fn, plain = getattr(cuda_fd, name), plain_version(name)
        for b in batches:
            shape = (b,) + tuple(path.resolution)
            for dtype in (torch.float32, torch.bfloat16):
                xs = kernel_inputs(name, shape, dtype, gen, device)
                with torch.inference_mode():
                    kern, pl, runs = alternated(lambda: plain(*xs),
                                                lambda: fn(*xs), 50)
                out[(name, b, dtype)] = (kern, pl)
                nbytes = (math.prod(shape) * CHANNELS_MOVED[name]
                          * (4 if dtype == torch.float32 else 2))
                print(f"phase 5 timing [{card}]: {name} "
                      f"[{','.join(map(str, shape))}] {dtype}: kernel "
                      f"{kern:.4f} ms ({nbytes / kern / 1e6:.0f} GB/s), "
                      f"plain {pl:.4f} ms (p {runs[0]:.4f} k {runs[1]:.4f} "
                      f"k {runs[2]:.4f} p {runs[3]:.4f})", flush=True)
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


def profile_line(what: str, fn, wall_ms: float, iters: int = 3) -> None:
    """Print device time by kernel of ``iters`` calls of ``fn`` and the
    idle share against ``wall_ms`` per call."""
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
    rows = sorted(((e.self_device_time_total / iters / 1e3, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  reverse=True)
    total = sum(r[0] for r in rows)
    top = "; ".join(f"{name[:60]} {ms:.3f} ms" for ms, name in rows[:8])
    fd_rows = "; ".join(f"{name[:40]} {ms:.4f} ms" for ms, name in rows
                        if "curl" in name or "jacobian" in name)
    print(f"profile {what}: kernels {total:.3f} ms/iter of {wall_ms:.3f} ms "
          f"wall (idle share {1 - total / wall_ms:.3f}); by kernel: {top}; "
          f"FD kernels: {fd_rows}", flush=True)


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
        for path in PATHS:
            tt = train_timing[path.name]
            t = tt["trainer"]
            x, y = t._load_device_cache()
            x, y = x[:8].float(), y[:8]
            profile_line(f"{path.name.upper()} train step batch 8 bf16 "
                         f"[{card}]", lambda: t._train_step(x, y),
                         tt["step_ms"][8][0])
    except Exception as e:  # noqa: BLE001
        print(f"profile: not measured ({type(e).__name__}: {e})")


def main() -> None:
    # The smoke runs on one card: show CUDA only the first visible one, so
    # the device count reported last is the card the run used.
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    os.environ["CUDA_VISIBLE_DEVICES"] = visible
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    device = torch.device("cuda", 0)
    card = card_line()
    t_start = time.perf_counter()

    def timed(label: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        print(f"  {label} wall {time.perf_counter() - t0:.2f} s", flush=True)
        return out

    timed("phase 1", phase_build, card)
    worst = timed("phase 2", phase_kernels, device)
    timed("phase 3", phase_golden, device)
    serving, train, timing, train_timing = {}, {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        for path in PATHS:
            tag = path.name.upper()
            serving[path.name] = timed(f"phase 4 {tag}", phase_serving,
                                       device, root, path)
            train[path.name] = timed(f"phase 6 {tag}", phase_train, device,
                                     root, path)
            timed(f"phase 6 parity {tag}", phase_train_parity, device,
                  train[path.name], path)
        timing["2d"] = timed("phase 5 2D serving", phase_timing, device,
                             serving["2d"]["weights"], card, PATH_2D,
                             (512, 32), 10, (512, 32))
        train_timing["2d"] = timed(
            "phase 5 2D training", phase_train_timing, device, train["2d"],
            card, PATH_2D, (8, 64),
            ["jacobian2d_fused", "curl2d_bwd", "jacobian2d_bwd"], (512, 8))
        timing["3d"] = timed("phase 5 3D serving", phase_timing, device,
                             serving["3d"]["weights"], card, PATH_3D, (32,),
                             5, (32, 8))
        train_timing["3d"] = timed(
            "phase 5 3D training", phase_train_timing, device, train["3d"],
            card, PATH_3D, (8,),
            ["jacobian3d_fused", "curl3d_bwd", "jacobian3d_bwd"], (32, 8))
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
            by_path[f"serving_{p.name}"] = serving[p.name]["launches"][name]
            by_path[f"train_{p.name}"] = sum(
                r["launches"][name] for r in train[p.name]["runs"])
        if by_path[f"train_{path.name}"] == 0 or (
                name in path.forward_launches
                and by_path[f"serving_{path.name}"] == 0):
            raise AssertionError(f"{name} never launched on the "
                                 f"{path.name} path: {by_path}")
        # The time at the timed shape: 2D [512,128,96,.], 3D
        # [32,32,64,112,.], f32.
        b = 512 if nd == 2 else 32
        times = (timing[path.name]["curl"] if name in path.forward_launches
                 else train_timing[path.name]["kernel_ms"])
        ms, plain_ms = times[(name, b, torch.float32)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"deepfluids_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": worst[name],
            "ms": ms, "plain_ms": plain_ms})
    print(f"total wall {time.perf_counter() - t_start:.2f} s", flush=True)
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
