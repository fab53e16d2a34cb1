"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the repo root, one card, no args

Drives the port's serving and training paths through the entry point a user
calls and checks every kernel on the way.  Phases, one line each (or a
few); any failure raises and the script exits non-zero:

  1. device and build: the card, its power limit, nvcc build of csrc/*.cu;
  2. each kernel against its plain PyTorch version on the card, at the
     serving and training shapes and odd ones, f32 and bf16, plus the fd2d
     golden; the backward kernels refuse extents < 3; gradients through
     ``curl2d_p`` / ``jacobian2d_p`` against autograd of the plain ops;
  3. the generator golden: Flax-init weights (tests/golden) through the
     port's GeneratorBE and the curl kernel, against the JAX output;
  4. the serving path at full width: ``deepfluids_tpu_torch.main.main`` on
     a synthetic 128x96 smoke dataset with the flagship GeneratorBE (bf16,
     seeded random weights), sweeping 21 x 5 x 20 = 2100 fields; the kernel
     launch count must match the batches the path ran;
  6. the training path at full width: ``main --is_train True`` trains the
     flagship GeneratorBE (bf16, batch 8) on a synthetic 256-frame
     smoke_pos21_size5-shaped dataset for 200 steps (a checkpoint at 100),
     resumes from its last checkpoint with ``--device_data_cache`` to step
     300, and serves a small grid from the run's weights.npz; the loss must
     fall and every kernel's launch count must be exact per step.  Then
     one f32 train step through the kernels against the same step through
     the plain ops (loss and every parameter's gradient);
  5. timing (printed only): generator + curl throughput at batch 512, the
     device time of a train step at batch 8 and 64 (kernels and plain
     ops), train steps/s end to end, and each kernel alone against its
     plain version.

Then it prints the kernels as one JSON line, the card's name and power
limit as nvidia-smi gives them, and, last, the ``{"ok": true, ...}`` line.
It needs no network and imports no jax.
"""

from __future__ import annotations

import contextlib
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
# 8 is the training batch, 32 the serving sweep's (--test_batch_size), 512
# the timed one; (4, 2, 5) is below the backward kernels' minimum extent.
KERNEL_SHAPES = [(1, 128, 96), (8, 128, 96), (32, 128, 96), (512, 128, 96),
                 (3, 8, 8), (2, 16, 12), (4, 2, 5)]
TRAIN_STEPS, RESUME_STEPS = 200, 300
LOG_STEP, SAVE_STEP = 20, 100     # sample dumps at every save too
# Kernel launches of one train step (curl, its backward, the jacobian of
# the prediction and of the target, the prediction's jacobian backward) and
# of one generated batch (a sample dump or a served batch: the curl).
STEP_LAUNCHES = {"curl2d_fused": 1, "curl2d_bwd": 1, "jacobian2d_fused": 2,
                 "jacobian2d_bwd": 1}
FORWARD_LAUNCHES = {"curl2d_fused": 1}

# name -> (csrc file, the TPU kernel it replaces)
KERNELS = {
    "curl2d_fused": ("fd2d.cu", "deepfluids_tpu/ops/pallas_fd.py:98"),
    "jacobian2d_fused": ("fd2d.cu", "deepfluids_tpu/ops/pallas_fd.py:143"),
    "curl2d_bwd": ("fd2d.cu", "deepfluids_tpu/ops/pallas_fd.py:323"),
    "jacobian2d_bwd": ("fd2d.cu", "deepfluids_tpu/ops/pallas_fd.py:387"),
}


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


def plain_version(name: str):
    """The plain PyTorch version a kernel is held against: the ``ops.fd``
    function on the f32-upcast input, each output rounded once to the
    input dtype (the kernels' arithmetic)."""
    from deepfluids_tpu_torch.ops import cuda_fd, fd

    fn = {"curl2d_fused": fd.curl2d, "jacobian2d_fused": fd.jacobian2d,
          "curl2d_bwd": fd.curl2d_bwd,
          "jacobian2d_bwd": fd.jacobian2d_bwd}[name]
    return lambda *xs: cuda_fd._in_f32(fn, *xs)


def kernel_inputs(name: str, b: int, h: int, w: int, dtype, gen, device):
    import torch

    chans = {"curl2d_fused": [1], "jacobian2d_fused": [2],
             "curl2d_bwd": [2], "jacobian2d_bwd": [4, 1]}[name]
    return [torch.randn((b, h, w, c), generator=gen, device=device).to(dtype)
            for c in chans]


@contextlib.contextmanager
def plain_fd_ops():
    """The training loss through the plain ops instead of the kernels, for
    the comparisons below: ``losses`` looks ``curl2d_p`` / ``jacobian2d_p``
    up on ``cuda_fd`` at call time."""
    from deepfluids_tpu_torch.ops import cuda_fd, fd

    saved = cuda_fd.curl2d_p, cuda_fd.jacobian2d_p
    cuda_fd.curl2d_p, cuda_fd.jacobian2d_p = fd.curl2d, fd.jacobian2d
    try:
        yield
    finally:
        cuda_fd.curl2d_p, cuda_fd.jacobian2d_p = saved


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
    for name in KERNELS:
        bwd = name.endswith("_bwd")
        tol = TOL_GRAD if bwd else TOL_KERNEL
        plain = plain_version(name)
        for dtype in (torch.float32, torch.bfloat16):
            for b, h, w in KERNEL_SHAPES:
                xs = kernel_inputs(name, b, h, w, dtype, gen, device)
                if bwd and min(h, w) < 3:
                    try:
                        getattr(cuda_fd, name)(*xs)
                    except ValueError:
                        continue
                    raise AssertionError(f"{name} accepted extent < 3: "
                                         f"{(b, h, w)}")
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
                        raise AssertionError(f"{name} {dtype} {(b, h, w)}: "
                                             f"max abs err {err}")
    # Gradients through the autograd Functions against autograd of the
    # plain ops: the JAX test's shape and the flagship training batch.
    grad_err = 0.0
    for shape in ((2, 16, 12), (8, 128, 96)):
        for fn, plain, chans, cot in (
                (cuda_fd.curl2d_p, fd.curl2d, 1, [2]),
                (cuda_fd.jacobian2d_p, fd.jacobian2d, 2, [4, 1])):
            x = torch.randn(shape + (chans,), generator=gen, device=device)
            cots = [torch.randn(shape + (c,), generator=gen, device=device)
                    for c in cot]
            grads = []
            for f in (fn, plain):
                a = x.clone().requires_grad_()
                out = f(a)
                out = out if isinstance(out, tuple) else (out,)
                torch.autograd.backward(list(out), cots)
                grads.append(a.grad)
            err = float((grads[0] - grads[1]).abs().max())
            if not err <= TOL_GRAD:
                raise AssertionError(f"autograd through {fn.__name__} "
                                     f"{shape}: {err} > {TOL_GRAD}")
            grad_err = max(grad_err, err)
    g = np.load(os.path.join(REPO, "tests", "golden", "fd2d.npz"))
    with torch.inference_mode():
        u = cuda_fd.curl2d_fused(torch.from_numpy(g["psi"]).to(device))
        j, w = cuda_fd.jacobian2d_fused(torch.from_numpy(g["u"]).to(device))
        div = fd.divergence2d(u)[:, :-2, :-2]
    l2 = max(normalized_l2(u.cpu().numpy(), g["u"]),
             normalized_l2(j.cpu().numpy(), g["j"]),
             normalized_l2(w.cpu().numpy(), g["w"]))
    div_max = float(div.abs().max())
    if not (l2 < TOL_PARITY and div_max <= 1e-5):
        raise AssertionError(f"fd2d golden: L2 {l2}, interior div {div_max}")
    print(f"phase 2 kernel vs plain: ok  {len(KERNELS)} kernels x "
          f"{len(KERNEL_SHAPES)} shapes x f32/bf16; f32 max abs err "
          f"{worst} (tol fwd {TOL_KERNEL}, bwd {TOL_GRAD}); bf16 within one "
          f"ulp of f32 math (max abs err {bf16_worst}); bwd refuses extent "
          f"< 3; autograd vs plain autograd max abs err {grad_err:.3e} (tol "
          f"{TOL_GRAD}); fd2d golden (u, J, vort) L2 {l2:.3e}, interior div "
          f"{div_max:.3e}", flush=True)
    return worst


def phase_golden(device) -> None:
    import torch

    from deepfluids_tpu_torch.models import GeneratorBE, load_flax_npz
    from deepfluids_tpu_torch.train.losses import apply_curl
    from deepfluids_tpu_torch.utils.parity import check_fields

    # The JAX golden was made in full f32: no TF32 in convs or matmuls.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    golden = os.path.join(REPO, "tests", "golden")
    g = np.load(os.path.join(golden, "generator2d.npz"))
    model = GeneratorBE((32, 24, 1), num_param=3, filters=8, num_conv=2)
    load_flax_npz(os.path.join(golden, "generator2d_params.npz"), model)
    model.to(device)
    with torch.inference_mode():
        u = apply_curl(model(torch.from_numpy(g["p"]).to(device)))
    res = check_fields(u.cpu().numpy(), g["u"], TOL_PARITY)
    if not res["passed"]:
        raise AssertionError(f"generator golden failed: {res}")
    print(f"phase 3 generator golden: ok  GeneratorBE 32x24 f8 c2 f32 + "
          f"curl kernel vs JAX max L2 {res['max_l2']:.3e} (tol "
          f"{TOL_PARITY})", flush=True)


def save_smoke_manifest(ds: str) -> None:
    """The published smoke_pos21_size5 manifest (128x96x2 velocity)."""
    from deepfluids_tpu_torch.data import Manifest, save_manifest

    save_manifest(Manifest(
        param_names=["src_x_pos", "src_radius", "frame"],
        param_ranges=[[0.2, 0.8], [0.04, 0.12], [0.0, 199.0]],
        num_scenes=105, num_frames=200, resolution=[128, 96],
        num_channels=2, v_range=[-4.0, 4.0], data_type="velocity",
        param_counts=[21, 5]), ds)


def make_serving_run(root: str, seed: int = 0, files: int = 6) -> str:
    """A synthetic smoke_pos21_size5-shaped dataset (128x96x2 fields) and a
    run dir with flagship params.json (bf16) and seeded weights.npz."""
    import torch

    from deepfluids_tpu_torch.config import Config, save_config
    from deepfluids_tpu_torch.models import GeneratorBE, flax_shapes

    rng = np.random.default_rng(seed)
    data_dir = os.path.join(root, "data")
    ds = os.path.join(data_dir, "smoke_pos21_size5")
    save_smoke_manifest(ds)
    os.makedirs(os.path.join(ds, "v"))
    for k in range(files):
        scene, frame = divmod(k, 3)
        np.savez_compressed(
            os.path.join(ds, "v", f"{scene}_0_{frame}.npz"),
            x=rng.standard_normal((128, 96, 2)).astype(np.float32),
            y=np.array([0.2 + 0.03 * scene, 0.04, frame], np.float32))
    run = os.path.join(root, "run")
    save_config(Config(data_dir=data_dir, dataset="smoke_pos21_size5",
                       compute_dtype="bfloat16"), run)
    # Flax-layout weights, lecun-normal-scaled, zero biases (Flax's init).
    shapes = flax_shapes(GeneratorBE((128, 96, 1), num_param=3,
                                     filters=128, num_conv=4,
                                     compute_dtype=torch.bfloat16))
    weights = {}
    for key, shape in shapes.items():
        if key.endswith("/bias"):
            weights[key] = np.zeros(shape, np.float32)
        else:
            fan_in = math.prod(shape[:-1])
            weights[key] = (rng.standard_normal(shape)
                            / math.sqrt(fan_in)).astype(np.float32)
    np.savez(os.path.join(run, "weights.npz"), **weights)
    return run


def phase_serving(device, root: str, counts: str = "21,5",
                  frames: int = 20) -> dict:
    import torch

    from deepfluids_tpu_torch.config import get_config
    from deepfluids_tpu_torch.data import load_manifest
    from deepfluids_tpu_torch.infer.sweep import param_grid
    from deepfluids_tpu_torch.main import main
    from deepfluids_tpu_torch.models import GeneratorBE, load_flax_npz
    from deepfluids_tpu_torch.ops import cuda_fd, fd
    from deepfluids_tpu_torch.utils.parity import normalized_l2

    # Deterministic cuDNN, so the recomputation below runs the convolutions
    # the sweep ran and any difference is the curl's.
    torch.backends.cudnn.deterministic = True
    run = make_serving_run(root)
    cfg = get_config(["--is_train", "False", "--load_path", run,
                      "--test_counts", counts, "--test_frames", str(frames)])
    n_fields = math.prod(int(c) for c in counts.split(",")) * frames
    n_data = len(glob.glob(os.path.join(root, "data", "*", "v", "*.npz")))
    bs = cfg.test_batch_size
    expect = -(-n_fields // bs) + -(-min(128, n_data) // bs)

    cuda_fd.reset_launch_counts()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    result = main(cfg, device=device)
    torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    launches = dict(cuda_fd.launch_counts)
    if launches != {**dict.fromkeys(launches, 0), "curl2d_fused": expect}:
        raise AssertionError(f"the serving path launched {launches}, "
                             f"expected curl2d_fused once per batch "
                             f"({expect}) and nothing else")

    out_dir = os.path.join(run, "test")
    files = sorted(glob.glob(os.path.join(out_dir, "*.npz")))
    if result["num_fields"] != n_fields or len(files) != n_fields:
        raise AssertionError(f"{len(files)} .npz written, {n_fields} wanted")
    for path in files:
        with np.load(path) as d:
            if (d["x"].shape != (128, 96, 2) or d["y"].shape != (3,)
                    or not np.isfinite(d["x"]).all()):
                raise AssertionError(f"bad artifact {path}")
    ev = result["eval"]
    if not np.isfinite(ev["l2_mean"]):
        raise AssertionError(f"eval not finite: {ev}")
    pngs = glob.glob(os.path.join(out_dir, "*.png"))
    if not pngs or not os.path.exists(os.path.join(out_dir, "scene0.gif")):
        raise AssertionError("PNG / GIF artifacts missing")

    # The first batch again, through the plain curl: same fields.
    model = GeneratorBE((128, 96, 1), num_param=3, filters=128, num_conv=4,
                        compute_dtype=torch.bfloat16)
    load_flax_npz(os.path.join(run, "weights.npz"), model)
    model.to(device)
    manifest = load_manifest(os.path.join(root, "data", "smoke_pos21_size5"))
    raw = param_grid(manifest, [int(c) for c in counts.split(",")], frames)
    p = torch.from_numpy(manifest.normalize_params(raw[:bs])).to(device)
    with torch.inference_mode():
        ref = manifest.denormalize_field(fd.curl2d(model(p)).cpu().numpy())
    torch.backends.cudnn.deterministic = False
    got = np.stack([np.load(os.path.join(out_dir, f"0_{k}.npz"))["x"]
                    for k in range(min(bs, frames))])
    l2 = normalized_l2(got, ref[:len(got)])
    if not l2 < TOL_PARITY:
        raise AssertionError(f"sweep fields vs plain curl: L2 {l2} >= "
                             f"{TOL_PARITY}")
    print(f"phase 4 serving path: ok  main() --test_counts {counts} "
          f"--test_frames {frames}: {n_fields} fields, {len(pngs)} PNGs + "
          f"GIF in {secs:.2f} s ({n_fields / secs:.1f} fields/s end to end "
          f"incl. build/load/eval/writes); curl2d_fused launches "
          f"{launches['curl2d_fused']} = {expect} batches; eval l2_mean "
          f"{ev['l2_mean']:.4f}; sweep vs plain-curl L2 {l2:.2e}", flush=True)
    return {"launches": launches, "serving_s": secs, "fields": n_fields,
            "weights": os.path.join(run, "weights.npz")}


def make_train_dataset(root: str, scenes: int = 16, frames: int = 16) -> str:
    """A learnable synthetic smoke_pos21_size5-shaped dataset: 128x96x2
    velocity fields, the curl of a Gaussian stream-function blob whose x
    position, radius and height follow (src_x_pos, src_radius, frame).
    ``scenes * frames`` files (256 by default, of the published 21 000)."""
    data_dir = os.path.join(root, "train_data")
    ds = os.path.join(data_dir, "smoke_pos21_size5")
    save_smoke_manifest(ds)
    os.makedirs(os.path.join(ds, "v"))
    yy, xx = np.meshgrid(np.linspace(0, 1, 128), np.linspace(0, 0.75, 96),
                         indexing="ij")
    for s in range(scenes):
        pos, size = divmod(s, 4)
        x_pos, radius = 0.2 + 0.6 * pos / 3, 0.04 + 0.08 * size / 3
        for f in range(frames):
            frame = 199.0 * f / (frames - 1)
            cy = 0.1 + 0.8 * frame / 199.0
            r = 2.0 * radius + 0.05
            psi = np.exp(-((xx - 0.75 * x_pos) ** 2 + (yy - cy) ** 2)
                         / (2 * r * r))
            u = np.diff(psi, axis=0, append=psi[-1:]) * 128
            v = -np.diff(psi, axis=1, append=psi[:, -1:]) * 96
            np.savez(os.path.join(ds, "v", f"{pos * 5}_{size}_{f}.npz"),
                     x=np.stack([u, v], -1).astype(np.float32),
                     y=np.array([x_pos, radius, frame], np.float32))
    return data_dir


def _metrics(run: str) -> list[dict]:
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def phase_train(device, root: str, extra: tuple[str, ...] = ()) -> dict:
    """Train, resume and serve through ``main`` at the flagship width
    (``extra`` flags narrow it for a rehearsal on the CPU)."""
    import torch

    from deepfluids_tpu_torch.config import get_config
    from deepfluids_tpu_torch.main import main
    from deepfluids_tpu_torch.ops import cuda_fd

    data_dir = make_train_dataset(root)
    logs = os.path.join(root, "logs")
    flags = ["--is_train", "True", "--arch", "de", "--data_dir", data_dir,
             "--dataset", "smoke_pos21_size5", "--log_dir", logs, "--tag",
             "chip", "--batch_size", "8", "--compute_dtype", "bfloat16",
             "--log_step", str(LOG_STEP), "--save_step", str(SAVE_STEP),
             "--test_step", str(SAVE_STEP),
             "--num_worker", "4", *extra]
    run = os.path.join(logs, "smoke_pos21_size5_chip")

    def per_step(steps: int, dumps: int) -> dict:
        return {k: steps * n + dumps * FORWARD_LAUNCHES.get(k, 0)
                for k, n in STEP_LAUNCHES.items()}

    runs = []
    for argv, steps, dumps in (
            (flags + ["--max_step", str(TRAIN_STEPS)], TRAIN_STEPS,
             TRAIN_STEPS // SAVE_STEP),
            (flags + ["--max_step", str(RESUME_STEPS), "--load_path", run,
                      "--device_data_cache", "true"],
             RESUME_STEPS - TRAIN_STEPS,
             RESUME_STEPS // SAVE_STEP - TRAIN_STEPS // SAVE_STEP)):
        cuda_fd.reset_launch_counts()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        main(get_config(argv), device=device)
        torch.cuda.synchronize(device)
        secs = time.perf_counter() - t0
        launches = dict(cuda_fd.launch_counts)
        if launches != per_step(steps, dumps):
            raise AssertionError(f"training launched {launches}, want "
                                 f"{per_step(steps, dumps)} for {steps} "
                                 f"steps and {dumps} sample dumps")
        runs.append({"secs": secs, "launches": launches, "steps": steps})

    rows = _metrics(run)
    steps = [r["step"] for r in rows]
    want = list(range(LOG_STEP, RESUME_STEPS + 1, LOG_STEP))
    if steps != want:   # the resume must start at the saved step
        raise AssertionError(f"metrics steps {steps}, want {want}")
    losses = [r["loss"] for r in rows]
    first, last = rows[0]["loss"], rows[TRAIN_STEPS // LOG_STEP - 1]["loss"]
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"loss did not fall: {losses}")
    ckpts = sorted(int(n) for n in os.listdir(os.path.join(run, "checkpoint")))
    saves = list(range(SAVE_STEP, RESUME_STEPS + 1, SAVE_STEP))
    if ckpts != sorted({*saves, TRAIN_STEPS, RESUME_STEPS})[-3:] or len(
            os.listdir(os.path.join(run, "sample"))) != len(saves):
        raise AssertionError(f"checkpoints {ckpts}, samples "
                             f"{os.listdir(os.path.join(run, 'sample'))}")

    # Serve a small grid from the trained run's weights.npz.
    cuda_fd.reset_launch_counts()
    result = main(get_config(["--is_train", "False", "--load_path", run,
                              "--test_counts", "3,2", "--test_frames", "4"]),
                  device=device)
    served = dict(cuda_fd.launch_counts)
    files = sorted(glob.glob(os.path.join(run, "test", "*.npz")))
    if result["num_fields"] != 24 or len(files) != 24:
        raise AssertionError(f"served {len(files)} fields, want 24")
    for path in files:
        with np.load(path) as d:
            if d["x"].shape != (128, 96, 2) or not np.isfinite(d["x"]).all():
                raise AssertionError(f"bad artifact {path}")
    # one sweep batch of 24 fields and 4 evaluate batches of 32
    want = {k: 5 * FORWARD_LAUNCHES.get(k, 0) for k in served}
    if not (np.isfinite(result["eval"]["l2_mean"]) and served == want):
        raise AssertionError(f"serving the trained run: {result['eval']}, "
                             f"launches {served}")
    rate = {"stream": rows[TRAIN_STEPS // LOG_STEP - 1]["steps_per_sec"],
            "cache": rows[-1]["steps_per_sec"]}
    print(f"phase 6 training path: ok  main() --is_train True flagship "
          f"GeneratorBE bf16 batch 8: {TRAIN_STEPS} steps in "
          f"{runs[0]['secs']:.2f} s, resumed at step {TRAIN_STEPS} with "
          f"--device_data_cache to {RESUME_STEPS} in {runs[1]['secs']:.2f} s;"
          f" loss {first:.4f} (step {LOG_STEP}) -> {last:.4f} (step "
          f"{TRAIN_STEPS}) "
          f"-> {losses[-1]:.4f} (step {RESUME_STEPS}); launches per run "
          f"{runs[0]['launches']} / {runs[1]['launches']} = {STEP_LAUNCHES} "
          f"per step + {FORWARD_LAUNCHES} per sample dump; checkpoints "
          f"{ckpts}; "
          f"served 24 "
          f"fields from weights.npz (eval l2_mean "
          f"{result['eval']['l2_mean']:.4f}); steps/s end to end "
          f"(metrics.jsonl) streaming {rate['stream']}, device cache "
          f"{rate['cache']}", flush=True)
    return {"run": run, "data_dir": data_dir, "runs": runs,
            "steps_per_sec": rate, "served": served}


def phase_train_parity(device, train: dict) -> None:
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
    x, y = (torch.from_numpy(a).to(device) for a in t.bm.step_batch(1))
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
    if nk != STEP_LAUNCHES or any(np_.values()):
        raise AssertionError(f"parity launches: kernels {nk}, plain {np_}")
    # Each parameter's gradient error relative to its own largest entry;
    # conv_out's bias against the largest entry of all gradients, since the
    # curl annihilates a constant psi and its gradient is rounding noise.
    scale = max(float(g.abs().max()) for g in gp.values())
    err = {n: float((gk[n] - gp[n]).abs().max()) / (
        scale if n == "conv_out.bias" else float(gp[n].abs().max()))
        for n in gk}
    worst = max(err, key=err.get)
    if not (abs(lk - lp) <= 1e-6 * abs(lp) and err[worst] <= TOL_GRAD):
        raise AssertionError(f"kernel vs plain train step: loss {lk} vs "
                             f"{lp}, relative grad errors {err}")
    print(f"phase 6 parity: ok  one f32 train step at the flagship width, "
          f"batch 8, TF32 off, deterministic cuDNN: loss kernels {lk!r} vs "
          f"plain {lp!r}; every parameter's gradient within "
          f"{err[worst]:.2e} ({worst}) of the plain one, relative to its "
          f"largest entry (tol {TOL_GRAD})", flush=True)


def phase_timing(device, weights: str, card: str) -> dict:
    import torch

    from deepfluids_tpu_torch.models import GeneratorBE, load_flax_npz
    from deepfluids_tpu_torch.ops import cuda_fd, fd

    model = GeneratorBE((128, 96, 1), num_param=3, filters=128, num_conv=4,
                        compute_dtype=torch.bfloat16)
    load_flax_npz(weights, model)
    model.to(device)
    batch = 512
    gen = torch.Generator(device=device).manual_seed(1)
    p = torch.rand((batch, 3), generator=gen, device=device) * 2 - 1
    out = {"curl": {}, "gen_curl_ms": {}}
    with torch.inference_mode():
        gen_kernel = cuda_ms(lambda: cuda_fd.curl2d_fused(model(p)), 10)
        gen_plain = cuda_ms(lambda: fd.curl2d(model(p)), 10)
        gen_only = cuda_ms(lambda: model(p), 10)
        out["gen_curl_ms"][batch] = gen_kernel
        out["fields_per_s"] = batch / (gen_kernel / 1e3)
        out["fields_per_s_plain_curl"] = batch / (gen_plain / 1e3)
        out["generator_ms"] = gen_only
        # the serving batch (--test_batch_size 32)
        out["gen_curl_ms"][32] = cuda_ms(
            lambda: cuda_fd.curl2d_fused(model(p[:32])), 20)
        for b in (512, 32):
            for dtype in (torch.float32, torch.bfloat16):
                psi = torch.randn((b, 128, 96, 1), generator=gen,
                                  device=device).to(dtype)
                # Alternate plain, kernel, kernel, plain on the same card.
                runs = (cuda_ms(lambda: fd.curl2d(psi), 50),
                        cuda_ms(lambda: cuda_fd.curl2d_fused(psi), 50),
                        cuda_ms(lambda: cuda_fd.curl2d_fused(psi), 50),
                        cuda_ms(lambda: fd.curl2d(psi), 50))
                out["curl"][(b, dtype)] = (min(runs[1:3]),
                                           min(runs[0], runs[3]), runs)
    print(f"phase 5 timing [{card}]: GeneratorBE 128x96 f128 c4 bf16 batch "
          f"{batch}: generator {gen_only:.3f} ms, +curl kernel "
          f"{gen_kernel:.3f} ms = {out['fields_per_s']:.1f} fields/s, "
          f"+plain curl {gen_plain:.3f} ms = "
          f"{out['fields_per_s_plain_curl']:.1f} fields/s; batch 32 "
          f"generator+curl kernel {out['gen_curl_ms'][32]:.3f} ms", flush=True)
    for (b, dtype), (kern, plain, runs) in out["curl"].items():
        # bytes the kernel must move: psi read once, (u, v) written once
        nbytes = b * 128 * 96 * 3 * (4 if dtype == torch.float32 else 2)
        print(f"phase 5 timing [{card}]: curl [{b},128,96,1] {dtype}: "
              f"kernel {kern:.4f} ms ({nbytes / kern / 1e6:.0f} GB/s), "
              f"plain {plain:.4f} ms (p {runs[0]:.4f} k {runs[1]:.4f} k "
              f"{runs[2]:.4f} p {runs[3]:.4f})", flush=True)
    return out


# Channels each kernel must read and write once per point (its minimum
# traffic): curl 1 -> 2, jacobian 2 -> 4 + 1, curl_bwd 2 -> 1,
# jacobian_bwd 4 + 1 -> 2.
_CHANNELS_MOVED = {"curl2d_fused": 3, "jacobian2d_fused": 7,
                   "curl2d_bwd": 3, "jacobian2d_bwd": 7}


def phase_train_timing(device, train: dict, card: str) -> dict:
    """Device ms of a train step (forward, backward, Adam) at batch 8 and
    64, bf16, through the kernels and through the plain ops; each new
    kernel alone against its plain version."""
    import torch

    from deepfluids_tpu_torch.config import load_config
    from deepfluids_tpu_torch.ops import cuda_fd
    from deepfluids_tpu_torch.train.trainer import Trainer

    cfg = load_config(train["run"])
    t = Trainer(cfg, run_dir=train["run"], device=device, save_cfg=False)
    cx, cy = t._load_device_cache()
    step_ms = {}
    for b in (8, 64):
        x, y = cx[:b].float(), cy[:b]
        step = lambda: t._train_step(x, y)  # noqa: E731

        def plain_step():
            with plain_fd_ops():
                t._train_step(x, y)

        iters = 20 if b == 8 else 10
        runs = (cuda_ms(plain_step, iters), cuda_ms(step, iters),
                cuda_ms(step, iters), cuda_ms(plain_step, iters))
        step_ms[b] = (min(runs[1:3]), min(runs[0], runs[3]), runs)
        print(f"phase 5 timing [{card}]: train step (fwd+bwd+Adam) flagship "
              f"bf16 batch {b}: kernels {step_ms[b][0]:.3f} ms "
              f"({1e3 / step_ms[b][0]:.1f} steps/s device), plain ops "
              f"{step_ms[b][1]:.3f} ms (p {runs[0]:.3f} k {runs[1]:.3f} k "
              f"{runs[2]:.3f} p {runs[3]:.3f})", flush=True)
    print(f"phase 5 timing [{card}]: train steps/s end to end "
          f"(metrics.jsonl, incl. host batches, logging, sample dumps, "
          f"checkpoints): streaming {train['steps_per_sec']['stream']}, "
          f"device cache {train['steps_per_sec']['cache']}", flush=True)

    gen = torch.Generator(device=device).manual_seed(2)
    kern_ms = {}
    for name in ("jacobian2d_fused", "curl2d_bwd", "jacobian2d_bwd"):
        fn, plain = getattr(cuda_fd, name), plain_version(name)
        for b in (512, 8):
            for dtype in (torch.float32, torch.bfloat16):
                xs = kernel_inputs(name, b, 128, 96, dtype, gen, device)
                with torch.inference_mode():
                    runs = (cuda_ms(lambda: plain(*xs), 50),
                            cuda_ms(lambda: fn(*xs), 50),
                            cuda_ms(lambda: fn(*xs), 50),
                            cuda_ms(lambda: plain(*xs), 50))
                kern, pl = min(runs[1:3]), min(runs[0], runs[3])
                kern_ms[(name, b, dtype)] = (kern, pl)
                nbytes = (b * 128 * 96 * _CHANNELS_MOVED[name]
                          * (4 if dtype == torch.float32 else 2))
                gbs = nbytes / kern / 1e6
                print(f"phase 5 timing [{card}]: {name} [{b},128,96] "
                      f"{dtype}: kernel {kern:.4f} ms ({gbs:.0f} GB/s), "
                      f"plain {pl:.4f} ms (p {runs[0]:.4f} k "
                      f"{runs[1]:.4f} k {runs[2]:.4f} p {runs[3]:.4f})",
                      flush=True)
    return {"step_ms": step_ms, "kernel_ms": kern_ms, "trainer": t}


def profile_generator(device, weights: str, wall_ms: float) -> None:
    """Device time by kernel for one batch-512 forward + curl, and the
    device's idle share against ``wall_ms`` (the unprofiled event time of
    the same call).  Printed only; the profiler is a diagnostic."""
    import torch

    from deepfluids_tpu_torch.models import GeneratorBE, load_flax_npz
    from deepfluids_tpu_torch.ops import cuda_fd

    model = GeneratorBE((128, 96, 1), num_param=3, filters=128, num_conv=4,
                        compute_dtype=torch.bfloat16)
    load_flax_npz(weights, model)
    model.to(device)
    p = torch.zeros((512, 3), device=device)
    with torch.inference_mode():
        profile_line("batch 512 fwd+curl",
                     lambda: cuda_fd.curl2d_fused(model(p)), wall_ms)


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
    print(f"profile {what}: kernels {total:.3f} ms/iter of {wall_ms:.3f} ms "
          f"wall (idle share {1 - total / wall_ms:.3f}); by kernel: {top}",
          flush=True)


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
    phase_build(card)
    worst = phase_kernels(device)
    phase_golden(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        serving = phase_serving(device, root)
        train = phase_train(device, root)
        phase_train_parity(device, train)
        timing = phase_timing(device, serving["weights"], card)
        train_timing = phase_train_timing(device, train, card)
        try:  # diagnostics only; the phases decide ok
            profile_generator(device, serving["weights"],
                              timing["gen_curl_ms"][512])
            t = train_timing["trainer"]
            x, y = t._load_device_cache()
            x, y = x[:8].float(), y[:8]
            profile_line("train step batch 8 bf16",
                         lambda: t._train_step(x, y),
                         train_timing["step_ms"][8][0])
        except Exception as e:  # noqa: BLE001
            print(f"profile: not measured ({type(e).__name__}: {e})")
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax"))
    if leaked:
        raise AssertionError(f"the port imported jax: {leaked[:5]}")
    curl_ms = timing["curl"][(512, torch.float32)][:2]
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        by_path = {"serving": serving["launches"][name],
                   "train": sum(r["launches"][name] for r in train["runs"])}
        ms, plain_ms = (curl_ms if name == "curl2d_fused" else
                        train_timing["kernel_ms"][(name, 512,
                                                   torch.float32)])
        if by_path["train"] == 0:
            raise AssertionError(f"{name} never launched on the main path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"deepfluids_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": worst[name],
            "ms": ms, "plain_ms": plain_ms})
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
