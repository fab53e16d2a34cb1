"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the repo root, one card, no args

Drives the port's serving path through the entry point a user calls and
checks every kernel on the way.  Phases, one line each; any failure raises
and the script exits non-zero:

  1. device and build: the card, its power limit, nvcc build of csrc/*.cu;
  2. each kernel against its plain PyTorch version on the card, at the
     serving shapes and odd ones, f32 and bf16, plus the fd2d golden;
  3. the generator golden: Flax-init weights (tests/golden) through the
     port's GeneratorBE and the curl kernel, against the JAX output;
  4. the serving path at full width: ``deepfluids_tpu_torch.main.main`` on
     a synthetic 128x96 smoke dataset with the flagship GeneratorBE (bf16,
     seeded random weights), sweeping 21 x 5 x 20 = 2100 fields; the kernel
     launch count must match the batches the path ran;
  5. timing (printed only): generator + curl throughput at batch 512 and
     the curl kernel alone against its plain version.

Then it prints the kernels as one JSON line, the card's name and power
limit as nvidia-smi gives them, and, last, the ``{"ok": true, ...}`` line.
It needs no network and imports no jax.
"""

from __future__ import annotations

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
TOL_PARITY = 1e-3     # the repo's normalized-L2 parity gate
# 32 is the serving sweep's batch (--test_batch_size), 512 the timed one
KERNEL_SHAPES = [(1, 128, 96), (8, 128, 96), (32, 128, 96), (512, 128, 96),
                 (3, 8, 8), (2, 16, 12)]


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


def phase_build(card: str) -> dict:
    from deepfluids_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    with open(os.path.join(_build.build_dir(), "build.log")) as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln]
    print(f"phase 1 device+build: ok  card: {card}  nvcc build+load "
          f"{secs:.2f} s  ptxas: {' | '.join(ptxas)}", flush=True)
    return {"build_s": secs}


def phase_kernels(device) -> float:
    """Kernel vs plain on the card; returns the largest abs error seen."""
    import torch

    from deepfluids_tpu_torch.ops import cuda_fd, fd
    from deepfluids_tpu_torch.utils.parity import normalized_l2

    gen = torch.Generator(device=device).manual_seed(0)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for b, h, w in KERNEL_SHAPES:
            psi = torch.randn((b, h, w, 1), generator=gen, device=device)
            psi = psi.to(dtype)
            with torch.inference_mode():
                got = cuda_fd.curl2d_fused(psi)
                want = fd.curl2d(psi)
            torch.cuda.synchronize()
            if got.shape != (b, h, w, 2) or got.dtype != dtype:
                raise AssertionError(f"curl2d_fused gave {got.shape} "
                                     f"{got.dtype} for {psi.shape} {dtype}")
            err = float((got.float() - want.float()).abs().max())
            if not err <= TOL_KERNEL:
                raise AssertionError(f"curl2d_fused {dtype} {(b, h, w)}: "
                                     f"max abs err {err} > {TOL_KERNEL}")
            worst = max(worst, err)
    g = np.load(os.path.join(REPO, "tests", "golden", "fd2d.npz"))
    with torch.inference_mode():
        u = cuda_fd.curl2d_fused(torch.from_numpy(g["psi"]).to(device))
        div = fd.divergence2d(u)[:, :-2, :-2]
    l2 = normalized_l2(u.cpu().numpy(), g["u"])
    div_max = float(div.abs().max())
    if not (l2 < TOL_PARITY and div_max <= 1e-5):
        raise AssertionError(f"fd2d golden: L2 {l2}, interior div {div_max}")
    print(f"phase 2 kernel vs plain: ok  curl2d_fused {len(KERNEL_SHAPES)} "
          f"shapes x f32/bf16 max abs err {worst} (tol {TOL_KERNEL}); "
          f"fd2d golden L2 {l2:.3e}, interior div {div_max:.3e}", flush=True)
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


def make_serving_run(root: str, seed: int = 0, files: int = 6) -> str:
    """A synthetic smoke_pos21_size5-shaped dataset (128x96x2 fields) and a
    run dir with flagship params.json (bf16) and seeded weights.npz."""
    import torch

    from deepfluids_tpu_torch.config import Config, save_config
    from deepfluids_tpu_torch.data import Manifest, save_manifest
    from deepfluids_tpu_torch.models import GeneratorBE, flax_shapes

    rng = np.random.default_rng(seed)
    data_dir = os.path.join(root, "data")
    ds = os.path.join(data_dir, "smoke_pos21_size5")
    save_manifest(Manifest(
        param_names=["src_x_pos", "src_radius", "frame"],
        param_ranges=[[0.2, 0.8], [0.04, 0.12], [0.0, 199.0]],
        num_scenes=105, num_frames=200, resolution=[128, 96],
        num_channels=2, v_range=[-4.0, 4.0], data_type="velocity",
        param_counts=[21, 5]), ds)
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
    launches = cuda_fd.launch_counts["curl2d_fused"]
    if launches != expect or launches == 0:
        raise AssertionError(f"curl2d_fused launched {launches} times on the "
                             f"serving path, expected {expect} batches")

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
          f"incl. build/load/eval/writes); curl2d_fused launches {launches} "
          f"= {expect} batches; eval l2_mean {ev['l2_mean']:.4f}; sweep vs "
          f"plain-curl L2 {l2:.2e}", flush=True)
    return {"launches": launches, "serving_s": secs, "fields": n_fields,
            "weights": os.path.join(run, "weights.npz")}


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


def profile_generator(device, weights: str, wall_ms: float) -> None:
    """Device time by kernel for one batch-512 forward + curl, and the
    device's idle share against ``wall_ms`` (the unprofiled event time of
    the same call).  Printed only; the profiler is a diagnostic."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepfluids_tpu_torch.models import GeneratorBE, load_flax_npz
    from deepfluids_tpu_torch.ops import cuda_fd

    model = GeneratorBE((128, 96, 1), num_param=3, filters=128, num_conv=4,
                        compute_dtype=torch.bfloat16)
    load_flax_npz(weights, model)
    model.to(device)
    p = torch.zeros((512, 3), device=device)
    with torch.inference_mode():
        cuda_fd.curl2d_fused(model(p))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                cuda_fd.curl2d_fused(model(p))
            torch.cuda.synchronize()
    # Kernel rows only: operator rows repeat their kernels' device time.
    rows = sorted(((e.self_device_time_total / 3 / 1e3, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    total = sum(r[0] for r in rows)
    top = "; ".join(f"{name[:60]} {ms:.3f} ms" for ms, name in rows[:8])
    print(f"profile batch 512 fwd+curl: kernels {total:.3f} ms/iter of "
          f"{wall_ms:.3f} ms wall (idle share {1 - total / wall_ms:.3f}); "
          f"by kernel: {top}", flush=True)


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
        timing = phase_timing(device, serving["weights"], card)
        try:
            profile_generator(device, serving["weights"],
                              timing["gen_curl_ms"][512])
        except Exception as e:  # diagnostic only; the phases decide ok
            print(f"profile: not measured ({type(e).__name__}: {e})")
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax"))
    if leaked:
        raise AssertionError(f"the port imported jax: {leaked[:5]}")
    kern, plain, _ = timing["curl"][(512, torch.float32)]
    print(json.dumps({"kernels": [{
        "name": "curl2d_fused", "route": "cuda",
        "source": "deepfluids_tpu_torch/csrc/fd2d.cu",
        "replaces": "deepfluids_tpu/ops/pallas_fd.py:98",
        "launches": serving["launches"], "max_abs_err": worst,
        "ms": kern, "plain_ms": plain}]}))
    count = torch.cuda.device_count()
    if count != 1:
        raise AssertionError(f"{count} cards visible, the smoke uses one")
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": count}}))


if __name__ == "__main__":
    main()
