"""Benchmark suite of the port: one timed surface per invocation.

Counterpart of the JAX package's ``tools/bench_suite.py``, the same seven
surfaces at the same shapes through the port's modules:

    python -m deepfluids_tpu_torch.tools.bench_suite <name> [--iters N]
        [--device cpu] [--out file.jsonl]

  infer2d    generator inference, 128x96, 16 chunks x 512, bf16, curl applied
  infer3d    3D generator inference, 32x64x112 vector potential + curl3,
             4 chunks x 32
  train2d    full-size 2D train step (curl + jacobian loss, Adam), batch 8,
             16 steps a call
  train3d    full-size 3D train step (config #5 geometry), batch 4, 4 steps
             a call
  rollout    latent integrator rollout, T 200, batch 100, z_num 16, MLP 512x2
  rollout_decode  rollout (batch 5) + a field decode and its curl every step
  e2e_sweep2d  the full 21x5x200 sweep INCLUDING npz/png/gif artifact writes
  all        each of the seven in turn

A call is timed on the host's clock between two ``torch.cuda.synchronize()``
after warm-up calls; the serving surfaces run under ``inference_mode`` and
every surface loops in Python (one call = its chunks or steps in turn).
Each record holds the rate (``value``), the seconds of every timed call
(``seconds_per_call``: the spread a bound must allow for), the FD kernels
one call launched (``launches``, the delta of ``cuda_fd.launch_counts``),
and ``tflops_per_sec`` counted by ``torch.utils.flop_counter`` (convolutions
and matmuls only: the FD stencils and the optimizer's elementwise work are
not in it).  It states no share of a peak.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from deepfluids_tpu_torch.tools import _record

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, device: torch.device, iters: int = 5,
           warmup: int = 2) -> tuple[list[float], dict]:
    """(seconds of each of ``iters`` calls of ``fn`` after ``warmup``
    untimed ones, the FD kernels one call launched)."""
    from deepfluids_tpu_torch.ops import cuda_fd

    for _ in range(warmup):
        fn()
    _sync(device)
    before = dict(cuda_fd.launch_counts)
    secs = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        secs.append(time.perf_counter() - t0)
    total = {k: v - before[k] for k, v in cuda_fd.launch_counts.items()}
    if any(v % iters for v in total.values()):
        raise AssertionError(f"{iters} equal calls launched {total}: not a "
                             "whole number a call")
    return secs, {k: v // iters for k, v in total.items() if v}


def _flops(fn) -> float | None:
    """Convolution and matmul flops of one call of ``fn`` (forward and, in a
    train step, backward), None where nothing was counted."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    total = float(counter.get_total_flops())
    return total if total > 0 else None


def _record_of(metric: str, units: float, secs: list[float], launches: dict,
               detail: str, flops: float | None = None) -> dict:
    """The record of a surface that did ``units`` of work a call."""
    dt = float(np.mean(secs))
    rec = {"metric": metric, "value": round(units / dt, 1), "detail": detail,
           "seconds_per_call": [round(s, 6) for s in secs],
           "value_min": round(units / max(secs), 1),
           "value_max": round(units / min(secs), 1),
           "launches": launches}
    if flops:
        rec["tflops_per_sec"] = round(flops / dt / 1e12, 3)
        rec["flops_counted"] = "convolutions and matmuls"
    return rec


def _generator(out_shape, num_param, filters, num_conv, dtype, device,
               seed=0):
    from deepfluids_tpu_torch.models import GeneratorBE, flax_init_

    model = GeneratorBE(out_shape, num_param=num_param, filters=filters,
                        num_conv=num_conv, compute_dtype=_DTYPES[dtype])
    return flax_init_(model, seed).to(device)


def _bench_infer(metric, res, potential, device, filters, num_conv, chunks,
                 batch, dtype, iters, warmup, detail):
    from deepfluids_tpu_torch.train.losses import apply_curl

    model = _generator(tuple(res) + (potential,), 3, filters, num_conv,
                       dtype, device)
    p = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (chunks, batch, 3)).astype(np.float32)).to(device)

    def call():
        with torch.inference_mode():
            for chunk in p:
                apply_curl(model(chunk))

    secs, launches = timeit(call, device, iters, warmup)
    return _record_of(metric, chunks * batch, secs, launches, detail,
                      _flops(call))


def bench_infer2d(device, res=(128, 96), filters=128, num_conv=4, chunks=16,
                  batch=512, dtype="bfloat16", iters=5, warmup=2) -> dict:
    return _bench_infer(
        "2d_fields_per_sec", res, 1, device, filters, num_conv, chunks,
        batch, dtype, iters, warmup,
        f"{res[0]}x{res[1]} sweep {chunks}x{batch}, {dtype}, curl applied")


def bench_infer3d(device, res=(32, 64, 112), filters=128, num_conv=4,
                  chunks=4, batch=32, dtype="bfloat16", iters=3,
                  warmup=2) -> dict:
    return _bench_infer(
        "3d_fields_per_sec", res, 3, device, filters, num_conv, chunks,
        batch, dtype, iters, warmup,
        f"{'x'.join(map(str, res))} vector potential + curl3, "
        f"{chunks}x{batch}, {dtype}")


def _bench_train(metric, res, potential, device, filters, num_conv, batch,
                 steps, dtype, iters, warmup, detail):
    """``steps`` train steps a call on synthetic batches that lie on the
    device: generator, curl + jacobian loss (w1 = w2 = 1), Adam under the
    cosine schedule, as ``Trainer._train_step`` runs them."""
    from deepfluids_tpu_torch.train.losses import generator_loss
    from deepfluids_tpu_torch.train.state import (
        cosine_lr_schedule,
        make_optimizer,
        set_lr,
    )

    model = _generator(tuple(res) + (potential,), 3, filters, num_conv,
                       dtype, device)
    opt = make_optimizer(model.parameters())
    lr_fn = cosine_lr_schedule(1e-4, 1e-5, 1000)
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.normal(
        size=(steps, batch) + tuple(res) + (len(res),)).astype(
            np.float32)).to(device)
    ys = torch.from_numpy(rng.normal(size=(steps, batch, 3)).astype(
        np.float32)).to(device)
    done = [0]

    def call():
        for x, y in zip(xs, ys):
            set_lr(opt, lr_fn(done[0]))
            opt.zero_grad(set_to_none=True)
            loss, _ = generator_loss(model(y), x, True, 1.0, 1.0)
            loss.backward()
            opt.step()
            done[0] += 1

    secs, launches = timeit(call, device, iters, warmup)
    return _record_of(metric, steps, secs, launches, detail, _flops(call))


def bench_train2d(device, res=(128, 96), filters=128, num_conv=4, batch=8,
                  steps=16, dtype="bfloat16", iters=10, warmup=2) -> dict:
    return _bench_train(
        "2d_train_steps_per_sec", res, 1, device, filters, num_conv, batch,
        steps, dtype, iters, warmup,
        f"{res[0]}x{res[1]} batch {batch}, curl+jacobian loss, Adam, "
        f"{steps} steps a call (synthetic batches), {dtype}")


def bench_train3d(device, res=(32, 64, 112), filters=128, num_conv=4,
                  batch=4, steps=4, dtype="bfloat16", iters=5,
                  warmup=1) -> dict:
    return _bench_train(
        "3d_train_steps_per_sec", res, 3, device, filters, num_conv, batch,
        steps, dtype, iters, warmup,
        f"{'x'.join(map(str, res))} batch {batch}, curl3+jacobian3 loss, "
        f"Adam, {steps} steps a call (synthetic batches), {dtype}")


def _integrator(z_num, num_param, hidden, depth, device, seed=0):
    from deepfluids_tpu_torch.models import LatentIntegrator, flax_init_

    model = LatentIntegrator(z_num=z_num, num_param=num_param, hidden=hidden,
                             depth=depth)
    return flax_init_(model, seed).to(device)


def _rollout_inputs(frames, batch, z_num, num_param, device):
    p_seq = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (frames, batch, num_param)).astype(np.float32)).to(device)
    z0 = torch.cat([p_seq[0], torch.zeros(batch, z_num - num_param,
                                          device=device)], dim=-1)
    return z0, p_seq


def bench_rollout(device, frames=200, batch=100, z_num=16, num_param=2,
                  hidden=512, depth=2, iters=5, warmup=2) -> dict:
    from deepfluids_tpu_torch.models import rollout

    model = _integrator(z_num, num_param, hidden, depth, device)
    z0, p_seq = _rollout_inputs(frames, batch, z_num, num_param, device)

    def call():
        with torch.inference_mode():
            rollout(model, z0, p_seq, num_param)

    secs, launches = timeit(call, device, iters, warmup)
    return _record_of(
        "rollout_steps_per_sec", (frames - 1) * batch, secs, launches,
        f"T={frames} x batch {batch}, z_num={z_num}, MLP {hidden}x{depth}",
        _flops(call))


def bench_rollout_decode(device, frames=200, batch=5, z_num=16, num_param=2,
                         hidden=512, depth=2, res=(128, 96), filters=128,
                         num_conv=4, dtype="bfloat16", iters=3,
                         warmup=2) -> dict:
    from deepfluids_tpu_torch.models import rollout
    from deepfluids_tpu_torch.train.losses import apply_curl

    model = _integrator(z_num, num_param, hidden, depth, device)
    dec = _generator(tuple(res) + (1,), z_num, filters, num_conv, dtype,
                     device, seed=1)
    z0, p_seq = _rollout_inputs(frames, batch, z_num, num_param, device)

    def call():
        with torch.inference_mode():
            traj = rollout(model, z0, p_seq, num_param)     # [T, B, Z]
            for z in traj:
                apply_curl(dec(z))

    secs, launches = timeit(call, device, iters, warmup)
    return _record_of(
        "rollout_decode_steps_per_sec", (frames - 1) * batch, secs, launches,
        f"T={frames} x batch {batch}: integrate + decode {res[0]}x{res[1]} "
        f"+ curl, {dtype}", _flops(call))


def bench_e2e_sweep2d(device, res=(128, 96), filters=128, num_conv=4,
                      counts=(21, 5), num_frames=200, batch=128,
                      dtype="bfloat16", iters=1, warmup=1) -> dict:
    """END-TO-END sweep: the full 21x5x200 test grid INCLUDING .npz
    compression, PNG renders and GIF assembly, warmed outside the timed
    region by one batch of the generator."""
    from deepfluids_tpu_torch.data import Manifest
    from deepfluids_tpu_torch.infer import run_test_sweep, sweep_generator
    from deepfluids_tpu_torch.ops import cuda_fd
    from deepfluids_tpu_torch.train.losses import apply_curl

    m = Manifest(param_names=["src_x_pos", "src_radius", "frame"],
                 param_ranges=[[0.2, 0.8], [0.04, 0.12],
                               [0.0, float(num_frames - 1)]],
                 num_scenes=counts[0] * counts[1], num_frames=num_frames,
                 resolution=list(res), num_channels=2, v_range=[-5, 5],
                 param_counts=list(counts))
    model = _generator(tuple(res) + (1,), 3, filters, num_conv, dtype,
                       device)

    def apply_fn(p):
        return apply_curl(model(p))

    for _ in range(warmup):
        next(sweep_generator(apply_fn, m, np.zeros((batch, 3), np.float32),
                             batch, device=device))
    secs, fields = [], 0
    before = dict(cuda_fd.launch_counts)
    for _ in range(iters):
        with tempfile.TemporaryDirectory() as td:
            _sync(device)
            t0 = time.perf_counter()
            swept = run_test_sweep(apply_fn, m, td, counts=counts,
                                   batch_size=batch, save_png_every=20,
                                   device=device)
            _sync(device)
            secs.append(time.perf_counter() - t0)
            fields = swept["num_fields"]
    launches = {k: (v - before[k]) // iters
                for k, v in cuda_fd.launch_counts.items() if v - before[k]}
    return _record_of(
        "e2e_sweep_fields_per_sec", fields, secs, launches,
        f"{counts[0]}x{counts[1]}x{num_frames} grid at batch {batch} incl. "
        f"npz+png+gif artifact writes, {dtype}")


BENCHES = {
    "infer2d": bench_infer2d,
    "infer3d": bench_infer3d,
    "train2d": bench_train2d,
    "train3d": bench_train3d,
    "rollout": bench_rollout,
    "rollout_decode": bench_rollout_decode,
    "e2e_sweep2d": bench_e2e_sweep2d,
}


def run(name: str, device=None, out: str | None = None, **kw) -> dict:
    """Surface ``name`` on ``device`` (None: the card); the stamped record,
    printed and appended to ``out`` (None: printed only)."""
    device = _record.resolve_device(device)
    rec = BENCHES[name](device, **kw)
    rec["surface"] = name
    return _record.write(rec, device, out)


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(
        description="One timed surface of the port per invocation")
    ap.add_argument("name", choices=sorted(BENCHES) + ["all"])
    ap.add_argument("--iters", type=int, default=None,
                    help="timed calls (default: the surface's own)")
    _record.add_arguments(ap)
    a = ap.parse_args(argv)
    kw = {} if a.iters is None else {"iters": a.iters}
    names = list(BENCHES) if a.name == "all" else [a.name]
    return [run(n, a.device, a.out, **kw) for n in names]


if __name__ == "__main__":
    main()
