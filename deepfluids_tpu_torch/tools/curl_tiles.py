"""The 2D curls' row-tile variants, timed on the card.

The measurements behind ``csrc/fd2d.cu``'s tile heights (``kCurlRows``,
``kCurlBwdRows``) and its choice between 16-byte runs and runs of one point
(``kBwdVectorPointsPerByte``).  Builds ``curl_tiles.cu`` (fd2d.cu's curl
kernels at other tile heights and run widths, and as a rolling march) with
nvcc, holds every variant bit-equal to the plain version, then times each
beside the port's own kernel and, at the first batch in f32, the plain
version under ``torch.compile``: device time from the profiler's kernel
rows, in turns (first label to last and back), inputs cold (a ring of input
sets of at least 256 MB).  One record per kernel, batch and dtype, with the
registers ptxas gave each variant.

    python -m deepfluids_tpu_torch.tools.curl_tiles [--batches 512,8,1]

Needs the card.  Labels: ``kernel`` the port's kernel as its wrapper
launches it; ``tile<R>`` R rows preloaded, 16-byte runs; ``march<R>d<D>``
R rows, each loaded D rows ahead of the row stored, 16-byte runs;
``one<R>`` R rows preloaded, runs of one point; ``compiled`` inductor.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import math
import os
import re
import subprocess
import time

import torch

from deepfluids_tpu_torch.ops import _build, cuda_fd, fd
from deepfluids_tpu_torch.tools import _record

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "curl_tiles.cu")
# label -> (rows, dist, vec): the variants curl_tiles.cu builds.
VARIANTS = {**{f"tile{r}": (r, 0, 1) for r in (1, 2, 4, 8, 16)},
            **{f"march{r}d{d}": (r, d, 1) for r, d in (
                (8, 1), (16, 1), (8, 2), (16, 2), (32, 2), (16, 4),
                (32, 4))},
            "one1": (1, 0, 0), "one2": (2, 0, 0)}
KERNELS = {"curl2d_fused": (cuda_fd.curl2d_fused, fd.curl2d, 1, 2),
           "curl2d_bwd": (cuda_fd.curl2d_bwd, fd.curl2d_bwd, 2, 1)}
RESOLUTION = (128, 96)          # the 2D configurations' fields
CHECK_SHAPES = [(2, 9, 37), (3, 7, 13), (2, 16, 12), (4, 129, 96)]
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA's data sheet
RING_BYTES = 256 << 20          # more than the 50 MB L2 holds
SENTINEL_KERNEL = "spin_kernel"   # torch.cuda._sleep's, opens each window


def build_variants(source: str, stem: str,
                   match: str) -> tuple[ctypes.CDLL, dict]:
    """The variants' library built from ``source`` (which includes
    ``csrc/fd2d.cu``; once per source hash, into the port's ``_build/``) and
    the registers ptxas gave each kernel instance whose name holds
    ``match``, by demangled name."""
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for path in (source, os.path.join(_build.CSRC_DIR, "fd2d.cu"),
                 os.path.join(_build.CSRC_DIR, "fd_common.cuh")):
        with open(path, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(_build.BUILD_ROOT,
                           f"{stem}-" + h.hexdigest()[:16])
    lib, log = (os.path.join(out_dir, n) for n in (f"lib{stem}.so",
                                                   "build.log"))
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        proc = subprocess.run(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
             "-shared", "-o", lib + ".tmp", source],
            capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
        with open(log, "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(lib + ".tmp", lib)
    with open(log) as f:
        text = f.read()
    regs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name and match in name:
            regs[name] = int(m.group(1))
    demangled = subprocess.run(["c++filt"], input="\n".join(regs),
                               capture_output=True, text=True).stdout
    return ctypes.CDLL(lib), dict(zip(demangled.splitlines(), regs.values()))


def build() -> tuple[ctypes.CDLL, dict]:
    """``curl_tiles.cu``'s library and its kernels' registers
    (:func:`build_variants`)."""
    so, regs = build_variants(SOURCE, "curl_tiles", "curl2d")
    so.tile_curl2d.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                               + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    so.tile_curl2d.restype = ctypes.c_int
    return so, regs


def variant(so: ctypes.CDLL, name: str, label: str):
    """The function that runs variant ``label`` of kernel ``name``."""
    rows, dist, vec = VARIANTS[label]
    bwd = name == "curl2d_bwd"
    out_c = KERNELS[name][3]

    def run(x: torch.Tensor) -> torch.Tensor:
        out = torch.empty(x.shape[:-1] + (out_c,), dtype=x.dtype,
                          device=x.device)
        err = so.tile_curl2d(x.data_ptr(), out.data_ptr(), *x.shape[:-1],
                             cuda_fd._DTYPE_CODES[x.dtype], int(bwd), rows,
                             dist, vec,
                             torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"{name} {label}: cudaError {err}")
        return out
    return run


def takes(label: str, x: torch.Tensor) -> bool:
    """Whether variant ``label`` can run on ``x``: 16-byte runs need W a
    multiple of them and 16-byte aligned storage."""
    return not VARIANTS[label][2] or (
        x.shape[2] % (16 // x.element_size()) == 0
        and x.data_ptr() % 16 == 0)


def registers(regs: dict, name: str, label: str, dtype) -> int | None:
    """The registers ptxas gave variant ``label`` of kernel ``name`` in
    ``dtype`` (None where its instance is not in the build log)."""
    rows, dist, vec = VARIANTS[label]
    t = "float" if dtype == torch.float32 else "__nv_bfloat16"
    v = 16 // (4 if dtype == torch.float32 else 2) if vec else 1
    kern = name.replace("_fused", "") + ("_march" if dist else "")
    args = f"{t}, {v}, {rows}" + (f", {dist}" if dist else "")
    return next((r for k, r in regs.items()
                 if f"::{kern}_kernel<{args}>" in k), None)


def check(so: ctypes.CDLL, device: torch.device) -> int:
    """Every variant bit-equal to the plain version (f32 math, rounded
    once) at ragged and odd shapes; the number of calls checked."""
    gen = torch.Generator(device=device).manual_seed(0)
    n = 0
    for name, (_, plain, cin, _) in KERNELS.items():
        for dtype in (torch.float32, torch.bfloat16):
            for shape in CHECK_SHAPES:
                x = torch.randn(shape + (cin,), generator=gen,
                                device=device).to(dtype)
                want = cuda_fd._in_f32(plain, x)
                for label in VARIANTS:
                    if not takes(label, x):
                        continue
                    got = variant(so, name, label)(x)
                    torch.cuda.synchronize(device)
                    if not torch.equal(got, want):
                        raise AssertionError(f"{name} {label} {shape} "
                                             f"{dtype}: not the plain "
                                             f"version's result")
                    n += 1
    return n


def device_ms(fn, bound_ms: float, iters: int = 20) -> float:
    """Device ms of one call of ``fn``: the profiler's kernel rows of
    ``iters`` calls, in a window opened by a sentinel kernel (a window can
    lose its first record); measured again where a row lost records or the
    window reads less than ``bound_ms``: every call is handed the same
    output block, and a window where the L2 kept part of it read 0.78 of
    the bound (one of 1 024)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [ev for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA
                and SENTINEL_KERNEL not in ev.key]
        ms = sum(ev.self_device_time_total for ev in rows) / iters / 1e3
        if rows and all(ev.count % iters == 0 for ev in rows) and (
                ms >= bound_ms):
            return ms
    raise RuntimeError(f"five windows lost kernel records or read less "
                       f"than the bound {bound_ms} ms: {ms} ms, "
                       f"{[(ev.key[:40], ev.count) for ev in rows]}")


def time_kernel(so, regs, name: str, batch: int, dtype, compiled: bool,
                device: torch.device) -> dict:
    """One record: each label's device ms (both turns) at
    ``[batch, *RESOLUTION]`` in ``dtype``, beside the bound."""
    kern, plain, cin, cout = KERNELS[name]
    shape = (batch,) + RESOLUTION
    elt = 4 if dtype == torch.float32 else 2
    gen = torch.Generator(device=device).manual_seed(batch)
    n = max(2, -(-RING_BYTES // (math.prod(shape) * cin * elt)))
    ring = [torch.randn(shape + (cin,), generator=gen, device=device).to(
        dtype) for _ in range(n)]
    fns = {"kernel": kern}
    fns.update({label: variant(so, name, label) for label in VARIANTS
                if takes(label, ring[0])})
    if compiled:
        fns["compiled"] = torch.compile(
            lambda x: cuda_fd._in_f32(plain, x), dynamic=False)
    turn = [0]

    def ringed(f):
        def call():
            f(ring[turn[0] % n])
            turn[0] += 1
        return call

    bound = math.prod(shape) * (cin + cout) * elt / HBM_BYTES_PER_S * 1e3
    runs = {label: [] for label in fns}
    with torch.inference_mode():
        if compiled:
            # chip_smoke.py's bars for a kernel against its plain version.
            err = float((fns["compiled"](ring[0]) - cuda_fd._in_f32(
                plain, ring[0])).abs().max())
            if not err <= (1e-5 if name == "curl2d_bwd" else 1e-6):
                raise AssertionError(f"torch.compile of {name}'s plain "
                                     f"version is {err} from it")
        for label in list(fns) + list(fns)[::-1]:
            runs[label].append(device_ms(ringed(fns[label]), bound))
    return {"tool": "curl_tiles", "kernel": name, "shape": list(shape),
            "dtype": str(dtype).replace("torch.", ""), "bound_ms": bound,
            "ms": {k: min(v) for k, v in runs.items()}, "runs_ms": runs,
            "registers": {label: registers(regs, name, label, dtype)
                          for label in VARIANTS}}


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(
        description="time the 2D curls' row-tile variants on the card")
    ap.add_argument("--batches", default="512,128,64,32,16,8,4,1",
                    help="comma-separated batches of 128x96 fields; the "
                         "first also times the compiled plain version")
    ap.add_argument("--out", default=_record.DEFAULT_OUT,
                    help="the .jsonl file the records are appended to")
    a = ap.parse_args(argv)
    device = _record.resolve_device(None)
    batches = [int(b) for b in a.batches.split(",")]
    t0 = time.perf_counter()
    so, regs = build()
    checked = check(so, device)
    print(f"curl_tiles: {len(VARIANTS)} variants built and held bit-equal "
          f"to the plain version in {checked} calls "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    records = []
    for name in KERNELS:
        for b in batches:
            for dtype in (torch.float32, torch.bfloat16):
                rec = time_kernel(so, regs, name, b, dtype,
                                  b == batches[0] and dtype == torch.float32,
                                  device)
                best = sorted(rec["ms"].items(), key=lambda kv: kv[1])
                print(f"curl_tiles {name} [{b},128,96] {rec['dtype']}: "
                      f"bound {rec['bound_ms']:.4f} ms; " + ", ".join(
                          f"{k} {v:.4f}" for k, v in best), flush=True)
                records.append(_record.write(rec, device, a.out))
    return records


if __name__ == "__main__":
    main()
