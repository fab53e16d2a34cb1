"""The 2D jacobian's and its transpose's row-tile variants, timed on the card.

The measurements behind ``csrc/fd2d.cu``'s tile heights (``kJacRows``,
``kJacBwdRows``) and run widths (``kJacVec``, ``kJacBwdVec``, and runs of
one point below the transposes' ``kBwdVectorPointsPerByte``).  Builds
``jacobian_tiles.cu`` (fd2d.cu's jacobian kernels at other tile heights and
run widths, marched, and one thread a point, the design the row tiles
replaced) with nvcc, holds every variant bit-equal to the plain version,
then times each beside the port's own kernel and, at the first batch in
f32, the plain version under ``torch.compile``, as
:mod:`deepfluids_tpu_torch.tools.curl_tiles` does for the curls.  The
transpose is timed with the vorticity's cotangent and without it (the
training loss's call).  One record per kernel, batch and dtype, with the
registers ptxas gave each variant.

    python -m deepfluids_tpu_torch.tools.jacobian_tiles [--batches 512,8,1]
        [--out records.jsonl]

Needs the card.  Labels: ``kernel`` the port's kernel as its wrapper
launches it; ``r<R>v<V>`` tiles of R rows preloaded, runs of V points (at
most 16 bytes of a channel: 4 in f32, 8 in bf16); ``march<R>`` R rows,
each loaded one row ahead of the row stored, runs of 16 bytes of a
channel; ``point``
one thread a point (without the vorticity's cotangent it reads zeros,
filled each call as the training step filled them); ``compiled``
inductor.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import time

import torch

from deepfluids_tpu_torch.ops import cuda_fd, fd
from deepfluids_tpu_torch.tools import _record
from deepfluids_tpu_torch.tools.curl_tiles import (HBM_BYTES_PER_S,
                                                   RESOLUTION, RING_BYTES,
                                                   build_variants, device_ms)

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "jacobian_tiles.cu")
# label -> (rows, march, points a run): the variants jacobian_tiles.cu
# builds; rows 0 is one thread a point, and a run of 0 points is 16 bytes
# of a channel (4 points in f32, 8 in bf16).
VARIANTS = {**{f"r{r}v{v}": (r, 0, v) for r in (1, 2, 4)
               for v in (1, 2, 4, 8)},
            **{f"march{r}": (r, 1, 0) for r in (2, 4)},
            "point": (0, 0, 1)}
NO_VORT = "jacobian2d_bwd without vort"
# name -> (the port's call, the plain version, input channels, output
# channels)
KERNELS = {
    "jacobian2d_fused": (cuda_fd.jacobian2d_fused, fd.jacobian2d, [2],
                         [4, 1]),
    "jacobian2d_bwd": (cuda_fd.jacobian2d_bwd, fd.jacobian2d_bwd, [4, 1],
                       [2]),
    NO_VORT: (lambda gj: cuda_fd.jacobian2d_bwd(gj, None),
              lambda gj: fd.jacobian2d_bwd(gj, _zeros_w(gj)), [4], [2]),
}
# Ragged widths (97: no multiple of 4 or 8), odd heights, a tile of the
# field's last row alone, the smallest extents, and the training field.
CHECK_SHAPES = [(2, 9, 37), (3, 7, 13), (2, 16, 12), (4, 129, 96),
                (2, 6, 97), (1, 3, 3), (3, 128, 96)]


def _zeros_w(gj: torch.Tensor) -> torch.Tensor:
    return gj.new_zeros(gj.shape[:-1] + (1,))


def build() -> tuple[ctypes.CDLL, dict]:
    """``jacobian_tiles.cu``'s library and its kernels' registers."""
    so, regs = build_variants(SOURCE, "jacobian_tiles", "jacobian2d")
    so.tile_jacobian2d.argtypes = ([ctypes.c_void_p] * 4
                                   + [ctypes.c_longlong]
                                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    so.tile_jacobian2d.restype = ctypes.c_int
    return so, regs


def points(label: str, dtype) -> int:
    """The points of a run of variant ``label`` in ``dtype``."""
    vec = VARIANTS[label][2]
    return vec or 16 // (4 if dtype == torch.float32 else 2)


def variant(so: ctypes.CDLL, name: str, label: str):
    """The function that runs variant ``label`` of kernel ``name`` on its
    inputs and returns its outputs."""
    rows, march, _ = VARIANTS[label]
    bwd = name != "jacobian2d_fused"

    def run(*xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
        x = xs[0]
        gw = xs[1] if len(xs) > 1 else None
        if gw is None and rows == 0 and bwd:
            gw = _zeros_w(x)
        outs = [torch.empty(x.shape[:-1] + (c,), dtype=x.dtype,
                            device=x.device) for c in KERNELS[name][3]]
        ptrs = [t.data_ptr() if t is not None else None
                for t in [x, gw] + outs + [None] * (2 - len(outs))]
        err = so.tile_jacobian2d(
            *ptrs, *x.shape[:-1], cuda_fd._DTYPE_CODES[x.dtype], int(bwd),
            rows, march, points(label, x.dtype),
            torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"{name} {label}: cudaError {err}")
        return tuple(outs)
    return run


def takes(label: str, xs: list[torch.Tensor]) -> bool:
    """Whether variant ``label`` can run on ``xs``: a run of several points
    holds at most 16 bytes of a channel and needs W a multiple of it and
    16-byte aligned storage."""
    x, v = xs[0], points(label, xs[0].dtype)
    return VARIANTS[label][0] == 0 or v == 1 or (
        v * x.element_size() <= 16 and x.shape[2] % v == 0
        and all(t.data_ptr() % 16 == 0 for t in xs))


def registers(regs: dict, name: str, label: str, dtype) -> int | None:
    """The registers ptxas gave variant ``label`` of kernel ``name`` in
    ``dtype`` (None where its instance is not in the build log)."""
    rows, march, _ = VARIANTS[label]
    t = "float" if dtype == torch.float32 else "__nv_bfloat16"
    kern = "jacobian2d" + ("_bwd" if name != "jacobian2d_fused" else "")
    if rows == 0:
        return next((r for k, r in regs.items()
                     if f"::{kern}_point_kernel<{t}>" in k), None)
    args = f"{t}, {points(label, dtype)}, {rows}"
    if name != "jacobian2d_fused":
        args += ", " + ("false" if name == NO_VORT else "true")
    kern += "_march" if march else ""
    return next((r for k, r in regs.items()
                 if f"::{kern}_kernel<{args}>" in k), None)


def inputs(name: str, shape: tuple, dtype, gen: torch.Generator,
           device: torch.device, skip: int = 0) -> list[torch.Tensor]:
    """Random inputs of ``name`` at ``shape``, each starting ``skip``
    points past an aligned address (a view into a larger buffer)."""
    xs = []
    for c in KERNELS[name][2]:
        n = math.prod(shape) * c
        buf = torch.randn(n + skip * c, generator=gen, device=device)
        xs.append(buf.to(dtype)[skip * c:].view(shape + (c,)))
    return xs


def check(so: ctypes.CDLL, device: torch.device) -> int:
    """Every variant bit-equal to the plain version (f32 math, rounded
    once) at ragged, odd and unaligned shapes; the calls checked."""
    gen = torch.Generator(device=device).manual_seed(0)
    n = 0
    for name, (kern, plain, _, _) in KERNELS.items():
        for dtype in (torch.float32, torch.bfloat16):
            for shape in CHECK_SHAPES:
                for skip in (0, 1):
                    xs = inputs(name, shape, dtype, gen, device, skip)
                    want = cuda_fd._in_f32(plain, *xs)
                    want = want if isinstance(want, tuple) else (want,)
                    runs = {"kernel": kern}
                    runs.update({label: variant(so, name, label)
                                 for label in VARIANTS if takes(label, xs)})
                    for label, fn in runs.items():
                        got = fn(*xs)
                        got = got if isinstance(got, tuple) else (got,)
                        torch.cuda.synchronize(device)
                        if not all(torch.equal(g, w)
                                   for g, w in zip(got, want)):
                            raise AssertionError(
                                f"{name} {label} {shape} {dtype} skip "
                                f"{skip}: not the plain version's result")
                        n += 1
    return n


def time_kernel(so, regs, name: str, batch: int, dtype, compiled: bool,
                device: torch.device) -> dict:
    """One record: each label's device ms (both turns) at
    ``[batch, *RESOLUTION]`` in ``dtype``, beside the bound."""
    kern, plain, cin, cout = KERNELS[name]
    shape = (batch,) + RESOLUTION
    elt = 4 if dtype == torch.float32 else 2
    gen = torch.Generator(device=device).manual_seed(batch)
    n = max(2, -(-RING_BYTES // (math.prod(shape) * sum(cin) * elt)))
    ring = [inputs(name, shape, dtype, gen, device) for _ in range(n)]
    fns = {"kernel": kern}
    fns.update({label: variant(so, name, label) for label in VARIANTS
                if takes(label, ring[0])})
    if compiled:
        fns["compiled"] = torch.compile(
            lambda *xs: cuda_fd._in_f32(plain, *xs), dynamic=False)
    turn = [0]

    def ringed(f):
        def call():
            f(*ring[turn[0] % n])
            turn[0] += 1
        return call

    bound = (math.prod(shape) * (sum(cin) + sum(cout)) * elt
             / HBM_BYTES_PER_S * 1e3)
    runs = {label: [] for label in fns}
    with torch.inference_mode():
        if compiled:
            # chip_smoke.py's bars for a kernel against its plain version.
            got, want = (f(*ring[0]) for f in (
                fns["compiled"], lambda *xs: cuda_fd._in_f32(plain, *xs)))
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            if not err <= (1e-6 if name == "jacobian2d_fused" else 1e-5):
                raise AssertionError(f"torch.compile of {name}'s plain "
                                     f"version is {err} from it")
        for label in list(fns) + list(fns)[::-1]:
            runs[label].append(device_ms(ringed(fns[label]), bound))
    return {"tool": "jacobian_tiles", "kernel": name, "shape": list(shape),
            "dtype": str(dtype).replace("torch.", ""), "bound_ms": bound,
            "ms": {k: min(v) for k, v in runs.items()}, "runs_ms": runs,
            "registers": {label: registers(regs, name, label, dtype)
                          for label in VARIANTS if takes(label, ring[0])}}


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(
        description="time the 2D jacobians' row-tile variants on the card")
    ap.add_argument("--batches", default="512,256,128,64,32,16,8,1",
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
    print(f"jacobian_tiles: {len(VARIANTS)} variants built and held "
          f"bit-equal to the plain version in {checked} calls "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    records = []
    for name in KERNELS:
        for b in batches:
            for dtype in (torch.float32, torch.bfloat16):
                rec = time_kernel(so, regs, name, b, dtype,
                                  b == batches[0] and dtype == torch.float32,
                                  device)
                best = sorted(rec["ms"].items(), key=lambda kv: kv[1])
                print(f"jacobian_tiles {name} [{b},128,96] {rec['dtype']}: "
                      f"bound {rec['bound_ms']:.4f} ms; " + ", ".join(
                          f"{k} {v:.4f}" for k, v in best), flush=True)
                records.append(_record.write(rec, device, a.out))
    return records


if __name__ == "__main__":
    main()
