"""``csrc/fd2d.cu`` itself on the CPU, against the plain versions.

The 2D kernels use no shared memory, barriers or warp intrinsics, so each
thread computes alone: running every thread of a launch in turn is exact.
g++ compiles the source against small stand-ins for the CUDA headers
(below), with each ``kernel<<<grid, block, 0, s>>>(args)`` rewritten into
such a sequential launch, and the C entry points then run on CPU tensors.
This holds the kernels' own indexing, run widths, row tiles and edges to
``ops/fd.py`` bit for bit, at shapes the card's tests also take; the
card's compiler, alignment faults and speed are the card's tests' matter.
``tools/jacobian_tiles.cu``, which includes ``fd2d.cu`` and adds the
jacobians at every tile height and run width the tool times, is held the
same way.  Skips where there is no g++.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from deepfluids_tpu_torch.ops import _build, cuda_fd, fd

# Stand-ins for the CUDA runtime and bf16 headers: qualifiers vanish, the
# launch runs block after block and thread after thread.
CUDA_RUNTIME_H = r"""
#pragma once
#include <algorithm>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline dim3 blockIdx, threadIdx, blockDim, gridDim;
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
struct float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
using std::max;
using std::min;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline long long emu_launches = 0;
template <typename F, typename... A>
void emu_launch(dim3 g, dim3 b, int, cudaStream_t, F f, A... a) {
  if (b.x * b.y * b.z > 1024 || g.y > 65535 || g.z > 65535) throw 1;
  ++emu_launches;
  gridDim = g;
  blockDim = b;
  for (unsigned bz = 0; bz < g.z; ++bz)
    for (unsigned by = 0; by < g.y; ++by)
      for (unsigned bx = 0; bx < g.x; ++bx)
        for (unsigned ty = 0; ty < b.y; ++ty)
          for (unsigned tx = 0; tx < b.x; ++tx) {
            blockIdx = dim3(bx, by, bz);
            threadIdx = dim3(tx, ty, 0);
            f(a...);
          }
}
extern "C" long long emu_launch_count() { return emu_launches; }
"""

CUDA_BF16_H = r"""
#pragma once
#include "cuda_runtime.h"
struct __nv_bfloat16 { unsigned short v; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16 h) {
  return __uint_as_float((unsigned)h.v << 16);
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {  // round to nearest even
  unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(unsigned short)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(unsigned short)(u >> 16)};
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) { return h.v; }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
inline float2 __bfloat1622float2(__nv_bfloat162 h) {
  return {__bfloat162float(h.x), __bfloat162float(h.y)};
}
"""

ENTRIES = {  # entry -> (plain version, input channels, output channels)
    "df_curl2d": (fd.curl2d, [1], [2]),
    "df_curl2d_bwd": (fd.curl2d_bwd, [2], [1]),
    "df_jacobian2d": (fd.jacobian2d, [2], [4, 1]),
    "df_jacobian2d_bwd": (fd.jacobian2d_bwd, [4, 1], [2]),
}


LAUNCH = re.compile(r"([A-Za-z_]\w*<[^<>]*>)<<<([^>]*)>>>\(")


def _emulate(tmp_path_factory, source: str, stem: str) -> ctypes.CDLL:
    """``source`` (``fd2d.cu`` or a file that includes it) compiled by g++
    against the stand-ins, each launch rewritten into a sequential one."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' source for the CPU")
    work = tmp_path_factory.mktemp(f"{stem}_emu")
    (work / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (work / "cuda_bf16.h").write_text(CUDA_BF16_H)
    with open(os.path.join(_build.CSRC_DIR, "fd2d.cu")) as f:
        fd2d = f.read()
    # fd2d.cu's launches: the curls' 2 each (16-byte runs or one point),
    # the jacobians' 1 each (the run width a template parameter).
    assert len(LAUNCH.findall(fd2d)) == 6, "a launch the rewrite missed"
    (work / "fd2d.cu").write_text(LAUNCH.sub(r"emu_launch(\2, &\1, ", fd2d))
    with open(source) as f:
        (work / f"{stem}.cc").write_text(
            LAUNCH.sub(r"emu_launch(\2, &\1, ", f.read()))
    lib = work / f"lib{stem}_emu.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-w", "-I", str(work),
         "-I", _build.CSRC_DIR, "-o", str(lib), str(work / f"{stem}.cc")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    so = ctypes.CDLL(str(lib))
    so.emu_launch_count.argtypes = []
    so.emu_launch_count.restype = ctypes.c_longlong
    return so


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    so = _emulate(tmp_path_factory, os.path.join(_build.CSRC_DIR, "fd2d.cu"),
                  "fd2d")
    for name, (restype, argtypes) in _build._SIGNATURES.items():
        if name in ENTRIES:
            getattr(so, name).restype = restype
            getattr(so, name).argtypes = argtypes
    return so


def _run(so, entry, xs, out_channels):
    """``entry`` on ``xs`` (a None is a null pointer) into new outputs."""
    outs = [torch.empty(xs[0].shape[:-1] + (c,), dtype=xs[0].dtype)
            for c in out_channels]
    before = so.emu_launch_count()
    err = getattr(so, entry)(
        *(None if t is None else t.data_ptr() for t in xs + outs),
        *xs[0].shape[:-1], cuda_fd._DTYPE_CODES[xs[0].dtype], 0, None)
    assert err == 0
    assert so.emu_launch_count() == before + 1, "one launch a call"
    return outs


def _inputs(shape, channels, dtype, skip, seed):
    """Random inputs whose storage starts ``skip`` points past the
    allocation (64-byte aligned on the CPU): 0 keeps 16-byte runs
    possible, 1 rules them out."""
    rng = np.random.default_rng(seed)
    xs = []
    for c in channels:
        n = int(np.prod(shape)) * c
        buf = torch.from_numpy(rng.standard_normal(n + skip * c).astype(
            np.float32)).to(dtype)
        xs.append(buf[skip * c:].view(shape + (c,)))
    return xs


# Widths of no multiple of 4 or 8 (runs of one point: 37, 13, 97), odd
# heights (a ragged last row tile), a row wider than a block's threads and
# the smallest extents each kernel takes; for the transposes also a field
# large enough for their runs of several points in bf16 (0.5 M points; 1 M
# in f32).
SHAPES = [(2, 9, 37), (3, 7, 13), (2, 16, 12), (1, 5, 1100), (3, 5, 96),
          (2, 2, 8), (1, 3, 3), (2, 32, 24), (2, 6, 97)]
BWD_VECTOR_SHAPES = [(40, 130, 120)]


@pytest.mark.parametrize("skip", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_emulated_kernel_is_bit_equal_to_plain(emulated, entry, dtype,
                                               skip):
    plain, chans, outs = ENTRIES[entry]
    bwd = entry.endswith("_bwd")
    shapes = SHAPES + (BWD_VECTOR_SHAPES if bwd else [])
    for shape in shapes:
        if min(shape[1:]) < (3 if bwd else 2):
            continue
        xs = _inputs(shape, chans, dtype, skip, seed=sum(shape))
        got = _run(emulated, entry, xs, outs)
        want = cuda_fd._in_f32(plain, *xs)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert torch.equal(g, w), f"{entry} {shape} {dtype} skip {skip}"


def test_emulated_curl2d_bwd_takes_16_byte_runs_from_its_threshold(
        emulated):
    # 70 x 130 x 120 (1.09 M points) takes 16-byte runs in f32 too; the
    # odd height leaves its tiles of two rows ragged.  The jacobian's
    # transpose takes its runs of two points from the same threshold, with
    # the vorticity's cotangent and without it.
    xs = _inputs((70, 130, 120), [2], torch.float32, 0, seed=5)
    got = _run(emulated, "df_curl2d_bwd", xs, [1])[0]
    assert torch.equal(got, fd.curl2d_bwd(xs[0]))
    gj, gw = _inputs((70, 130, 120), [4, 1], torch.float32, 0, seed=6)
    got = _run(emulated, "df_jacobian2d_bwd", [gj, gw], [2])[0]
    assert torch.equal(got, fd.jacobian2d_bwd(gj, gw))
    got = _run(emulated, "df_jacobian2d_bwd", [gj, None], [2])[0]
    assert torch.equal(got, fd.jacobian2d_bwd(gj, torch.zeros_like(gw)))


@pytest.mark.parametrize("skip", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_jacobian2d_bwd_without_vort_is_the_zeros_path(
        emulated, dtype, skip):
    # A null vorticity cotangent: J's alone, equal to the plain version and
    # to the kernel given zeros (torch.equal takes -0.0 for 0.0).
    for shape in SHAPES:
        if min(shape[1:]) < 3:
            continue
        gj, = _inputs(shape, [4], dtype, skip, seed=sum(shape))
        zeros = torch.zeros(shape + (1,), dtype=dtype)
        got = _run(emulated, "df_jacobian2d_bwd", [gj, None], [2])[0]
        want = cuda_fd._in_f32(fd.jacobian2d_bwd, gj, zeros)
        assert torch.equal(got, want), f"{shape} {dtype} skip {skip}"
        assert torch.equal(got, _run(emulated, "df_jacobian2d_bwd",
                                     [gj, zeros], [2])[0])


# tools/jacobian_tiles.cu: fd2d.cu's jacobians at every tile height and
# run width the tool times (rows, march, points a run), marched, and one
# thread a point.
TILE_VARIANTS = {**{f"r{r}v{v}": (r, 0, v) for r in (1, 2, 4)
                    for v in (1, 2, 4, 8)},
                 **{f"march{r}v{v}": (r, 1, v) for r in (2, 4)
                    for v in (1, 4)},
                 "point": (0, 0, 1)}
TILE_KERNELS = {  # name -> (bwd, input channels, output channels)
    "jacobian2d": (0, [2], [4, 1]), "jacobian2d_bwd": (1, [4, 1], [2]),
    "jacobian2d_bwd_no_vort": (1, [4], [2])}


@pytest.fixture(scope="module")
def emulated_tiles(tmp_path_factory):
    so = _emulate(tmp_path_factory, os.path.join(
        os.path.dirname(_build.CSRC_DIR), "tools", "jacobian_tiles.cu"),
        "jacobian_tiles")
    so.tile_jacobian2d.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    so.tile_jacobian2d.restype = ctypes.c_int
    return so


@pytest.mark.parametrize("kernel,label,dtype", [
    (k, label, dt) for k in TILE_KERNELS for label in TILE_VARIANTS
    for dt in (torch.float32, torch.bfloat16)
    # a run holds at most 16 bytes of a channel
    if TILE_VARIANTS[label][2] * dt.itemsize <= 16])
def test_emulated_jacobian_tile_variants_are_bit_equal_to_plain(
        emulated_tiles, kernel, label, dtype):
    # Each tile height, marched or preloaded, at ragged widths and heights
    # (a tile of the field's last row alone, ragged last tiles, the row
    # below a tile read only after row H - 2) and unaligned storage.
    bwd, chans, outs = TILE_KERNELS[kernel]
    rows, march, vec = TILE_VARIANTS[label]
    for shape in [(2, 9, 37), (3, 7, 13), (2, 16, 12), (1, 5, 96),
                  (2, 6, 97), (1, 3, 3), (1, 10, 24), (2, 11, 16)]:
        for skip in (0, 1):
            xs = _inputs(shape, chans, dtype, skip, seed=sum(shape))
            if vec > 1 and (shape[2] % vec
                            or any(t.data_ptr() % 16 for t in xs)):
                continue
            w = xs[1] if len(xs) > 1 else None
            if rows == 0 and bwd and w is None:
                w = torch.zeros(shape + (1,), dtype=dtype)
            got = [torch.empty(shape + (c,), dtype=dtype) for c in outs]
            ptrs = [t.data_ptr() if t is not None else None
                    for t in [xs[0], w] + got + [None] * (2 - len(got))]
            err = emulated_tiles.tile_jacobian2d(
                *ptrs, *shape, cuda_fd._DTYPE_CODES[dtype], bwd, rows, march,
                vec, None)
            assert err == 0
            plain = fd.jacobian2d if not bwd else (
                fd.jacobian2d_bwd if len(xs) > 1 else lambda g: (
                    fd.jacobian2d_bwd(g, g.new_zeros(shape + (1,)))))
            want = cuda_fd._in_f32(plain, *xs)
            want = want if isinstance(want, tuple) else (want,)
            for g, wt in zip(got, want):
                assert torch.equal(g, wt), f"{shape} skip {skip}"
