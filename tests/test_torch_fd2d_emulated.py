"""``csrc/fd2d.cu`` itself on the CPU, against the plain versions.

The 2D kernels use no shared memory, barriers or warp intrinsics, so each
thread computes alone: running every thread of a launch in turn is exact.
g++ compiles the source against small stand-ins for the CUDA headers
(below), with each ``kernel<<<grid, block, 0, s>>>(args)`` rewritten into
such a sequential launch, and the C entry points then run on CPU tensors.
This holds the kernels' own indexing, run widths, row tiles and edges to
``ops/fd.py`` bit for bit, at shapes the card's tests also take; the
card's compiler, alignment faults and speed are the card's tests' matter.
Skips where there is no g++.
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


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' source for the CPU")
    work = tmp_path_factory.mktemp("fd2d_emu")
    (work / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (work / "cuda_bf16.h").write_text(CUDA_BF16_H)
    with open(os.path.join(_build.CSRC_DIR, "fd2d.cu")) as f:
        src = f.read()
    launches = re.compile(r"([A-Za-z_]\w*<[^<>]*>)<<<([^>]*)>>>\(")
    assert len(launches.findall(src)) == 8, "a launch the rewrite missed"
    (work / "fd2d.cc").write_text(
        launches.sub(r"emu_launch(\2, &\1, ", src))
    lib = work / "libfd2d_emu.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-w", "-I", str(work),
         "-I", _build.CSRC_DIR, "-o", str(lib), str(work / "fd2d.cc")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    so = ctypes.CDLL(str(lib))
    for name, (restype, argtypes) in _build._SIGNATURES.items():
        if name in ENTRIES:
            getattr(so, name).restype = restype
            getattr(so, name).argtypes = argtypes
    so.emu_launch_count.argtypes = []
    so.emu_launch_count.restype = ctypes.c_longlong
    return so


def _run(so, entry, xs, out_channels):
    outs = [torch.empty(xs[0].shape[:-1] + (c,), dtype=xs[0].dtype)
            for c in out_channels]
    before = so.emu_launch_count()
    err = getattr(so, entry)(
        *(t.data_ptr() for t in xs + outs), *xs[0].shape[:-1],
        cuda_fd._DTYPE_CODES[xs[0].dtype], 0, None)
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


# Widths of no multiple of 4 or 8 (runs of one point), odd heights (a
# ragged last row tile), a row wider than a block's threads and the
# smallest extents each kernel takes; for curl2d_bwd also a field large
# enough for its 16-byte runs in bf16 (0.5 M points; 1 M in f32).
SHAPES = [(2, 9, 37), (3, 7, 13), (2, 16, 12), (1, 5, 1100), (3, 5, 96),
          (2, 2, 8), (1, 3, 3), (2, 32, 24)]
BWD_VECTOR_SHAPES = [(40, 130, 120)]


@pytest.mark.parametrize("skip", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_emulated_kernel_is_bit_equal_to_plain(emulated, entry, dtype,
                                               skip):
    plain, chans, outs = ENTRIES[entry]
    bwd = entry.endswith("_bwd")
    shapes = SHAPES + (BWD_VECTOR_SHAPES if entry == "df_curl2d_bwd"
                       else [])
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
    # odd height leaves its tiles of two rows ragged.
    xs = _inputs((70, 130, 120), [2], torch.float32, 0, seed=5)
    got = _run(emulated, "df_curl2d_bwd", xs, [1])[0]
    assert torch.equal(got, fd.curl2d_bwd(xs[0]))
