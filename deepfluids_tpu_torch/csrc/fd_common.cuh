// Device helpers shared by the finite-difference kernels (fd2d.cu, fd3d.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store1(float* p, long long i, float a) {
  p[i] = a;
}
__device__ __forceinline__ void store1(__nv_bfloat16* p, long long i,
                                       float a) {
  p[i] = __float2bfloat16_rn(a);
}

// Transpose of the edge-replicated forward difference at index j of an
// extent n >= 3, from the cotangent at j-1, j and j+1 (pallas_fd.py:292-295):
//   x[0] = -d[0];  x[j] = d[j-1] - d[j];
//   x[n-2] = d[n-3] - d[n-2] - d[n-1];  x[n-1] = d[n-2] + d[n-1].
// The operations run in the order of ops/fd.py fdt, so f32 results match it
// bit for bit.
__device__ __forceinline__ float fdt(float dm, float d0, float dp, int j,
                                     int n) {
  if (j == 0) return -d0;
  if (j == n - 1) return dm + d0;
  if (j == n - 2) return dm - d0 - dp;
  return dm - d0;
}

// fdt, the same operations, with every case computed and one selected: no
// branch where neighbouring threads lie on different edges.  dp is read at
// j = n - 2 only, dm nowhere at j = 0.
__device__ __forceinline__ float fdt_sel(float dm, float d0, float dp, int j,
                                         int n) {
  const float mid = dm - d0;
  float r = j == n - 2 ? mid - dp : mid;
  r = j == n - 1 ? dm + d0 : r;
  return j == 0 ? -d0 : r;
}

}  // namespace
