// 2D curl of a stream function, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel curl2d_fused / _curl2d_kernel in
// deepfluids_tpu/ops/pallas_fd.py.  Same semantics as the plain version
// deepfluids_tpu_torch/ops/fd.py curl2d:
//
//   u[b,y,x] =   psi[b,y',x] - psi[b,y'-1,x]     y' = min(y+1, H-1)
//   v[b,y,x] = -(psi[b,y,x'] - psi[b,y,x'-1])    x' = min(x+1, W-1)
//
// so the last row (column) repeats the difference of the one before it.
// psi is [B,H,W,1] contiguous; out is [B,H,W,2] channels-last with (u, v)
// interleaved.  Math is f32; the store is in the input dtype (f32 or bf16).
//
// What bounds it: memory.  Each point is read once from device memory
// (4 B in f32; the y+1 and x+1 neighbours are loaded by neighbouring
// threads, so they come from L1/L2) and writes 8 B, for two subtractions:
// at B = 512 and 128x96 that is about 75 MB per call.  The design keeps the
// traffic at that minimum and nothing more: one thread per (b, y, x),
// consecutive threads along W so loads and stores coalesce, one 8-byte
// float2 (or 4-byte bf16x2) store per point straight into the channels-last
// output, and no transposes around the kernel.  The TPU version transposed
// to NCHW and built the edge with rolls and masks only because Mosaic
// cannot lower sub-tile concatenates; none of that carries over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store_uv(float* out, long long i, float u,
                                         float v) {
  reinterpret_cast<float2*>(out)[i] = make_float2(u, v);
}
__device__ __forceinline__ void store_uv(__nv_bfloat16* out, long long i,
                                         float u, float v) {
  reinterpret_cast<__nv_bfloat162*>(out)[i] = __floats2bfloat162_rn(u, v);
}

template <typename T>
__global__ void curl2d_kernel(const T* __restrict__ psi, T* __restrict__ out,
                              long long n, int H, int W) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % W);
  const int y = (int)((i / W) % H);
  const T* row = psi + (i - x);                    // psi[b, y, 0]
  const T* col = psi + (i - (long long)y * W);     // psi[b, 0, x]
  const int xl = min(x, W - 2);
  const int yl = min(y, H - 2);
  const float dx = to_f32(row[xl + 1]) - to_f32(row[xl]);
  const float dy = to_f32(col[(long long)(yl + 1) * W]) -
                   to_f32(col[(long long)yl * W]);
  store_uv(out, i, dy, -dx);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Launches on ``stream`` of ``device`` and returns cudaGetLastError(), so a
// refused launch is reported to the caller.  H and W must be >= 2 (checked
// by the Python wrapper).
extern "C" int df_curl2d(const void* psi, void* out, long long batch, int H,
                         int W, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n = batch * H * W;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    curl2d_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(psi), static_cast<float*>(out), n, H, W);
  } else if (dtype == 1) {
    curl2d_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(psi),
        static_cast<__nv_bfloat16*>(out), n, H, W);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
