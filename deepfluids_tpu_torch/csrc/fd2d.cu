// 2D finite-difference kernels, written by hand for Hopper (sm_90a).
//
// They replace the Pallas TPU kernels of deepfluids_tpu/ops/pallas_fd.py:
//
//   df_curl2d          curl2d_fused      / _curl2d_kernel
//   df_jacobian2d      jacobian2d_fused  / _jacobian2d_kernel
//   df_curl2d_bwd      _curl2d_bwd       / _curl2d_bwd_kernel
//   df_jacobian2d_bwd  _jacobian2d_bwd   / _jacobian2d_bwd_kernel
//
// with the semantics of the plain versions in deepfluids_tpu_torch/ops/fd.py
// (curl2d, jacobian2d, curl2d_bwd, jacobian2d_bwd).  Forward differences
// with edge replication: with x' = min(x, W-2),
//
//   d/dx f[b,y,x] = f[b,y,x'+1] - f[b,y,x']      (same along y with H)
//
// so the last column (row) repeats the difference of the one before it.
// The backward kernels apply the transposed stencil (fdt, fd_common.cuh),
// which is valid for extents >= 3 only (checked by the Python wrappers).
//
// Layouts are channels-last and contiguous: psi [B,H,W,1], velocity
// [B,H,W,2] with (u, v) interleaved, J [B,H,W,4] = (dudx, dudy, dvdx, dvdy),
// vorticity [B,H,W,1].  Math is f32; each output is rounded once to the
// input dtype (f32 or bf16), as the TPU kernels do.
//
// What bounds them: memory.  Each point does a handful of subtractions for
// 12-40 bytes moved (f32): at B = 512 and 128x96 a call moves 75-240 MB.
// The design keeps the traffic at that minimum: one thread per (b, y, x),
// consecutive threads along W so loads and stores coalesce; the channels of
// a point are read and written as one vector (float2 / float4, or bf16x2 /
// 4 x bf16); the neighbours at x+-1 and y+-1 are loaded by neighbouring
// threads, so they come from L1/L2 rather than device memory; no transposes
// around the kernels.  The TPU versions transposed to NCHW and built the
// edges with rolls and masks only because Mosaic cannot lower sub-tile
// concatenates; none of that carries over.

#include "fd_common.cuh"

namespace {

struct __align__(8) bf16x4 {
  __nv_bfloat162 lo, hi;
};

// The two channels of point i of a [.., 2] tensor.
__device__ __forceinline__ float2 load2(const float* p, long long i) {
  return reinterpret_cast<const float2*>(p)[i];
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p, long long i) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[i]);
}

// The four channels of point i of a [.., 4] tensor.
__device__ __forceinline__ float4 load4(const float* p, long long i) {
  return reinterpret_cast<const float4*>(p)[i];
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, long long i) {
  const bf16x4 q = reinterpret_cast<const bf16x4*>(p)[i];
  const float2 a = __bfloat1622float2(q.lo);
  const float2 b = __bfloat1622float2(q.hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store2(float* p, long long i, float a,
                                       float b) {
  reinterpret_cast<float2*>(p)[i] = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, long long i, float a,
                                       float b) {
  reinterpret_cast<__nv_bfloat162*>(p)[i] = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store4(float* p, long long i, float a,
                                       float b, float c, float d) {
  reinterpret_cast<float4*>(p)[i] = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, long long i, float a,
                                       float b, float c, float d) {
  bf16x4 q;
  q.lo = __floats2bfloat162_rn(a, b);
  q.hi = __floats2bfloat162_rn(c, d);
  reinterpret_cast<bf16x4*>(p)[i] = q;
}

// Point index i -> (x, y) and the flat indices of its neighbours.  At an
// edge the missing neighbour is the point itself (fdt does not read it).
struct Point {
  int x, y;
  long long xm, xp, ym, yp;
};

__device__ __forceinline__ Point locate(long long i, int H, int W) {
  Point p;
  p.x = (int)(i % W);
  p.y = (int)((i / W) % H);
  p.xm = i - (p.x > 0);
  p.xp = i + (p.x < W - 1);
  p.ym = i - (p.y > 0 ? W : 0);
  p.yp = i + (p.y < H - 1 ? W : 0);
  return p;
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
  store2(out, i, dy, -dx);
}

template <typename T>
__global__ void jacobian2d_kernel(const T* __restrict__ vel,
                                  T* __restrict__ jac, T* __restrict__ vort,
                                  long long n, int H, int W) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % W);
  const int y = (int)((i / W) % H);
  const long long row = i - x;                     // point (b, y, 0)
  const long long col = i - (long long)y * W;      // point (b, 0, x)
  const int xl = min(x, W - 2);
  const int yl = min(y, H - 2);
  const float2 x0 = load2(vel, row + xl);
  const float2 x1 = load2(vel, row + xl + 1);
  const float2 y0 = load2(vel, col + (long long)yl * W);
  const float2 y1 = load2(vel, col + (long long)(yl + 1) * W);
  const float dudx = x1.x - x0.x;
  const float dvdx = x1.y - x0.y;
  const float dudy = y1.x - y0.x;
  const float dvdy = y1.y - y0.y;
  store4(jac, i, dudx, dudy, dvdx, dvdy);
  store1(vort, i, dvdx - dudy);    // f32, rounded once
}

// psi_bar = fdt_y(u_bar) - fdt_x(v_bar)
template <typename T>
__global__ void curl2d_bwd_kernel(const T* __restrict__ g, T* __restrict__ out,
                                  long long n, int H, int W) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Point p = locate(i, H, W);
  const float2 c = load2(g, i);
  const float gu = fdt(load2(g, p.ym).x, c.x, load2(g, p.yp).x, p.y, H);
  const float gv = fdt(load2(g, p.xm).y, c.y, load2(g, p.xp).y, p.x, W);
  store1(out, i, gu - gv);
}

// u_bar = fdt_x(J0) + fdt_y(J1) - fdt_y(w_bar)
// v_bar = fdt_x(J2) + fdt_y(J3) + fdt_x(w_bar)
template <typename T>
__global__ void jacobian2d_bwd_kernel(const T* __restrict__ gj,
                                      const T* __restrict__ gw,
                                      T* __restrict__ out, long long n, int H,
                                      int W) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Point p = locate(i, H, W);
  const float4 c = load4(gj, i);
  const float4 l = load4(gj, p.xm);
  const float4 r = load4(gj, p.xp);
  const float4 d = load4(gj, p.ym);
  const float4 u = load4(gj, p.yp);
  const float wc = to_f32(gw[i]);
  const float ub = fdt(l.x, c.x, r.x, p.x, W) + fdt(d.y, c.y, u.y, p.y, H) -
                   fdt(to_f32(gw[p.ym]), wc, to_f32(gw[p.yp]), p.y, H);
  const float vb = fdt(l.z, c.z, r.z, p.x, W) + fdt(d.w, c.w, u.w, p.y, H) +
                   fdt(to_f32(gw[p.xm]), wc, to_f32(gw[p.xp]), p.x, W);
  store2(out, i, ub, vb);
}

// Selects the device and sizes the grid over n points.
cudaError_t prologue(int device, long long n, unsigned* blocks) {
  *blocks = (unsigned)((n + kThreads - 1) / kThreads);
  return cudaSetDevice(device);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  dtype: 0 = float32,
// 1 = bfloat16.  Each launches on ``stream`` of ``device`` and returns
// cudaGetLastError(), so a refused launch is reported to the caller.
// Pointers are to contiguous tensors of the layouts above.  H and W must be
// >= 2 for the forward kernels and >= 3 for the backward ones (checked by
// the Python wrappers in ops/cuda_fd.py).

extern "C" int df_curl2d(const void* psi, void* out, long long batch, int H,
                         int W, int dtype, int device, void* stream) {
  const long long n = batch * H * W;
  unsigned blocks;
  cudaError_t err = prologue(device, n, &blocks);
  if (err != cudaSuccess || n == 0) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    curl2d_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(psi), static_cast<float*>(out), n, H, W);
  } else if (dtype == 1) {
    curl2d_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(psi),
        static_cast<__nv_bfloat16*>(out), n, H, W);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int df_jacobian2d(const void* vel, void* jac, void* vort,
                             long long batch, int H, int W, int dtype,
                             int device, void* stream) {
  const long long n = batch * H * W;
  unsigned blocks;
  cudaError_t err = prologue(device, n, &blocks);
  if (err != cudaSuccess || n == 0) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    jacobian2d_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(vel), static_cast<float*>(jac),
        static_cast<float*>(vort), n, H, W);
  } else if (dtype == 1) {
    jacobian2d_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(vel),
        static_cast<__nv_bfloat16*>(jac), static_cast<__nv_bfloat16*>(vort),
        n, H, W);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int df_curl2d_bwd(const void* g, void* out, long long batch, int H,
                             int W, int dtype, int device, void* stream) {
  const long long n = batch * H * W;
  unsigned blocks;
  cudaError_t err = prologue(device, n, &blocks);
  if (err != cudaSuccess || n == 0) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    curl2d_bwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<float*>(out), n, H, W);
  } else if (dtype == 1) {
    curl2d_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(out), n, H, W);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int df_jacobian2d_bwd(const void* gj, const void* gw, void* out,
                                 long long batch, int H, int W, int dtype,
                                 int device, void* stream) {
  const long long n = batch * H * W;
  unsigned blocks;
  cudaError_t err = prologue(device, n, &blocks);
  if (err != cudaSuccess || n == 0) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    jacobian2d_bwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(gj), static_cast<const float*>(gw),
        static_cast<float*>(out), n, H, W);
  } else if (dtype == 1) {
    jacobian2d_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(gj),
        static_cast<const __nv_bfloat16*>(gw),
        static_cast<__nv_bfloat16*>(out), n, H, W);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
