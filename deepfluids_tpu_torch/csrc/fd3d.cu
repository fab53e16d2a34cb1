// 3D finite-difference kernels, written by hand for Hopper (sm_90a).
//
// They replace the Pallas TPU kernels of deepfluids_tpu/ops/pallas_fd.py:
//
//   df_curl3d          curl3d_fused      / _curl3d_kernel, _fd_z
//   df_jacobian3d      jacobian3d_fused  / _jacobian3d_kernel (+ the
//                      vorticity, built outside the TPU kernel)
//   df_curl3d_bwd      _curl3d_bwd       / _curl3d_bwd_kernel, _fdt_z
//   df_jacobian3d_bwd  _jacobian3d_bwd   / _jacobian3d_bwd_kernel (+ the
//                      vorticity cotangent, folded in by _jacobian3d_p_bwd)
//
// with the semantics of the plain versions in deepfluids_tpu_torch/ops/fd.py
// (curl3d, jacobian3d, curl3d_bwd, jacobian3d_bwd).  Forward differences
// with edge replication along x (W), y (H) and z (D): with z' = min(z, D-2),
//
//   d/dz f[b,z,y,x] = f[b,z'+1,y,x] - f[b,z',y,x]      (same along y and x)
//
// The backward kernels apply the transposed stencil (fdt, fd_common.cuh),
// valid for extents >= 3 only (checked by the Python wrappers).
//
// Layouts are channels-last and contiguous: psi and velocity [B,D,H,W,3],
// J [B,D,H,W,9] = (dudx, dudy, dudz, dvdx, dvdy, dvdz, dwdx, dwdy, dwdz),
// vorticity [B,D,H,W,3] = (dwdy - dvdz, dudz - dwdx, dvdx - dudy).  Math is
// f32; each output is rounded once to the input dtype (f32 or bf16).  The
// vorticity is taken from the f32 derivatives (the TPU version subtracts
// the stored J entries, which differs in bf16 only).
//
// What bounds them: memory.  Per point, in f32, curl3d and curl3d_bwd move
// 24 bytes, jacobian3d and jacobian3d_bwd 60: at [32,32,64,112] a call
// moves 176 or 440 MB.  The design keeps device-memory traffic at that
// minimum and stays simple: one thread per point (b, z, y, x), a block per
// run of 256 points of one (b, z) plane with x fastest, so loads and stores
// of a warp cover one contiguous span and coalesce.  Channels 3 and 9 are
// no vector widths, so each channel is read and written as a scalar
// (jacobian3d stages its stores in shared memory, see there); the
// neighbours at x+-1, y+-1 (W points away) and z+-1 (H*W points away, 86 KB
// in f32 at 64x112) were or will be read by other threads, so they come
// from L1/L2 (50 MB) rather than device memory.  The grid is (B*D planes,
// chunks of a plane), so a thread finds its (x, y, z) with 32-bit
// arithmetic.  The TPU versions walked z in a loop over whole VMEM-resident
// volumes; here the blocks of all planes run at once.

#include <climits>

#include "fd_common.cuh"

namespace {

// Element e of a tensor, in f32.
template <typename T>
__device__ __forceinline__ float ld(const T* p, long long e) {
  return to_f32(p[e]);
}

// A thread's point: its flat index ((b*D + z)*H + y)*W + x and coordinates.
struct Point {
  long long i;
  int x, y, z;
};

// The point of this thread, false past the end of its plane.
__device__ __forceinline__ bool locate(int D, int H, int W, Point* p) {
  const int hw = H * W;
  const int r = blockIdx.y * blockDim.x + threadIdx.x;
  if (r >= hw) return false;
  p->z = (int)(blockIdx.x % (unsigned)D);
  p->y = r / W;
  p->x = r - p->y * W;
  p->i = (long long)blockIdx.x * hw + r;
  return true;
}

// Forward difference of channel k of a [.., C] tensor along one axis, at
// the pair of points (p0, p0 + stride) with p0 clamped for the last row.
template <int C, typename T>
__device__ __forceinline__ float fwd(const T* f, long long i, int j, int n,
                                     long long stride, int k) {
  const long long p0 = i + (long long)(min(j, n - 2) - j) * stride;
  return ld(f, (p0 + stride) * C + k) - ld(f, p0 * C + k);
}

// A point's neighbours along one axis; at an edge the missing neighbour is
// the point itself (fdt does not read it).
struct Axis {
  long long m, p;
  int j, n;
};

__device__ __forceinline__ Axis axis(long long i, int j, int n,
                                     long long stride) {
  Axis a;
  a.m = i - (j > 0 ? stride : 0);
  a.p = i + (j < n - 1 ? stride : 0);
  a.j = j;
  a.n = n;
  return a;
}

// fdt along axis a of channel k of a [.., C] tensor at point i.
template <int C, typename T>
__device__ __forceinline__ float fdt_at(const T* g, long long i,
                                        const Axis& a, int k) {
  return fdt(ld(g, a.m * C + k), ld(g, i * C + k), ld(g, a.p * C + k), a.j,
             a.n);
}

// u = dc/dy - db/dz,  v = da/dz - dc/dx,  w = db/dx - da/dy
template <typename T>
__global__ void curl3d_kernel(const T* __restrict__ psi, T* __restrict__ out,
                              int D, int H, int W) {
  Point q;
  if (!locate(D, H, W, &q)) return;
  const long long i = q.i, hw = (long long)H * W;
  const float dady = fwd<3>(psi, i, q.y, H, W, 0);
  const float dadz = fwd<3>(psi, i, q.z, D, hw, 0);
  const float dbdx = fwd<3>(psi, i, q.x, W, 1, 1);
  const float dbdz = fwd<3>(psi, i, q.z, D, hw, 1);
  const float dcdx = fwd<3>(psi, i, q.x, W, 1, 2);
  const float dcdy = fwd<3>(psi, i, q.y, H, W, 2);
  store1(out, 3 * i, dcdy - dbdz);
  store1(out, 3 * i + 1, dadz - dcdx);
  store1(out, 3 * i + 2, dbdx - dady);
}

// J and the vorticity go through shared memory: a point's 9 (3) outputs
// lie 36 (12) bytes from the next thread's, so a warp storing them one
// channel at a time would touch 9 (3) times the sectors it fills.  Staged,
// the block writes its points' outputs as two contiguous runs.
template <typename T>
__global__ void jacobian3d_kernel(const T* __restrict__ vel,
                                  T* __restrict__ jac, T* __restrict__ vort,
                                  int D, int H, int W) {
  __shared__ float sj[kThreads * 9];
  __shared__ float sv[kThreads * 3];
  const int t = threadIdx.x;
  Point q;
  if (locate(D, H, W, &q)) {
    const long long i = q.i, hw = (long long)H * W;
    float d[9];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      d[3 * k] = fwd<3>(vel, i, q.x, W, 1, k);
      d[3 * k + 1] = fwd<3>(vel, i, q.y, H, W, k);
      d[3 * k + 2] = fwd<3>(vel, i, q.z, D, hw, k);
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) sj[9 * t + k] = d[k];
    sv[3 * t] = d[7] - d[5];           // f32, rounded once on the store
    sv[3 * t + 1] = d[2] - d[6];
    sv[3 * t + 2] = d[3] - d[1];
  }
  __syncthreads();
  // This block's points: a run of n of one plane from point i0 on.
  const int r0 = blockIdx.y * blockDim.x;
  const int n = min((int)blockDim.x, H * W - r0);
  const long long i0 = (long long)blockIdx.x * H * W + r0;
  for (int e = t; e < 9 * n; e += blockDim.x) store1(jac, 9 * i0 + e, sj[e]);
  for (int e = t; e < 3 * n; e += blockDim.x) store1(vort, 3 * i0 + e, sv[e]);
}

// a_bar = fdt_z(v_bar) - fdt_y(w_bar)
// b_bar = fdt_x(w_bar) - fdt_z(u_bar)
// c_bar = fdt_y(u_bar) - fdt_x(v_bar)
template <typename T>
__global__ void curl3d_bwd_kernel(const T* __restrict__ g, T* __restrict__ out,
                                  int D, int H, int W) {
  Point q;
  if (!locate(D, H, W, &q)) return;
  const long long i = q.i, hw = (long long)H * W;
  const Axis ax = axis(i, q.x, W, 1);
  const Axis ay = axis(i, q.y, H, W);
  const Axis az = axis(i, q.z, D, hw);
  store1(out, 3 * i, fdt_at<3>(g, i, az, 1) - fdt_at<3>(g, i, ay, 2));
  store1(out, 3 * i + 1, fdt_at<3>(g, i, ax, 2) - fdt_at<3>(g, i, az, 0));
  store1(out, 3 * i + 2, fdt_at<3>(g, i, ay, 0) - fdt_at<3>(g, i, ax, 1));
}

// Entry E of J's cotangent at point p with the vorticity's cotangent folded
// in, as ops/fd.py jacobian3d_bwd folds it: J7 += v0, J5 -= v0, J2 += v1,
// J6 -= v1, J3 += v2, J1 -= v2.
template <int E, typename T>
__device__ __forceinline__ float folded(const T* gj, const T* gv,
                                        long long p) {
  const float j = ld(gj, 9 * p + E);
  if (E == 7) return j + ld(gv, 3 * p);
  if (E == 5) return j - ld(gv, 3 * p);
  if (E == 2) return j + ld(gv, 3 * p + 1);
  if (E == 6) return j - ld(gv, 3 * p + 1);
  if (E == 3) return j + ld(gv, 3 * p + 2);
  if (E == 1) return j - ld(gv, 3 * p + 2);
  return j;
}

template <int E, typename T>
__device__ __forceinline__ float fdt_folded(const T* gj, const T* gv,
                                            long long i, const Axis& a) {
  return fdt(folded<E>(gj, gv, a.m), folded<E>(gj, gv, i),
             folded<E>(gj, gv, a.p), a.j, a.n);
}

// x_bar[k] = fdt_x(J[3k]) + fdt_y(J[3k+1]) + fdt_z(J[3k+2]), J folded
template <typename T>
__global__ void jacobian3d_bwd_kernel(const T* __restrict__ gj,
                                      const T* __restrict__ gv,
                                      T* __restrict__ out, int D, int H,
                                      int W) {
  Point q;
  if (!locate(D, H, W, &q)) return;
  const long long i = q.i, hw = (long long)H * W;
  const Axis ax = axis(i, q.x, W, 1);
  const Axis ay = axis(i, q.y, H, W);
  const Axis az = axis(i, q.z, D, hw);
  store1(out, 3 * i,
         fdt_folded<0>(gj, gv, i, ax) + fdt_folded<1>(gj, gv, i, ay) +
             fdt_folded<2>(gj, gv, i, az));
  store1(out, 3 * i + 1,
         fdt_folded<3>(gj, gv, i, ax) + fdt_folded<4>(gj, gv, i, ay) +
             fdt_folded<5>(gj, gv, i, az));
  store1(out, 3 * i + 2,
         fdt_folded<6>(gj, gv, i, ax) + fdt_folded<7>(gj, gv, i, ay) +
             fdt_folded<8>(gj, gv, i, az));
}

// Selects the device and sizes the grid: along x one entry per (b, z)
// plane, along y enough blocks of kThreads to cover its H*W points (at most
// 65535, the grid's y limit).  *empty is set when there is nothing to
// launch.
cudaError_t prologue(int device, long long batch, int D, int H, int W,
                     dim3* grid, bool* empty) {
  const long long planes = batch * D;
  const long long hw = (long long)H * W;
  if (planes > INT_MAX || hw > 65535LL * kThreads) {
    return cudaErrorInvalidValue;
  }
  *empty = planes == 0 || hw == 0;
  *grid = dim3((unsigned)planes, (unsigned)((hw + kThreads - 1) / kThreads));
  return cudaSetDevice(device);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  dtype: 0 = float32,
// 1 = bfloat16.  Each launches on ``stream`` of ``device`` and returns
// cudaGetLastError(), so a refused launch is reported to the caller.
// Pointers are to contiguous tensors of the layouts above.  D, H and W must
// be >= 2 for the forward kernels and >= 3 for the backward ones (checked
// by the Python wrappers in ops/cuda_fd.py).

extern "C" int df_curl3d(const void* psi, void* out, long long batch, int D,
                         int H, int W, int dtype, int device, void* stream) {
  dim3 grid;
  bool empty;
  cudaError_t err = prologue(device, batch, D, H, W, &grid, &empty);
  if (err != cudaSuccess || empty) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    curl3d_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(psi), static_cast<float*>(out), D, H, W);
  } else if (dtype == 1) {
    curl3d_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(psi),
        static_cast<__nv_bfloat16*>(out), D, H, W);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int df_jacobian3d(const void* vel, void* jac, void* vort,
                             long long batch, int D, int H, int W, int dtype,
                             int device, void* stream) {
  dim3 grid;
  bool empty;
  cudaError_t err = prologue(device, batch, D, H, W, &grid, &empty);
  if (err != cudaSuccess || empty) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    jacobian3d_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(vel), static_cast<float*>(jac),
        static_cast<float*>(vort), D, H, W);
  } else if (dtype == 1) {
    jacobian3d_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(vel),
        static_cast<__nv_bfloat16*>(jac), static_cast<__nv_bfloat16*>(vort),
        D, H, W);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int df_curl3d_bwd(const void* g, void* out, long long batch, int D,
                             int H, int W, int dtype, int device,
                             void* stream) {
  dim3 grid;
  bool empty;
  cudaError_t err = prologue(device, batch, D, H, W, &grid, &empty);
  if (err != cudaSuccess || empty) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    curl3d_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<float*>(out), D, H, W);
  } else if (dtype == 1) {
    curl3d_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(out), D, H, W);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int df_jacobian3d_bwd(const void* gj, const void* gv, void* out,
                                 long long batch, int D, int H, int W,
                                 int dtype, int device, void* stream) {
  dim3 grid;
  bool empty;
  cudaError_t err = prologue(device, batch, D, H, W, &grid, &empty);
  if (err != cudaSuccess || empty) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    jacobian3d_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(gj), static_cast<const float*>(gv),
        static_cast<float*>(out), D, H, W);
  } else if (dtype == 1) {
    jacobian3d_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(gj),
        static_cast<const __nv_bfloat16*>(gv),
        static_cast<__nv_bfloat16*>(out), D, H, W);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
