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
//
// The jacobians (#2, #4) keep the traffic at that minimum with one thread
// per (b, y, x), consecutive threads along W so loads and stores coalesce;
// the channels of a point are read and written as one vector (float2 /
// float4, or bf16x2 / 4 x bf16); the neighbours at x+-1 and y+-1 are loaded
// by neighbouring threads, so they come from L1/L2 rather than device
// memory; no transposes around the kernels.  The TPU versions transposed to
// NCHW and built the edges with rolls and masks only because Mosaic cannot
// lower sub-tile concatenates; none of that carries over.
//
// The two curls (#1 and its transpose #3) move the fewest bytes, 12 a point
// in f32 and 6 in bf16 (psi read, (u, v) written, or the reverse), so one
// thread a point spent more issue slots on its own index (a 64-bit division
// and modulo) and on 4-byte accesses than on the bytes, and reached 0.62 of
// the bound.  They run over row tiles instead: a thread owns a run of VEC
// points of a row (4 in f32, 8 in bf16: one 16-byte vector of psi, two of
// (u, v)) in each of R consecutive rows, R = 1 for the curl and 2 for its
// transpose.  It loads the tile's rows and the halo rows the y-stencil
// needs, each once and before its first store, keeps them in registers, and
// takes a neighbour along x outside the run with one scalar load that L1
// serves (the next thread reads that line).  (b, y, x0) come from blockIdx /
// threadIdx in 32-bit arithmetic without a division; only the offsets are
// 64-bit.  Where W is no multiple of VEC, the storage is not 16-byte
// aligned, or (the transpose) the launch is small, the same kernel runs
// with VEC = 1.  The arithmetic, and so every f32 bit, is the one point a
// thread kernels' and the plain versions'.

#include <algorithm>
#include <cstdint>

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

// --- the curls over row tiles ----------------------------------------------

// Rows a thread's tile holds, the forward curl's and its transpose's: the
// fastest on the H100 of tiles of 1 to 32 rows, each preloaded or marched
// (PERF.md).  Deeper tiles load fewer halo rows but leave fewer, longer
// threads, and the card's reads and writes then come in waves.
constexpr int kCurlRows = 1;
constexpr int kCurlBwdRows = 2;
// The transpose takes 16-byte runs from this many points per byte of its
// element on: below, runs of one point are faster on the H100.  Those cost
// about the same a point in f32 and bf16, 16-byte runs their bytes, so the
// crossover grows with the element (measured between 0.79 and 1.57 M
// points in f32, 0.39 and 0.79 M in bf16).
constexpr long long kBwdVectorPointsPerByte = 1 << 18;

// An unsigned integer of B bytes: what one load or store moves.
template <int B>
struct Bits;
template <>
struct Bits<2> {
  using type = unsigned short;
};
template <>
struct Bits<4> {
  using type = unsigned;
};
template <>
struct Bits<8> {
  using type = uint2;
};
template <>
struct Bits<16> {
  using type = uint4;
};

// 32-bit word j of the words w (j is a constant once the callers' loops are
// unrolled, so the words stay in registers).
__device__ __forceinline__ unsigned word(const unsigned* w, int j) {
  return w[j];
}
__device__ __forceinline__ unsigned word(const uint2* w, int j) {
  return j % 2 ? w[j / 2].y : w[j / 2].x;
}
__device__ __forceinline__ unsigned word(const uint4* w, int j) {
  const uint4& q = w[j / 4];
  return j % 4 == 0 ? q.x : j % 4 == 1 ? q.y : j % 4 == 2 ? q.z : q.w;
}

// N consecutive values of T (2 to 32 bytes, a power of two) as a thread
// loads them: in 16-byte vectors, or in one load of all of them when they
// are fewer (the address is aligned to that size).  v[k] is value k as f32.
template <typename T, int N>
struct Run {
  static constexpr int kBytes = N * (int)sizeof(T);
  static constexpr int kLoad = kBytes < 16 ? kBytes : 16;
  using Word = typename Bits<kLoad>::type;
  Word w[kBytes / kLoad];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < kBytes / kLoad; ++i) {
      w[i] = reinterpret_cast<const Word*>(p)[i];
    }
  }
  __device__ __forceinline__ float operator[](int k) const {
    // A bf16 is the high half of an f32; two share a word, the first in
    // its low half.
    if constexpr (kBytes == 2) {
      return __uint_as_float((unsigned)w[0] << 16);
    } else if constexpr (sizeof(T) == 4) {
      return __uint_as_float(word(w, k));
    } else {
      const unsigned u = word(w, k / 2);
      return __uint_as_float(k % 2 ? u & 0xffff0000u : u << 16);
    }
  }
};

// 32-bit word j of the values v, each rounded once to T: one f32, or two
// bf16, the first in the low half.
template <typename T>
__device__ __forceinline__ unsigned pack(const float* v, int j) {
  if constexpr (sizeof(T) == 4) {
    return __float_as_uint(v[j]);
  } else {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j])) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j + 1]))
            << 16);
  }
}

// Stores v, each value rounded once to T, as N consecutive values at p, in
// the accesses a Run<T, N> loads them with.
template <typename T, int N>
__device__ __forceinline__ void store_run(T* p, const float (&v)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  if constexpr (kBytes == 2) {
    store1(p, 0, v[0]);
  } else if constexpr (kBytes == 4) {
    *reinterpret_cast<unsigned*>(p) = pack<T>(v, 0);
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack<T>(v, 0), pack<T>(v, 1));
  } else {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      reinterpret_cast<uint4*>(p)[i] =
          make_uint4(pack<T>(v, 4 * i), pack<T>(v, 4 * i + 1),
                     pack<T>(v, 4 * i + 2), pack<T>(v, 4 * i + 3));
    }
  }
}

// Thread (tx, ty) of block (bx, by, bz) owns the run of VEC points at
// x0 = (bx * blockDim.x + tx) * VEC in each of the R rows from
// y0 = (by * blockDim.y + ty) * R, in fields bz, bz + gridDim.z, ...; a
// thread whose tile lies below the field steps on by the grid's rows.

// (u, v) = (d psi / dy, -d psi / dx): psi [B, H, W, 1] -> out [B, H, W, 2].
template <typename T, int VEC, int R>
__global__ void __launch_bounds__(kThreads)
curl2d_kernel(const T* __restrict__ psi, T* __restrict__ out,
              long long batch, int H, int W) {
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (x0 >= W) return;
  // The neighbour the run's last difference needs: psi at x0 + VEC, or,
  // for a run of one point that ends the row, at x0 - 1.  A longer run that
  // ends the row needs none: its last difference repeats the one before.
  const int xn = x0 + VEC < W ? x0 + VEC : (VEC == 1 ? x0 - 1 : -1);
  const long long plane = (long long)H * W;
  const int ystep = gridDim.y * blockDim.y * R;
  for (long long b = blockIdx.z; b < batch; b += gridDim.z) {
    for (int y0 = (blockIdx.y * blockDim.y + threadIdx.y) * R; y0 < H;
         y0 += ystep) {
      const T* f = psi + b * plane + (long long)y0 * W;     // psi[b, y0, 0]
      T* o = out + 2 * (b * plane + (long long)y0 * W + x0);
      // Rows y0 .. y0 + R (the last is the halo below the tile), those the
      // field has: n of them.
      const int n = min(R + 1, H - y0);
      Run<T, VEC> row[R + 1];
      float nb[R + 1];                                  // psi[b, y0 + r, xn]
#pragma unroll
      for (int r = 0; r <= R; ++r) {
        if (r < n) {
          row[r].load(f + (long long)r * W + x0);
          nb[r] = xn >= 0 ? to_f32(f[(long long)r * W + xn]) : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= n) break;
        float dy[VEC];
        if (r + 1 < n) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) dy[k] = row[r + 1][k] - row[r][k];
        } else if (r > 0) {
          // The field's last row repeats the difference of the one before.
#pragma unroll
          for (int k = 0; k < VEC; ++k) dy[k] = row[r][k] - row[r - 1][k];
        } else {
          // A tile of the field's last row alone reads the row above.
          Run<T, VEC> up;
          up.load(f - W + x0);
#pragma unroll
          for (int k = 0; k < VEC; ++k) dy[k] = row[0][k] - up[k];
        }
        float uv[2 * VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float c = row[r][k];
          const float dx =
              x0 + k + 1 < W ? (k + 1 < VEC ? row[r][k + 1] : nb[r]) - c
                             : c - (k > 0 ? row[r][k - 1] : nb[r]);
          uv[2 * k] = dy[k];
          uv[2 * k + 1] = -dx;
        }
        store_run<T, 2 * VEC>(o + 2LL * r * W, uv);
      }
    }
  }
}

// psi_bar = fdt_y(u_bar) - fdt_x(v_bar): g [B, H, W, 2] -> out [B, H, W, 1].
template <typename T, int VEC, int R>
__global__ void __launch_bounds__(kThreads)
curl2d_bwd_kernel(const T* __restrict__ g, T* __restrict__ out,
                  long long batch, int H, int W) {
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (x0 >= W) return;
  const bool left = x0 > 0, right = x0 + VEC < W;
  const long long plane = (long long)H * W;
  const int ystep = gridDim.y * blockDim.y * R;
  for (long long b = blockIdx.z; b < batch; b += gridDim.z) {
    for (int y0 = (blockIdx.y * blockDim.y + threadIdx.y) * R; y0 < H;
         y0 += ystep) {
      const T* f = g + 2 * (b * plane + (long long)y0 * W + x0);
      T* o = out + b * plane + (long long)y0 * W + x0;
      const int n = min(R, H - y0);                     // the tile's rows
      // row[r + 1]: the (u, v) pairs of row y0 + r, r = -1 .. R, the halo
      // rows those the field has.  fdt reads no row outside the field.
      Run<T, 2 * VEC> row[R + 2] = {};
      float vl[R], vr[R];           // v at x0 - 1 and x0 + VEC, row y0 + r
#pragma unroll
      for (int r = -1; r <= R; ++r) {
        if (y0 + r >= 0 && y0 + r < H) {
          row[r + 1].load(f + 2LL * r * W);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < n) {
          vl[r] = left ? to_f32(f[2LL * r * W - 1]) : 0.f;
          vr[r] = right ? to_f32(f[2LL * r * W + 2 * VEC + 1]) : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= n) break;
        const int y = y0 + r;
        float res[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float gu = fdt(row[r][2 * k], row[r + 1][2 * k],
                               row[r + 2][2 * k], y, H);
          const float vm = k > 0 ? row[r + 1][2 * k - 1] : vl[r];
          const float vp = k + 1 < VEC ? row[r + 1][2 * k + 3] : vr[r];
          const float gv = fdt(vm, row[r + 1][2 * k + 1], vp, x0 + k, W);
          res[k] = gu - gv;
        }
        store_run<T, VEC>(o + (long long)r * W, res);
      }
    }
  }
}

// Selects the device and sizes the grid over n points.
cudaError_t prologue(int device, long long n, unsigned* blocks) {
  *blocks = (unsigned)((n + kThreads - 1) / kThreads);
  return cudaSetDevice(device);
}

// Launch shape of the row-tile kernels for runs of vec points and tiles of
// rows rows: blocks of up to kThreads threads, along x a row's runs, along
// y a field's tiles, each split evenly over the fewest blocks; grid.z walks
// the fields.
struct Tiles {
  dim3 grid, block;
};

Tiles row_tiles(long long batch, int H, int W, int vec, int rows) {
  const int runs = (W + vec - 1) / vec;
  const int tiles = (H + rows - 1) / rows;
  const int nbx = (runs + kThreads - 1) / kThreads;
  const int bx = (runs + nbx - 1) / nbx;
  const int nby = (tiles + kThreads / bx - 1) / (kThreads / bx);
  const int by = (tiles + nby - 1) / nby;
  Tiles t;
  t.grid = dim3(nbx, std::min(nby, 65535),
                (unsigned)std::min(batch, 65535LL));
  t.block = dim3(bx, by);
  return t;
}

// Whether 16-byte runs of T can be taken: W a multiple of them and both
// tensors 16-byte aligned.
template <typename T>
bool vector_runs(const void* in, const void* out, int W) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return W % (16 / sizeof(T)) == 0 && aligned(in) && aligned(out);
}

// The curl over tiles of R rows, in runs of 16 bytes (vec) or one point.
template <int R, typename T>
void launch_curl2d(const T* psi, T* out, long long batch, int H, int W,
                   bool vec, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    const Tiles t = row_tiles(batch, H, W, V, R);
    curl2d_kernel<T, V, R><<<t.grid, t.block, 0, s>>>(psi, out, batch, H,
                                                       W);
  } else {
    const Tiles t = row_tiles(batch, H, W, 1, R);
    curl2d_kernel<T, 1, R><<<t.grid, t.block, 0, s>>>(psi, out, batch, H,
                                                       W);
  }
}

template <int R, typename T>
void launch_curl2d_bwd(const T* g, T* out, long long batch, int H, int W,
                       bool vec, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    const Tiles t = row_tiles(batch, H, W, V, R);
    curl2d_bwd_kernel<T, V, R><<<t.grid, t.block, 0, s>>>(g, out, batch, H,
                                                           W);
  } else {
    const Tiles t = row_tiles(batch, H, W, 1, R);
    curl2d_bwd_kernel<T, 1, R><<<t.grid, t.block, 0, s>>>(g, out, batch, H,
                                                           W);
  }
}

// The forward curl over row tiles; 16-byte runs where they can be taken.
template <typename T>
void curl2d(const void* psi, void* out, long long batch, int H, int W,
            cudaStream_t s) {
  launch_curl2d<kCurlRows>(static_cast<const T*>(psi), static_cast<T*>(out),
                           batch, H, W, vector_runs<T>(psi, out, W), s);
}

// The transpose over row tiles; 16-byte runs where they can be taken and
// the field holds enough points for them to pay.
template <typename T>
void curl2d_bwd(const void* g, void* out, long long batch, int H, int W,
                cudaStream_t s) {
  const bool vec = vector_runs<T>(g, out, W) &&
                   batch * H * W >=
                       kBwdVectorPointsPerByte * (long long)sizeof(T);
  launch_curl2d_bwd<kCurlBwdRows>(static_cast<const T*>(g),
                                  static_cast<T*>(out), batch, H, W, vec, s);
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
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || batch * H * W == 0) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    curl2d<float>(psi, out, batch, H, W, s);
  } else if (dtype == 1) {
    curl2d<__nv_bfloat16>(psi, out, batch, H, W, s);
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
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || batch * H * W == 0) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    curl2d_bwd<float>(g, out, batch, H, W, s);
  } else if (dtype == 1) {
    curl2d_bwd<__nv_bfloat16>(g, out, batch, H, W, s);
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
