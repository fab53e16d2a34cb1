// The 2D jacobian and its transpose of csrc/fd2d.cu at other tile heights
// and run widths, marched, and in the one-thread-a-point design the row
// tiles replaced, for tools/jacobian_tiles.py: the measurements behind
// kJacRows, kJacBwdRows, kJacVec and kJacBwdVec.  Built apart from the
// port's library (nvcc -I csrc), never by it.
//
// A preloaded tile is fd2d.cu's own kernel at R rows: every row the tile
// reads is loaded before its first store.  A march walks the same R rows
// but loads each row one row ahead of the one it stores, so that loads and
// stores interleave.

#include "fd2d.cu"

namespace {

// --- one thread a point -----------------------------------------------------

struct __align__(8) bf16x4 {
  __nv_bfloat162 lo, hi;
};

__device__ __forceinline__ float2 load2(const float* p, long long i) {
  return reinterpret_cast<const float2*>(p)[i];
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p, long long i) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[i]);
}
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

template <typename T>
__global__ void jacobian2d_point_kernel(const T* __restrict__ vel,
                                        T* __restrict__ jac,
                                        T* __restrict__ vort, long long n,
                                        int H, int W) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % W);
  const int y = (int)((i / W) % H);
  const long long row = i - x;
  const long long col = i - (long long)y * W;
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
  store1(vort, i, dvdx - dudy);
}

template <typename T>
__global__ void jacobian2d_bwd_point_kernel(const T* __restrict__ gj,
                                            const T* __restrict__ gw,
                                            T* __restrict__ out, long long n,
                                            int H, int W) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % W);
  const int y = (int)((i / W) % H);
  const long long xm = i - (x > 0), xp = i + (x < W - 1);
  const long long ym = i - (y > 0 ? W : 0), yp = i + (y < H - 1 ? W : 0);
  const float4 c = load4(gj, i);
  const float4 l = load4(gj, xm);
  const float4 r = load4(gj, xp);
  const float4 d = load4(gj, ym);
  const float4 u = load4(gj, yp);
  const float wc = to_f32(gw[i]);
  const float ub = fdt(l.x, c.x, r.x, x, W) + fdt(d.y, c.y, u.y, y, H) -
                   fdt(to_f32(gw[ym]), wc, to_f32(gw[yp]), y, H);
  const float vb = fdt(l.z, c.z, r.z, x, W) + fdt(d.w, c.w, u.w, y, H) +
                   fdt(to_f32(gw[xm]), wc, to_f32(gw[xp]), x, W);
  store2(out, i, ub, vb);
}

// --- marches ----------------------------------------------------------------

template <typename T, int VEC, int R>
__global__ void __launch_bounds__(kThreads)
jacobian2d_march_kernel(const T* __restrict__ vel, T* __restrict__ jac,
                        T* __restrict__ vort, long long batch, int H, int W) {
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (x0 >= W) return;
  const int xn = x0 + VEC < W ? x0 + VEC : (VEC == 1 ? x0 - 1 : -1);
  const long long plane = (long long)H * W;
  const int ystep = gridDim.y * blockDim.y * R;
  for (long long b = blockIdx.z; b < batch; b += gridDim.z) {
    for (int y0 = (blockIdx.y * blockDim.y + threadIdx.y) * R; y0 < H;
         y0 += ystep) {
      const long long p = b * plane + (long long)y0 * W;
      const T* f = vel + 2 * p;
      const int n = min(R + 1, H - y0);
      Run<T, 2 * VEC> row[R + 1];
      Run<T, 2> nb[R + 1] = {};
      const auto fetch = [&](int r) {
        row[r].load(f + 2LL * (r * W + x0));
        if (xn >= 0) nb[r].load(f + 2LL * (r * W + xn));
      };
      fetch(0);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= n) break;
        if (r + 1 < n) fetch(r + 1);
        T* jr = jac + 4 * (p + (long long)r * W + x0);
        T* wr = vort + p + (long long)r * W + x0;
        if (r + 1 < n) {
          jacobian_row<T, VEC>(row[r], row[r + 1], row[r], nb[r], x0, W, jr,
                               wr);
        } else if (r > 0) {
          jacobian_row<T, VEC>(row[r - 1], row[r], row[r], nb[r], x0, W, jr,
                               wr);
        } else {
          Run<T, 2 * VEC> up;
          up.load(f - 2LL * (W - x0));
          jacobian_row<T, VEC>(up, row[0], row[0], nb[0], x0, W, jr, wr);
        }
      }
    }
  }
}

template <typename T, int VEC, int R, bool kVort>
__global__ void __launch_bounds__(kThreads)
jacobian2d_bwd_march_kernel(const T* __restrict__ gj,
                            const T* __restrict__ gw, T* __restrict__ out,
                            long long batch, int H, int W) {
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (x0 >= W) return;
  const bool left = x0 > 0, right = VEC == 1 && x0 == W - 2;
  const long long plane = (long long)H * W;
  const int ystep = gridDim.y * blockDim.y * R;
  for (long long b = blockIdx.z; b < batch; b += gridDim.z) {
    for (int y0 = (blockIdx.y * blockDim.y + threadIdx.y) * R; y0 < H;
         y0 += ystep) {
      const long long p = b * plane + (long long)y0 * W + x0;
      const T* fj = gj + 4 * p;
      const T* fw = kVort ? gw + p : nullptr;
      const int n = min(R, H - y0);
      Run<T, 4 * VEC> jr[R + 2] = {};
      Run<T, VEC> wr[R + 2] = {};
      Run<T, 4> jxm[R] = {}, jxp[R] = {};
      Run<T, 1> wxm[R] = {}, wxp[R] = {};
      // Row y0 + r with, inside the tile, its x neighbours.
      const auto fetch = [&](int r) {
        jr[r + 1].load(fj + 4LL * r * W);
        if constexpr (kVort) wr[r + 1].load(fw + (long long)r * W);
        if (r < 0 || r >= R) return;
        if (left) {
          jxm[r].load(fj + 4LL * r * W - 4);
          if constexpr (kVort) wxm[r].load(fw + (long long)r * W - 1);
        }
        if (right) {
          jxp[r].load(fj + 4LL * r * W + 4 * VEC);
          if constexpr (kVort) wxp[r].load(fw + (long long)r * W + VEC);
        }
      };
      if (y0 > 0) fetch(-1);
      fetch(0);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= n) break;
        if (r + 1 < R ? r + 1 < n : y0 + R == H - 1) fetch(r + 1);
        jacobian_bwd_row<T, VEC, kVort>(
            jr[r], jr[r + 1], jr[r + 2], jxm[r], jxp[r], wr[r], wr[r + 1],
            wr[r + 2], wxm[r], wxp[r], x0, y0 + r, H, W,
            out + 2 * (p + (long long)r * W));
      }
    }
  }
}

template <int R, int V, typename T>
void march_jacobian2d(const T* vel, T* jac, T* vort, long long batch, int H,
                      int W, cudaStream_t s) {
  const Tiles t = row_tiles(batch, H, W, V, R);
  jacobian2d_march_kernel<T, V, R><<<t.grid, t.block, 0, s>>>(
      vel, jac, vort, batch, H, W);
}

template <int R, int V, bool kVort, typename T>
void march_jacobian2d_bwd(const T* gj, const T* gw, T* out, long long batch,
                          int H, int W, cudaStream_t s) {
  const Tiles t = row_tiles(batch, H, W, V, R);
  jacobian2d_bwd_march_kernel<T, V, R, kVort><<<t.grid, t.block, 0, s>>>(
      gj, gw, out, batch, H, W);
}

template <int R, int V, typename T>
void tiles(const T* in, const T* gw, T* out0, T* out1, long long batch,
           int H, int W, bool bwd, bool march, cudaStream_t s) {
  if (!bwd && march) {
    march_jacobian2d<R, V>(in, out0, out1, batch, H, W, s);
  } else if (!bwd) {
    launch_jacobian2d<R, V>(in, out0, out1, batch, H, W, s);
  } else if (march && gw) {
    march_jacobian2d_bwd<R, V, true>(in, gw, out0, batch, H, W, s);
  } else if (march) {
    march_jacobian2d_bwd<R, V, false>(in, gw, out0, batch, H, W, s);
  } else if (gw) {
    launch_jacobian2d_bwd<R, V, true>(in, gw, out0, batch, H, W, s);
  } else {
    launch_jacobian2d_bwd<R, V, false>(in, gw, out0, batch, H, W, s);
  }
}

template <int R, typename T>
int rows_of(const T* in, const T* gw, T* out0, T* out1, long long batch,
            int H, int W, bool bwd, bool march, int vec, cudaStream_t s) {
  if (vec == 1) {
    tiles<R, 1>(in, gw, out0, out1, batch, H, W, bwd, march, s);
  } else if (vec == 2) {
    tiles<R, 2>(in, gw, out0, out1, batch, H, W, bwd, march, s);
  } else if (vec == 4) {
    tiles<R, 4>(in, gw, out0, out1, batch, H, W, bwd, march, s);
  } else if (vec == 8 && sizeof(T) == 2) {
    tiles<R, 8>(in, gw, out0, out1, batch, H, W, bwd, march, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <typename T>
int variant(const T* in, const T* gw, T* out0, T* out1, long long batch,
            int H, int W, bool bwd, int rows, bool march, int vec,
            cudaStream_t s) {
  if (rows == 0) {            // one thread a point; gw must not be null
    const long long n = batch * H * W;
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    if (bwd) {
      jacobian2d_bwd_point_kernel<T><<<blocks, kThreads, 0, s>>>(
          in, gw, out0, n, H, W);
    } else {
      jacobian2d_point_kernel<T><<<blocks, kThreads, 0, s>>>(in, out0, out1,
                                                              n, H, W);
    }
    return 0;
  }
  if (rows == 1) {
    return rows_of<1>(in, gw, out0, out1, batch, H, W, bwd, march, vec, s);
  }
  if (rows == 2) {
    return rows_of<2>(in, gw, out0, out1, batch, H, W, bwd, march, vec, s);
  }
  if (rows == 4) {
    return rows_of<4>(in, gw, out0, out1, batch, H, W, bwd, march, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The jacobian (bwd 0: in = vel, out0 = J, out1 = w) or its transpose
// (bwd 1: in = J's cotangent, gw = w's or null, out0 = the velocity's) over
// tiles of rows rows (1, 2 or 4), preloaded (march 0) or marched one row
// ahead, in runs of vec points (1, 2, 4, or 8 in bf16; more than one: W a
// multiple of vec and every tensor 16-byte aligned); rows 0 is one thread
// a point (gw not null).  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a variant not built.
extern "C" int tile_jacobian2d(const void* in, const void* gw, void* out0,
                               void* out1, long long batch, int H, int W,
                               int dtype, int bwd, int rows, int march,
                               int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = variant(static_cast<const float*>(in), static_cast<const float*>(gw),
                 static_cast<float*>(out0), static_cast<float*>(out1), batch,
                 H, W, bwd, rows, march, vec, s);
  } else if (dtype == 1) {
    rc = variant(static_cast<const __nv_bfloat16*>(in),
                 static_cast<const __nv_bfloat16*>(gw),
                 static_cast<__nv_bfloat16*>(out0),
                 static_cast<__nv_bfloat16*>(out1), batch, H, W, bwd, rows,
                 march, vec, s);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  return rc != 0 ? rc : (int)cudaGetLastError();
}
