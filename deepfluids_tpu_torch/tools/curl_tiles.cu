// The 2D curls of csrc/fd2d.cu at other tile heights and run widths, and as
// a rolling march, for tools/curl_tiles.py: the measurements behind
// kCurlRows, kCurlBwdRows and kBwdVectorPointsPerByte.  Built apart from
// the port's library (nvcc -I csrc), never by it.
//
// A preloaded tile (dist 0) is fd2d.cu's own kernel at R rows: every row
// the tile reads is loaded before its first store.  A march (dist D > 0)
// walks the same R rows but loads each row D rows ahead of the one it
// stores, so that loads and stores interleave.

#include "fd2d.cu"

namespace {

template <typename T, int VEC>
__device__ __forceinline__ void fetch(Run<T, VEC>& w, float& nb, const T* p,
                                      int dn) {
  w.load(p);
  nb = dn != 0 ? to_f32(p[dn]) : 0.f;
}

template <typename T, int VEC, int R, int D>
__global__ void __launch_bounds__(kThreads)
curl2d_march_kernel(const T* __restrict__ psi, T* __restrict__ out,
                    long long batch, int H, int W) {
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (x0 >= W) return;
  const int xn = x0 + VEC < W ? x0 + VEC : (VEC == 1 ? x0 - 1 : -1);
  const int dn = xn >= 0 ? xn - x0 : 0;
  const long long plane = (long long)H * W;
  const int ystep = gridDim.y * blockDim.y * R;
  for (long long b = blockIdx.z; b < batch; b += gridDim.z) {
    for (int y0 = (blockIdx.y * blockDim.y + threadIdx.y) * R; y0 < H;
         y0 += ystep) {
      const T* f = psi + b * plane + (long long)y0 * W + x0;
      T* o = out + 2 * (b * plane + (long long)y0 * W + x0);
      const int n = min(R + 1, H - y0);
      Run<T, VEC> row[R + 1];
      float nb[R + 1];
#pragma unroll
      for (int r = 0; r < D && r <= R; ++r) {
        if (r < n) fetch(row[r], nb[r], f + (long long)r * W, dn);
      }
      float dy[VEC];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= n) break;
        if (r + D <= R && r + D < n) {
          fetch(row[r + D], nb[r + D], f + (long long)(r + D) * W, dn);
        }
        if (r + 1 < n) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) dy[k] = row[r + 1][k] - row[r][k];
        } else if (r == 0) {
          Run<T, VEC> up;
          up.load(f - W);
#pragma unroll
          for (int k = 0; k < VEC; ++k) dy[k] = row[0][k] - up[k];
        }  // else the field's last row repeats the dy of the row before
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

template <typename T, int VEC, int R, int D>
__global__ void __launch_bounds__(kThreads)
curl2d_bwd_march_kernel(const T* __restrict__ g, T* __restrict__ out,
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
      const int n = min(R, H - y0);
      // row[s]: row y0 + s - 1, s = 0 .. R + 1
      Run<T, 2 * VEC> row[R + 2] = {};
      float vl[R + 2], vr[R + 2];
#pragma unroll
      for (int s = 0; s <= R + 1; ++s) {
        // rows 0 .. D first, row r + D + 1 while row r is stored
        if (s > D) break;
        const int y = y0 + s - 1;
        if (y >= 0 && y < H) {
          const T* p = f + 2LL * (s - 1) * W;
          row[s].load(p);
          vl[s] = left ? to_f32(p[-1]) : 0.f;
          vr[s] = right ? to_f32(p[2 * VEC + 1]) : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= n) break;
        const int s = r + D + 1;
        if (s <= R + 1 && y0 + s - 1 < H) {
          const T* p = f + 2LL * (s - 1) * W;
          row[s].load(p);
          vl[s] = left ? to_f32(p[-1]) : 0.f;
          vr[s] = right ? to_f32(p[2 * VEC + 1]) : 0.f;
        }
        float res[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float gu = fdt(row[r][2 * k], row[r + 1][2 * k],
                               row[r + 2][2 * k], y0 + r, H);
          const float vm = k > 0 ? row[r + 1][2 * k - 1] : vl[r + 1];
          const float vp = k + 1 < VEC ? row[r + 1][2 * k + 3] : vr[r + 1];
          const float gv = fdt(vm, row[r + 1][2 * k + 1], vp, x0 + k, W);
          res[k] = gu - gv;
        }
        store_run<T, VEC>(o + (long long)r * W, res);
      }
    }
  }
}

template <int R, int D, typename T>
void march(const T* in, T* out, long long batch, int H, int W, bool vec,
           bool bwd, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const Tiles t = row_tiles(batch, H, W, vec ? V : 1, R);
  if (bwd && vec) {
    curl2d_bwd_march_kernel<T, V, R, D><<<t.grid, t.block, 0, s>>>(
        in, out, batch, H, W);
  } else if (bwd) {
    curl2d_bwd_march_kernel<T, 1, R, D><<<t.grid, t.block, 0, s>>>(
        in, out, batch, H, W);
  } else if (vec) {
    curl2d_march_kernel<T, V, R, D><<<t.grid, t.block, 0, s>>>(
        in, out, batch, H, W);
  } else {
    curl2d_march_kernel<T, 1, R, D><<<t.grid, t.block, 0, s>>>(
        in, out, batch, H, W);
  }
}

template <typename T>
int variant(const T* in, T* out, long long batch, int H, int W, bool bwd,
            int rows, int dist, bool vec, cudaStream_t s) {
#define TILE(R)                                                  \
  if (dist == 0 && rows == R) {                                  \
    if (bwd) launch_curl2d_bwd<R>(in, out, batch, H, W, vec, s); \
    else launch_curl2d<R>(in, out, batch, H, W, vec, s);         \
    return 0;                                                    \
  }
#define MARCH(R, D)                                              \
  if (dist == D && rows == R) {                                  \
    march<R, D>(in, out, batch, H, W, vec, bwd, s);              \
    return 0;                                                    \
  }
  TILE(1) TILE(2) TILE(4) TILE(8) TILE(16)
  MARCH(8, 1) MARCH(16, 1) MARCH(8, 2) MARCH(16, 2) MARCH(32, 2)
  MARCH(16, 4) MARCH(32, 4)
#undef TILE
#undef MARCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The curl (bwd 0) or its transpose (bwd 1) over tiles of rows rows,
// preloaded (dist 0) or marched dist rows ahead, in 16-byte runs (vec 1:
// W a multiple of them and both tensors 16-byte aligned) or runs of one
// point.  dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a variant not built.
extern "C" int tile_curl2d(const void* in, void* out, long long batch, int H,
                           int W, int dtype, int bwd, int rows, int dist,
                           int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = variant(static_cast<const float*>(in), static_cast<float*>(out),
                 batch, H, W, bwd, rows, dist, vec, s);
  } else if (dtype == 1) {
    rc = variant(static_cast<const __nv_bfloat16*>(in),
                 static_cast<__nv_bfloat16*>(out), batch, H, W, bwd, rows,
                 dist, vec, s);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  return rc != 0 ? rc : (int)cudaGetLastError();
}
