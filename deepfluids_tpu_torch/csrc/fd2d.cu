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
// 12-28 bytes moved (f32): at B = 512 and 128x96 a call moves 75-176 MB.
// The TPU versions transposed to NCHW and built the edges with rolls and
// masks only because Mosaic cannot lower sub-tile concatenates; none of
// that carries over.
//
// One thread a point spent more instructions on its own index (a 64-bit
// division and modulo) and on narrow accesses than on the bytes.  So all
// four run over row tiles: a thread owns a run of VEC consecutive points of
// a row in each of R consecutive rows.  It loads the tile's rows and the
// halo rows the y-stencil needs, each once and before its first store,
// keeps them in registers, and takes a neighbour along x outside the run
// with one load that L1 serves (the next thread reads that line).  The
// transposed stencil (fdt) reads the point after only at the second last,
// so the jacobian's transpose loads the row below a tile, and the point
// after a run, only there.  (b, y, x0) come from blockIdx / threadIdx in
// 32-bit arithmetic without a division; only the offsets are 64-bit.  R
// and VEC are the fastest that tools/curl_tiles.py and
// tools/jacobian_tiles.py measured on the H100 (PERF.md, constants below):
//
//   curl                 R = 1, VEC = 16 / sizeof(T): 16 bytes of psi
//   curl's transpose     R = 2, the same, from 2^18 x sizeof(T) points on
//   jacobian             R = 2, VEC = 4 / sizeof(T): 16 bytes of J
//   jacobian's transpose R = 2, VEC = 2, from 2^18 x sizeof(T) points on
//
// Where W is no multiple of VEC, the storage is not 16-byte aligned, or (a
// transpose) the launch is small, the same kernel runs with VEC = 1.  The
// arithmetic, and so every f32 bit, is the plain versions'.  Without the
// vorticity's cotangent (the training loss uses J alone) the jacobian's
// transpose reads J's alone: 6 channels a point, not 7.

#include <algorithm>
#include <cstdint>

#include "fd_common.cuh"

namespace {

// --- row tiles -------------------------------------------------------------

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
// The jacobian (#2) and its transpose (#4), measured the same way
// (tools/jacobian_tiles.py): tiles of 2 rows, and runs of the points that
// keep a warp's stores in whole 32-byte sectors.  Runs of 16 bytes of each
// channel (4 points in f32) lose: a lane then writes J 16 bytes at a time
// 64 bytes apart, so each store instruction writes half of every sector it
// touches.  The jacobian's run holds one 16-byte vector of J (a point in
// f32, two in bf16), its transpose's two points (one 16-byte vector of the
// output in f32), from the curl's transpose's threshold on; below, one
// point.
constexpr int kJacRows = 2;
constexpr int kJacBwdRows = 2;
template <typename T>
constexpr int kJacVec = 4 / sizeof(T);
constexpr int kJacBwdVec = 2;

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

// --- the jacobian and its transpose over row tiles --------------------------

// One row of a run of the jacobian: from (u, v) of the run in rows y and
// y + 1 (or y - 1 and y, the field's last row) and at xn, the neighbour
// past the run, J = (du/dx, du/dy, dv/dx, dv/dy) and w = dv/dx - du/dy
// stored at jac and vort (the run's first point).
template <typename T, int VEC>
__device__ __forceinline__ void jacobian_row(const Run<T, 2 * VEC>& lo,
                                             const Run<T, 2 * VEC>& hi,
                                             const Run<T, 2 * VEC>& c,
                                             const Run<T, 2>& nb, int x0,
                                             int W, T* jac, T* vort) {
  float j[4 * VEC], w[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    float dx[2];
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      const float v = c[2 * k + ch];
      dx[ch] = x0 + k + 1 < W
                   ? (k + 1 < VEC ? c[2 * k + 2 + ch] : nb[ch]) - v
                   : v - (k > 0 ? c[2 * k - 2 + ch] : nb[ch]);
    }
    const float dudy = hi[2 * k] - lo[2 * k];
    const float dvdy = hi[2 * k + 1] - lo[2 * k + 1];
    j[4 * k] = dx[0];
    j[4 * k + 1] = dudy;
    j[4 * k + 2] = dx[1];
    j[4 * k + 3] = dvdy;
    w[k] = dx[1] - dudy;                 // f32, rounded once
  }
  store_run<T, 4 * VEC>(jac, j);
  store_run<T, VEC>(vort, w);
}

// vel [B, H, W, 2] -> J [B, H, W, 4], w [B, H, W, 1].
template <typename T, int VEC, int R>
__global__ void __launch_bounds__(kThreads)
jacobian2d_kernel(const T* __restrict__ vel, T* __restrict__ jac,
                  T* __restrict__ vort, long long batch, int H, int W) {
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (x0 >= W) return;
  // The neighbour the run's last x-difference needs, as in curl2d_kernel.
  const int xn = x0 + VEC < W ? x0 + VEC : (VEC == 1 ? x0 - 1 : -1);
  const long long plane = (long long)H * W;
  const int ystep = gridDim.y * blockDim.y * R;
  for (long long b = blockIdx.z; b < batch; b += gridDim.z) {
    for (int y0 = (blockIdx.y * blockDim.y + threadIdx.y) * R; y0 < H;
         y0 += ystep) {
      const long long p = b * plane + (long long)y0 * W;   // point (b, y0, 0)
      const T* f = vel + 2 * p;
      // Rows y0 .. y0 + R (the last is the halo below the tile), those the
      // field has: n of them.
      const int n = min(R + 1, H - y0);
      Run<T, 2 * VEC> row[R + 1];
      Run<T, 2> nb[R + 1] = {};                          // (u, v) at xn
#pragma unroll
      for (int r = 0; r <= R; ++r) {
        if (r < n) {
          row[r].load(f + 2LL * (r * W + x0));
          if (xn >= 0) nb[r].load(f + 2LL * (r * W + xn));
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= n) break;
        T* jr = jac + 4 * (p + (long long)r * W + x0);
        T* wr = vort + p + (long long)r * W + x0;
        if (r + 1 < n) {
          jacobian_row<T, VEC>(row[r], row[r + 1], row[r], nb[r], x0, W, jr,
                               wr);
        } else if (r > 0) {
          // The field's last row repeats the difference of the one before.
          jacobian_row<T, VEC>(row[r - 1], row[r], row[r], nb[r], x0, W, jr,
                               wr);
        } else {
          // A tile of the field's last row alone reads the row above.
          Run<T, 2 * VEC> up;
          up.load(f - 2LL * (W - x0));
          jacobian_row<T, VEC>(up, row[0], row[0], nb[0], x0, W, jr, wr);
        }
      }
    }
  }
}

// One row y of a run of the transpose: from J's cotangent of the run in
// rows y - 1, y and y + 1 (ym, c, yp) and at x0 - 1 and x0 + VEC (xm, xp),
// and the vorticity's likewise (wym .. wxp, read only with kVort),
//   u_bar = fdt_x(J0) + fdt_y(J1) - fdt_y(w_bar)
//   v_bar = fdt_x(J2) + fdt_y(J3) + fdt_x(w_bar)
// stored at out (the run's first point), in the plain version's order.
// Without kVort the w_bar terms are left out: the same up to the sign of
// an exact zero.
template <typename T, int VEC, bool kVort>
__device__ __forceinline__ void jacobian_bwd_row(
    const Run<T, 4 * VEC>& ym, const Run<T, 4 * VEC>& c,
    const Run<T, 4 * VEC>& yp, const Run<T, 4>& xm, const Run<T, 4>& xp,
    const Run<T, VEC>& wym, const Run<T, VEC>& wc, const Run<T, VEC>& wyp,
    const Run<T, 1>& wxm, const Run<T, 1>& wxp, int x0, int y, int H, int W,
    T* out) {
  float res[2 * VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int x = x0 + k;
    float uv[2];
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {        // (J0, J1) for u, (J2, J3) for v
      const int a = 2 * ch, e = 4 * k + a;
      const float m = k > 0 ? c[e - 4] : xm[a];
      const float q = k + 1 < VEC ? c[e + 4] : xp[a];
      uv[ch] = fdt_sel(m, c[e], q, x, W) +
               fdt_sel(ym[e + 1], c[e + 1], yp[e + 1], y, H);
    }
    if constexpr (kVort) {
      const float m = k > 0 ? wc[k - 1] : wxm[0];
      const float q = k + 1 < VEC ? wc[k + 1] : wxp[0];
      uv[0] = uv[0] - fdt_sel(wym[k], wc[k], wyp[k], y, H);
      uv[1] = uv[1] + fdt_sel(m, wc[k], q, x, W);
    }
    res[2 * k] = uv[0];
    res[2 * k + 1] = uv[1];
  }
  store_run<T, 2 * VEC>(out, res);
}

// gj [B, H, W, 4] and gw [B, H, W, 1] (kVort; else unread, may be null)
// -> out [B, H, W, 2].
template <typename T, int VEC, int R, bool kVort>
__global__ void __launch_bounds__(kThreads)
jacobian2d_bwd_kernel(const T* __restrict__ gj, const T* __restrict__ gw,
                      T* __restrict__ out, long long batch, int H, int W) {
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (x0 >= W) return;
  // fdt reads the point before each and, at W - 2 only, the one after: a
  // run of several points never ends there (W is a multiple of VEC).
  const bool left = x0 > 0, right = VEC == 1 && x0 == W - 2;
  const long long plane = (long long)H * W;
  const int ystep = gridDim.y * blockDim.y * R;
  for (long long b = blockIdx.z; b < batch; b += gridDim.z) {
    for (int y0 = (blockIdx.y * blockDim.y + threadIdx.y) * R; y0 < H;
         y0 += ystep) {
      const long long p = b * plane + (long long)y0 * W + x0;  // (b, y0, x0)
      const T* fj = gj + 4 * p;
      const T* fw = kVort ? gw + p : nullptr;
      const int n = min(R, H - y0);                     // the tile's rows
      // jr[r + 1], wr[r + 1]: row y0 + r, r = -1 .. R: the row above the
      // tile, the tile, and the row below it where fdt reads one (after
      // row H - 2).  Rows not read stay 0.
      Run<T, 4 * VEC> jr[R + 2] = {};
      Run<T, VEC> wr[R + 2] = {};
      // J and w at x0 - 1 and x0 + VEC, row y0 + r.
      Run<T, 4> jxm[R] = {}, jxp[R] = {};
      Run<T, 1> wxm[R] = {}, wxp[R] = {};
#pragma unroll
      for (int r = -1; r <= R; ++r) {
        if (r < 0 ? y0 > 0 : r < R ? r < n : y0 + R == H - 1) {
          jr[r + 1].load(fj + 4LL * r * W);
          if constexpr (kVort) wr[r + 1].load(fw + (long long)r * W);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= n) break;
        if (left) {
          jxm[r].load(fj + 4LL * r * W - 4);
          if constexpr (kVort) wxm[r].load(fw + (long long)r * W - 1);
        }
        if (right) {
          jxp[r].load(fj + 4LL * r * W + 4 * VEC);
          if constexpr (kVort) wxp[r].load(fw + (long long)r * W + VEC);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= n) break;
        jacobian_bwd_row<T, VEC, kVort>(
            jr[r], jr[r + 1], jr[r + 2], jxm[r], jxp[r], wr[r], wr[r + 1],
            wr[r + 2], wxm[r], wxp[r], x0, y0 + r, H, W,
            out + 2 * (p + (long long)r * W));
      }
    }
  }
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

// Whether runs of V points can be taken: W a multiple of V and every
// tensor 16-byte aligned (a null one, not read, is).  A run of one point
// always can (the wrappers align storage to a point).
template <int V, typename... P>
bool runs_fit(int W, const P*... ptrs) {
  return V == 1 || (W % V == 0 &&
                    ((reinterpret_cast<uintptr_t>(ptrs) % 16 == 0) && ...));
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
                           batch, H, W, runs_fit<16 / sizeof(T)>(W, psi, out),
                           s);
}

// The transpose over row tiles; 16-byte runs where they can be taken and
// the field holds enough points for them to pay.
template <typename T>
void curl2d_bwd(const void* g, void* out, long long batch, int H, int W,
                cudaStream_t s) {
  const bool vec = runs_fit<16 / sizeof(T)>(W, g, out) &&
                   batch * H * W >=
                       kBwdVectorPointsPerByte * (long long)sizeof(T);
  launch_curl2d_bwd<kCurlBwdRows>(static_cast<const T*>(g),
                                  static_cast<T*>(out), batch, H, W, vec, s);
}

// The jacobian over tiles of R rows in runs of V points.
template <int R, int V, typename T>
void launch_jacobian2d(const T* vel, T* jac, T* vort, long long batch, int H,
                       int W, cudaStream_t s) {
  const Tiles t = row_tiles(batch, H, W, V, R);
  jacobian2d_kernel<T, V, R><<<t.grid, t.block, 0, s>>>(vel, jac, vort,
                                                         batch, H, W);
}

template <int R, int V, bool kVort, typename T>
void launch_jacobian2d_bwd(const T* gj, const T* gw, T* out, long long batch,
                           int H, int W, cudaStream_t s) {
  const Tiles t = row_tiles(batch, H, W, V, R);
  jacobian2d_bwd_kernel<T, V, R, kVort><<<t.grid, t.block, 0, s>>>(
      gj, gw, out, batch, H, W);
}

// The jacobian over row tiles; runs of kJacVec points where they fit.
template <typename T>
void jacobian2d(const void* vel, void* jac, void* vort, long long batch,
                int H, int W, cudaStream_t s) {
  constexpr int V = kJacVec<T>;
  const T* v = static_cast<const T*>(vel);
  T* j = static_cast<T*>(jac);
  T* w = static_cast<T*>(vort);
  if (runs_fit<V>(W, vel, jac, vort)) {
    launch_jacobian2d<kJacRows, V>(v, j, w, batch, H, W, s);
  } else {
    launch_jacobian2d<kJacRows, 1>(v, j, w, batch, H, W, s);
  }
}

template <bool kVort, typename T>
void jacobian2d_bwd_runs(const T* gj, const T* gw, T* out, long long batch,
                         int H, int W, cudaStream_t s) {
  constexpr int V = kJacBwdVec;
  if (runs_fit<V>(W, gj, gw, out) &&
      batch * H * W >= kBwdVectorPointsPerByte * (long long)sizeof(T)) {
    launch_jacobian2d_bwd<kJacBwdRows, V, kVort>(gj, gw, out, batch, H, W, s);
  } else {
    launch_jacobian2d_bwd<kJacBwdRows, 1, kVort>(gj, gw, out, batch, H, W, s);
  }
}

// The transpose over row tiles, reading the vorticity's cotangent only
// where there is one (gw not null); runs of kJacBwdVec points where they
// fit and the field holds enough points for them to pay.
template <typename T>
void jacobian2d_bwd(const void* gj, const void* gw, void* out,
                    long long batch, int H, int W, cudaStream_t s) {
  const T* j = static_cast<const T*>(gj);
  const T* w = static_cast<const T*>(gw);
  T* o = static_cast<T*>(out);
  if (w) {
    jacobian2d_bwd_runs<true>(j, w, o, batch, H, W, s);
  } else {
    jacobian2d_bwd_runs<false>(j, w, o, batch, H, W, s);
  }
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
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || batch * H * W == 0) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    jacobian2d<float>(vel, jac, vort, batch, H, W, s);
  } else if (dtype == 1) {
    jacobian2d<__nv_bfloat16>(vel, jac, vort, batch, H, W, s);
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

// gw may be null: no vorticity cotangent, J's alone.
extern "C" int df_jacobian2d_bwd(const void* gj, const void* gw, void* out,
                                 long long batch, int H, int W, int dtype,
                                 int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || batch * H * W == 0) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    jacobian2d_bwd<float>(gj, gw, out, batch, H, W, s);
  } else if (dtype == 1) {
    jacobian2d_bwd<__nv_bfloat16>(gj, gw, out, batch, H, W, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
