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
// 24 bytes, jacobian3d and jacobian3d_bwd 60 (jacobian3d_bwd 48 without a
// vorticity cotangent): at [32,32,64,112] a call moves 176 or 440 (352) MB.
//
// The forward kernels: one thread per point (b, z, y, x), a block per run
// of 256 points of one (b, z) plane with x fastest, so loads and stores of
// a warp cover one contiguous span and coalesce.  Channels 3 and 9 are no
// vector widths, so each channel is read as a scalar (jacobian3d stages its
// stores in shared memory, see there); the neighbours at x+-1, y+-1 and
// z+-1 (H*W points away) were or will be read by other threads, so they
// come from L1/L2 (50 MB) rather than device memory.  The grid is (B*D
// planes, chunks of a plane), so a thread finds its (x, y, z) with 32-bit
// arithmetic.
//
// The backward kernels read 27 (curl) and 45 (jacobian) neighbour values a
// point.  Read one thread a point from L1/L2, as the forward kernels do,
// they ran at 46-49 % of the bound: each z neighbour lies in another
// block's plane and came from L2 up to three times.  So a block owns a
// brick instead (one batch element, tz planes, ty rows, the full W; column
// tiles only where W is wider than a brick's plane) and marches along z,
// as the TPU versions walked z in a loop:
//   * a plane's staged rows y0-1 .. y0+ty-1 (and y0+ty only where fdt
//     reads it) are one contiguous span in the channels-last layout; the
//     block copies it into a shared-memory stage with 16-byte cp.async (a
//     cooperative element copy where the span's address or length is not
//     16-byte aligned), in a ring of two stages, so the next plane's copy
//     is in flight while this one is computed;
//   * x and y neighbours come from the stage; the z neighbours of a
//     block's own points are kept in a shared z window that each point's
//     thread alone reads and rewrites (fdt reads z-1 and z, and z+1 only
//     at z = D-2, which is read from memory).  Kept in registers instead,
//     unrolled over a thread's points, they cost 128 registers and spills;
//   * jacobian3d_bwd folds the vorticity cotangent into J's once per staged
//     element, in f32, into a second shared buffer; without a vorticity
//     cotangent (the training loss uses J only) it reads J's alone, 12
//     channels a point instead of 15;
//   * outputs are staged in shared memory and written as one contiguous run
//     a plane, with 16-byte stores;
//   * fdt's edge cases are selected, not branched on, and the z = D-2 plane
//     has its own loop: with bytes halved, bf16 is bound by the
//     instructions a point (about as many as f32), not by memory.
// Each input element leaves device memory once; the halo row (1/ty) and
// the z channels of the plane before a brick (1/tz) are read again, mostly
// from L2.  The operations run in the order of the plain versions, so f32
// results match them bit for bit.

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>

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

// ---- The backward kernels: bricks marching along z ------------------------

constexpr int kBwdThreads = 256;                   // threads of a block
constexpr int kBwdTile = 1024;                     // points of a brick plane
constexpr int kBwdRows = 8;                        // ty at most
constexpr int kBwdPlanes = 8;                      // tz at most
constexpr int kStages = 2;                         // ring of plane stages
// Shared memory a block may take, so that two blocks fit an SM (228 KB,
// 1 KB of it reserved per block).
constexpr int kBwdSmem = 113 * 1024;

// The bricks of a launch: the extents, a brick's planes tz, rows ty and
// columns tx, and the number of bricks along z, y and x.
struct Tiling {
  int D, H, W;
  int tz, ty, tx;
  int nz, ny, nx;
};

__host__ __device__ inline int round16(int bytes) {
  return (bytes + 15) & ~15;
}

// Byte offsets in a backward block's shared memory: kStages stages of one
// plane's staged points (the second input's slot at `second` in each), the
// six folded in-plane entries of jacobian3d_bwd in f32, the z window (the
// `zc` entries differenced along z of the own points' plane before, f32)
// and one plane of outputs.  Every slot starts 16-byte aligned.
struct Smem {
  int second, stage, fold, zwin, out, total;
};

__host__ __device__ inline Smem smem_layout(const Tiling& t, int elt, int c0,
                                            int c1, bool fold, int zc) {
  const int points = (t.ty + 2 < t.H ? t.ty + 2 : t.H) *
                     (t.tx + 2 < t.W ? t.tx + 2 : t.W);
  const int own = t.ty * t.tx;
  Smem m;
  m.second = round16(points * c0 * elt);
  m.stage = m.second + round16(points * c1 * elt);
  m.fold = kStages * m.stage;
  m.zwin = m.fold + (fold ? round16(6 * points * 4) : 0);
  m.out = m.zwin + round16(own * zc * 4);
  m.total = m.out + round16(own * 3 * elt);
  return m;
}

// This block's brick: batch element b; own planes z0.., rows y0.. and
// columns x0.. (nzo, nyo, nxo of them); and the staged rows ys.. and
// columns xs.. of a plane (nr, nc of them): the own ones, the one before,
// and the one after only where the last own one is the axis' second last
// (fdt reads d[n-1] there and nowhere else).  Bricks are numbered x
// fastest, then y, so neighbours along y run together and share their
// halo rows in L2.
struct Brick {
  int b, z0, y0, x0, nzo, nyo, nxo;
  int ys, xs, nr, nc;
};

__device__ __forceinline__ Brick brick(const Tiling& t) {
  unsigned id = blockIdx.x;
  const int xb = id % t.nx;
  id /= t.nx;
  const int yb = id % t.ny;
  id /= t.ny;
  const int zb = id % t.nz;
  Brick bk;
  bk.b = id / t.nz;
  bk.z0 = zb * t.tz;
  bk.nzo = min(t.tz, t.D - bk.z0);
  bk.y0 = yb * t.ty;
  bk.nyo = min(t.ty, t.H - bk.y0);
  bk.x0 = xb * t.tx;
  bk.nxo = min(t.tx, t.W - bk.x0);
  const int ylast = bk.y0 + bk.nyo - 1, xlast = bk.x0 + bk.nxo - 1;
  bk.ys = max(bk.y0 - 1, 0);
  bk.nr = ylast + (ylast == t.H - 2) - bk.ys + 1;
  bk.xs = max(bk.x0 - 1, 0);
  bk.nc = xlast + (xlast == t.W - 2) - bk.xs + 1;
  return bk;
}

// Flat index ((b*D + z)*H + y)*W + x of a point.
__device__ __forceinline__ long long point(const Tiling& t, int b, int z,
                                           int y, int x) {
  return (((long long)b * t.D + z) * t.H + y) * t.W + x;
}

// The own points q = threadIdx.x, threadIdx.x + kBwdThreads, ... of the
// brick's plane (rows of nxo points, q < nyo * nxo), walked without a
// division a point: q, its (x, y) and its index s in the stage.  Point q
// is handled by the same thread in every plane, which alone reads and
// writes its z window.
struct Own {
  int q, x, y, s;
  int dx, dy;   // the step in columns and rows of kBwdThreads points

  __device__ __forceinline__ explicit Own(const Brick& bk) {
    q = threadIdx.x;
    dy = kBwdThreads / bk.nxo;
    dx = kBwdThreads - dy * bk.nxo;
    const int r = q / bk.nxo;
    y = bk.y0 + r;
    x = bk.x0 + (q - r * bk.nxo);
    s = (y - bk.ys) * bk.nc + (x - bk.xs);
  }

  __device__ __forceinline__ void next(const Brick& bk) {
    q += kBwdThreads;
    x += dx;
    y += dy;
    s += dy * bk.nc + dx;
    if (x >= bk.x0 + bk.nxo) {
      x -= bk.nxo;
      ++y;
      s += bk.nc - bk.nxo;
    }
  }
};

// The offsets of a point's neighbours before (m) and after (p) it along an
// axis of extent n at index j, `stride` apart: 0 where fdt reads none
// (before the first, after any but the second last).
struct Nbr {
  int m, p;
};

__device__ __forceinline__ Nbr nbr(int j, int n, int stride) {
  return {j > 0 ? -stride : 0, j == n - 2 ? stride : 0};
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for all but the newest kStages - 1 groups of copies.
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b,
                                          int bytes) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           static_cast<uintptr_t>(bytes)) & 15) == 0;
}

// n elements from global g to shared s, by the whole block: 16-byte
// cp.async where both addresses and the length are 16-byte aligned, else a
// cooperative element copy (synchronous, done when the block next syncs).
template <typename T>
__device__ __forceinline__ void load_span(T* s, const T* g, int n) {
  const int bytes = n * (int)sizeof(T);
  if (aligned16(s, g, bytes)) {
    char* sc = reinterpret_cast<char*>(s);
    const char* gc = reinterpret_cast<const char*>(g);
    for (int i = 16 * threadIdx.x; i < bytes; i += 16 * kBwdThreads) {
      cp_async16(sc + i, gc + i);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kBwdThreads) s[i] = g[i];
  }
}

// n elements from shared s to global g, by the whole block: 16-byte stores
// where aligned as above, else element by element (coalesced either way).
template <typename T>
__device__ __forceinline__ void store_span(T* g, const T* s, int n) {
  const int bytes = n * (int)sizeof(T);
  if (aligned16(g, s, bytes)) {
    uint4* gv = reinterpret_cast<uint4*>(g);
    const uint4* sv = reinterpret_cast<const uint4*>(s);
    for (int i = threadIdx.x; i < bytes / 16; i += kBwdThreads) gv[i] = sv[i];
  } else {
    for (int i = threadIdx.x; i < n; i += kBwdThreads) g[i] = s[i];
  }
}

// The staged rows and columns of plane z of a [B, D, H, W, C] tensor into
// stage s (nr rows of nc points); whole rows are one contiguous span.
template <int C, typename T>
__device__ __forceinline__ void load_plane(T* s, const T* g, const Tiling& t,
                                           const Brick& bk, int z) {
  const long long p0 = point(t, bk.b, z, bk.ys, bk.xs);
  if (bk.nc == t.W) {
    load_span(s, g + p0 * C, bk.nr * t.W * C);
  } else {
    for (int r = 0; r < bk.nr; ++r) {
      load_span(s + r * bk.nc * C, g + (p0 + (long long)r * t.W) * C,
                bk.nc * C);
    }
  }
}

// The brick's outputs of plane z (3 channels, rows of nxo points) from
// shared s to out; whole rows are one contiguous run.
template <typename T>
__device__ __forceinline__ void store_plane(T* out, const T* s,
                                            const Tiling& t, const Brick& bk,
                                            int z) {
  const long long p0 = point(t, bk.b, z, bk.y0, bk.x0);
  if (bk.nxo == t.W) {
    store_span(out + p0 * 3, s, bk.nyo * t.W * 3);
  } else {
    for (int r = 0; r < bk.nyo; ++r) {
      store_span(out + (p0 + (long long)r * t.W) * 3, s + r * bk.nxo * 3,
                 bk.nxo * 3);
    }
  }
}

// The own points of plane z of curl3d_bwd: their outputs into so, from
// the stage st and the z window (u_bar, v_bar of the plane before, which
// each point's thread then overwrites with this plane's).  kNext: z = D-2,
// where fdt also reads plane z+1, from memory.
template <bool kNext, typename T>
__device__ __forceinline__ void curl_plane(
    const T* __restrict__ st, const T* __restrict__ g, T* __restrict__ so,
    float* __restrict__ zu, float* __restrict__ zv, const Tiling& t,
    const Brick& bk, int z) {
  const int own = bk.nyo * bk.nxo;
  for (Own o(bk); o.q < own; o.next(bk)) {
    const T* c = st + 3 * o.s;
    const Nbr ax = nbr(o.x, t.W, 3), ay = nbr(o.y, t.H, 3 * bk.nc);
    const float u = to_f32(c[0]), v = to_f32(c[1]), w = to_f32(c[2]);
    float nu = 0.f, nv = 0.f;
    if (kNext) {
      const long long e = 3 * point(t, bk.b, z + 1, o.y, o.x);
      nu = ld(g, e);
      nv = ld(g, e + 1);
    }
    const float fzu = fdt_sel(zu[o.q], u, nu, z, t.D);
    const float fzv = fdt_sel(zv[o.q], v, nv, z, t.D);
    const float fyw = fdt_sel(to_f32(c[ay.m + 2]), w, to_f32(c[ay.p + 2]),
                              o.y, t.H);
    const float fyu = fdt_sel(to_f32(c[ay.m]), u, to_f32(c[ay.p]), o.y, t.H);
    const float fxw = fdt_sel(to_f32(c[ax.m + 2]), w, to_f32(c[ax.p + 2]),
                              o.x, t.W);
    const float fxv = fdt_sel(to_f32(c[ax.m + 1]), v, to_f32(c[ax.p + 1]),
                              o.x, t.W);
    store1(so, 3 * o.q, fzv - fyw);
    store1(so, 3 * o.q + 1, fxw - fzu);
    store1(so, 3 * o.q + 2, fyu - fxv);
    zu[o.q] = u;
    zv[o.q] = v;
  }
}

// a_bar = fdt_z(v_bar) - fdt_y(w_bar)
// b_bar = fdt_x(w_bar) - fdt_z(u_bar)
// c_bar = fdt_y(u_bar) - fdt_x(v_bar)
// The z window is u_bar and v_bar at the own points.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    curl3d_bwd_kernel(const T* __restrict__ g, T* __restrict__ out,
                      Tiling t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem m = smem_layout(t, sizeof(T), 3, 0, false, 2);
  T* so = reinterpret_cast<T*>(smem + m.out);
  const Brick bk = brick(t);
  const int own = bk.nyo * bk.nxo;
  float* zu = reinterpret_cast<float*>(smem + m.zwin);   // u_bar, v_bar of
  float* zv = zu + own;                                  // the plane before
  for (Own o(bk); o.q < own; o.next(bk)) {
    float u = 0.f, v = 0.f;   // no plane before z = 0, and fdt reads none
    if (bk.z0 > 0) {
      const long long e = 3 * point(t, bk.b, bk.z0 - 1, o.y, o.x);
      u = ld(g, e);
      v = ld(g, e + 1);
    }
    zu[o.q] = u;
    zv[o.q] = v;
  }
  // Iteration i stages plane z0 + i and computes plane z0 + p, p = i -
  // (kStages - 1): kStages - 1 planes are in flight while one is computed.
  for (int i = 0; i < bk.nzo + kStages - 1; ++i) {
    if (i < bk.nzo) {
      load_plane<3>(reinterpret_cast<T*>(smem + (i % kStages) * m.stage), g,
                    t, bk, bk.z0 + i);
    }
    cp_async_commit();
    const int p = i - (kStages - 1), z = bk.z0 + p;
    if (p < 0) continue;
    cp_async_wait_stage();
    __syncthreads();
    const T* st = reinterpret_cast<const T*>(smem + (p % kStages) * m.stage);
    if (z == t.D - 2) {
      curl_plane<true>(st, g, so, zu, zv, t, bk, z);
    } else {
      curl_plane<false>(st, g, so, zu, zv, t, bk, z);
    }
    __syncthreads();
    store_plane(out, so, t, bk, z);
  }
}

// Entries 2, 5 and 8 of J's cotangent (the ones differenced along z) at
// point e of J's and the vorticity's cotangents, with the vorticity's
// folded in: J2 + v1, J5 - v0, J8.
template <bool kVort, typename T>
__device__ __forceinline__ float3 z_entries(const T* gj, const T* gv,
                                            long long e) {
  float3 zc = make_float3(to_f32(gj[9 * e + 2]), to_f32(gj[9 * e + 5]),
                          to_f32(gj[9 * e + 8]));
  if (kVort) {
    zc.x = zc.x + to_f32(gv[3 * e + 1]);
    zc.y = zc.y - to_f32(gv[3 * e]);
  }
  return zc;
}

__device__ __forceinline__ float entry(float3 a, int i) {
  return i == 0 ? a.x : (i == 1 ? a.y : a.z);
}

// The own points of plane z of jacobian3d_bwd: their outputs into so,
// from the folded in-plane entries `fold` (np staged points a row), the z
// entries in the stage (sj, sv) and the z window zw (three rows of own
// points, overwritten with this plane's).  kNext: z = D-2, where fdt also
// reads plane z+1, from memory.
template <bool kNext, bool kVort, typename T>
__device__ __forceinline__ void jacobian_plane(
    const T* __restrict__ sj, const T* __restrict__ sv,
    const float* __restrict__ fold, int np, const T* __restrict__ gj,
    const T* __restrict__ gv, T* __restrict__ so, float* __restrict__ zw,
    const Tiling& t, const Brick& bk, int z) {
  const int own = bk.nyo * bk.nxo;
  for (Own o(bk); o.q < own; o.next(bk)) {
    const float3 zc = z_entries<kVort>(sj, sv, o.s);
    float3 zn = make_float3(0.f, 0.f, 0.f);
    if (kNext) {
      zn = z_entries<kVort>(gj, gv, point(t, bk.b, z + 1, o.y, o.x));
    }
    const Nbr ax = nbr(o.x, t.W, 1), ay = nbr(o.y, t.H, bk.nc);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float* fx = fold + 2 * ch * np + o.s;   // entry 3 ch
      const float* fy = fx + np;                    // entry 3 ch + 1
      float* zp = zw + ch * own + o.q;
      store1(so, 3 * o.q + ch,
             fdt_sel(fx[ax.m], fx[0], fx[ax.p], o.x, t.W) +
                 fdt_sel(fy[ay.m], fy[0], fy[ay.p], o.y, t.H) +
                 fdt_sel(*zp, entry(zc, ch), entry(zn, ch), z, t.D));
      *zp = entry(zc, ch);
    }
  }
}

// x_bar[k] = fdt_x(J[3k]) + fdt_y(J[3k+1]) + fdt_z(J[3k+2]), with the
// vorticity's cotangent folded into J's as ops/fd.py jacobian3d_bwd folds
// it: J7 += v0, J5 -= v0, J2 += v1, J6 -= v1, J3 += v2, J1 -= v2.  Without
// it (kVort false, gv unused) J's alone.  The z window is the folded J2,
// J5 and J8 at the own points.
template <typename T, bool kVort>
__global__ void __launch_bounds__(kBwdThreads)
    jacobian3d_bwd_kernel(const T* __restrict__ gj, const T* __restrict__ gv,
                          T* __restrict__ out, Tiling t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem m = smem_layout(t, sizeof(T), 9, kVort ? 3 : 0, true, 3);
  float* fold = reinterpret_cast<float*>(smem + m.fold);
  T* so = reinterpret_cast<T*>(smem + m.out);
  const Brick bk = brick(t);
  const int np = bk.nr * bk.nc;    // staged points of a plane
  const int own = bk.nyo * bk.nxo;
  float* zw = reinterpret_cast<float*>(smem + m.zwin);  // [3][own]: the z
  for (Own o(bk); o.q < own; o.next(bk)) {                // entries of the
    float3 zc = make_float3(0.f, 0.f, 0.f);               // plane before
    if (bk.z0 > 0) {
      zc = z_entries<kVort>(gj, gv, point(t, bk.b, bk.z0 - 1, o.y, o.x));
    }
    zw[o.q] = zc.x;
    zw[own + o.q] = zc.y;
    zw[2 * own + o.q] = zc.z;
  }
  // Iteration i stages plane z0 + i and computes plane z0 + p, as above.
  for (int i = 0; i < bk.nzo + kStages - 1; ++i) {
    if (i < bk.nzo) {
      unsigned char* st = smem + (i % kStages) * m.stage;
      load_plane<9>(reinterpret_cast<T*>(st), gj, t, bk, bk.z0 + i);
      if (kVort) {
        load_plane<3>(reinterpret_cast<T*>(st + m.second), gv, t, bk,
                      bk.z0 + i);
      }
    }
    cp_async_commit();
    const int p = i - (kStages - 1), z = bk.z0 + p;
    if (p < 0) continue;
    cp_async_wait_stage();
    __syncthreads();
    const unsigned char* st = smem + (p % kStages) * m.stage;
    const T* sj = reinterpret_cast<const T*>(st);
    const T* sv = reinterpret_cast<const T*>(st + m.second);
    // Fold the in-plane entries of every staged point once: fold[f*np + e]
    // is entry 0, 1, 3, 4, 6, 7 (f = 0 .. 5) of point e.
    for (int e = threadIdx.x; e < np; e += kBwdThreads) {
      const T* j = sj + 9 * e;
      float f1 = to_f32(j[1]), f3 = to_f32(j[3]);
      float f6 = to_f32(j[6]), f7 = to_f32(j[7]);
      if (kVort) {
        const T* v = sv + 3 * e;
        f7 = f7 + to_f32(v[0]);
        f6 = f6 - to_f32(v[1]);
        f3 = f3 + to_f32(v[2]);
        f1 = f1 - to_f32(v[2]);
      }
      fold[e] = to_f32(j[0]);
      fold[np + e] = f1;
      fold[2 * np + e] = f3;
      fold[3 * np + e] = to_f32(j[4]);
      fold[4 * np + e] = f6;
      fold[5 * np + e] = f7;
    }
    __syncthreads();
    if (z == t.D - 2) {
      jacobian_plane<true, kVort>(sj, sv, fold, np, gj, gv, so, zw, t, bk,
                                  z);
    } else {
      jacobian_plane<false, kVort>(sj, sv, fold, np, gj, gv, so, zw, t, bk,
                                   z);
    }
    __syncthreads();
    store_plane(out, so, t, bk, z);
  }
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

// The bricks of a backward launch: whole rows (tx = W) unless W is wider
// than kBwdTile points; as many rows as fit kBwdTile points, at most
// kBwdRows; rows (then columns) halved until the block's shared memory
// lets two blocks share an SM; kBwdPlanes planes, halved down to 2 while
// there are fewer than three bricks an SM.  Selects the device; *blocks is
// 0 when there is nothing to launch.
constexpr int kMaxDevices = 64;

cudaError_t bwd_tiling(int device, long long batch, int D, int H, int W,
                       int elt, int c0, int c1, bool fold, int zc, Tiling* t,
                       int* smem, unsigned* blocks) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  static std::atomic<int> sm_count[kMaxDevices];   // queried once a device
  int sms = sm_count[device].load();
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    sm_count[device].store(sms);
  }
  t->D = D;
  t->H = H;
  t->W = W;
  t->tx = W < kBwdTile ? W : kBwdTile;
  t->ty = std::min(std::min(kBwdRows, kBwdTile / t->tx), H);
  while (smem_layout(*t, elt, c0, c1, fold, zc).total > kBwdSmem) {
    if (t->ty > 1) {
      t->ty /= 2;
    } else {
      t->tx /= 2;
    }
  }
  t->ny = (H + t->ty - 1) / t->ty;
  t->nx = (W + t->tx - 1) / t->tx;
  t->tz = std::min(kBwdPlanes, D);
  long long count;
  for (;;) {
    t->nz = (D + t->tz - 1) / t->tz;
    count = batch * t->nz * t->ny * t->nx;
    if (t->tz <= 2 || count >= 3LL * sms) break;
    t->tz /= 2;
  }
  if (count > INT_MAX) return cudaErrorInvalidValue;
  *blocks = (unsigned)count;
  *smem = smem_layout(*t, elt, c0, c1, fold, zc).total;
  return cudaSuccess;
}

// Lets `Kernel` take kBwdSmem bytes of dynamic shared memory on `device`
// (above 48 KB it must be allowed), once a device.
template <auto Kernel>
cudaError_t allow_smem(int device) {
  static std::atomic<bool> allowed[kMaxDevices];
  if (allowed[device].load()) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
  if (err == cudaSuccess) allowed[device].store(true);
  return err;
}

template <typename T>
cudaError_t launch_curl3d_bwd(const void* g, void* out, long long batch,
                              int D, int H, int W, int device,
                              cudaStream_t s) {
  Tiling t;
  int smem;
  unsigned blocks;
  cudaError_t err = bwd_tiling(device, batch, D, H, W, sizeof(T), 3, 0,
                               false, 2, &t, &smem, &blocks);
  if (err != cudaSuccess || blocks == 0) return err;
  err = allow_smem<curl3d_bwd_kernel<T>>(device);
  if (err != cudaSuccess) return err;
  curl3d_bwd_kernel<T><<<blocks, kBwdThreads, smem, s>>>(
      static_cast<const T*>(g), static_cast<T*>(out), t);
  return cudaGetLastError();
}

template <typename T, bool kVort>
cudaError_t launch_jacobian3d_bwd(const void* gj, const void* gv, void* out,
                                  long long batch, int D, int H, int W,
                                  int device, cudaStream_t s) {
  Tiling t;
  int smem;
  unsigned blocks;
  cudaError_t err = bwd_tiling(device, batch, D, H, W, sizeof(T), 9,
                               kVort ? 3 : 0, true, 3, &t, &smem, &blocks);
  if (err != cudaSuccess || blocks == 0) return err;
  err = allow_smem<jacobian3d_bwd_kernel<T, kVort>>(device);
  if (err != cudaSuccess) return err;
  jacobian3d_bwd_kernel<T, kVort><<<blocks, kBwdThreads, smem, s>>>(
      static_cast<const T*>(gj), static_cast<const T*>(gv),
      static_cast<T*>(out), t);
  return cudaGetLastError();
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch_curl3d_bwd<float>(g, out, batch, D, H, W, device, s);
  }
  if (dtype == 1) {
    return (int)launch_curl3d_bwd<__nv_bfloat16>(g, out, batch, D, H, W,
                                                 device, s);
  }
  return (int)cudaErrorInvalidValue;
}

// gv may be null: no vorticity cotangent, J's alone.
extern "C" int df_jacobian3d_bwd(const void* gj, const void* gv, void* out,
                                 long long batch, int D, int H, int W,
                                 int dtype, int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)(gv ? launch_jacobian3d_bwd<float, true>(
                          gj, gv, out, batch, D, H, W, device, s)
                    : launch_jacobian3d_bwd<float, false>(
                          gj, gv, out, batch, D, H, W, device, s));
  }
  if (dtype == 1) {
    return (int)(gv ? launch_jacobian3d_bwd<__nv_bfloat16, true>(
                          gj, gv, out, batch, D, H, W, device, s)
                    : launch_jacobian3d_bwd<__nv_bfloat16, false>(
                          gj, gv, out, batch, D, H, W, device, s));
  }
  return (int)cudaErrorInvalidValue;
}
