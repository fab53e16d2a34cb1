// The conv stack's epilogue, written by hand for Hopper (sm_90a):
//
//   df_bias_leaky_relu_fwd  y  = leaky_relu(c + bias)
//   df_leaky_relu_bwd       dx = y >= 0 ? g : g * slope
//
// It replaces no Pallas kernel: in deepfluids_tpu XLA fuses the bias add and
// jax.nn.leaky_relu into the convolution's output.  Here cuDNN's convolution
// writes the map, aten's add_ adds the bias in a second pass over it (a
// broadcast along the innermost, channel, index that it does not
// vectorise), F.leaky_relu reads and writes it a third time, and the
// backward's torch.where(x >= 0, g, g * slope) is two kernels and six
// passes.  These two kernels take one pass each.
//
// The rounding is aten's: in float, rounded to the map's dtype after the add
// and again after the leaky step,
//
//   t = round(c + b);  y = t > 0 ? t : round(t * slope)
//
// so on the card the forward is bit-equal to add_ followed by F.leaky_relu
// (at t = +-0 both branches give t).  The backward takes its branch from the
// saved output: with a positive slope y has the pre-activation's sign, and
// y >= 0 holds at 0 and at -0.0, where the gradient is 1 as
// jax.nn.leaky_relu's.
//
// Layouts: the channel is the innermost index of a channels-last map (NHWC,
// NDHWC: channel = i % C), and (i / spatial) % C of a contiguous NC(D)HW
// one (a row-sharded map, a map gathered over channel shards).  The
// backward is elementwise: y, g and dx share one layout, whichever it is.
//
// What bounds them: memory.  A few flops an element against 2 + 2 bytes
// (bf16) read and written by the forward, 3 x 2 by the backward; at 3.35
// TB/s the sweep's [512, 128, 96, 128] bf16 map (1.61 GB each way) takes
// 0.96 ms forward.  So each thread moves 16-byte vectors (8 bf16 or 4 f32
// channels of one pixel, or of one channel's row in NC(D)HW), kUnroll of
// them in flight before its first store, over a grid-stride loop of a few
// waves of the SMs.  In channels-last, where C / VEC divides the stride (C
// = 128: 16 or 32), a thread's vectors always start at the same channel and
// its VEC biases stay in registers; otherwise, and in NC(D)HW, a vector's
// biases are cached loads.
// Where C (channels-last), the spatial size (NC(D)HW) or the element count
// (the backward) is no multiple of VEC, or a pointer is not 16-byte
// aligned, the same loop runs one element at a time.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
// Blocks a launch at most: kWaves x those the SMs hold at once.  On an H100
// SXM, of 1, 2, 4, 8 and 64 waves with 1, 2, 4 and 8 vectors in flight, 8
// waves of 4 was within 3 % of the fastest on every bf16 map timed (the
// sweep's and the 3D step's largest, [8, 128, 64, 48], [512, 128, 32, 24]);
// 64 waves lost 15-45 % on the two smaller.
constexpr int kWaves = 8;

// One element type: its 16-byte vector, and a float rounded to it.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  __device__ static __forceinline__ float get(const float* p, long long i) {
    return p[i];
  }
  __device__ static __forceinline__ void put(float* p, long long i, float v) {
    p[i] = v;
  }
  __device__ static __forceinline__ float round(float v) { return v; }
  __device__ static __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static __forceinline__ float get(const __nv_bfloat16* p,
                                              long long i) {
    return __bfloat162float(p[i]);
  }
  __device__ static __forceinline__ void put(__nv_bfloat16* p, long long i,
                                             float v) {
    p[i] = __float2bfloat16_rn(v);
  }
  __device__ static __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  // A bf16 is the high half of the f32 of the same value.
  __device__ static __forceinline__ void unpack2(unsigned w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static __forceinline__ unsigned pack2(float a, float b) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
  }
  __device__ static __forceinline__ void unpack(const uint4& u, float* f) {
    unpack2(u.x, f);
    unpack2(u.y, f + 2);
    unpack2(u.z, f + 4);
    unpack2(u.w, f + 6);
  }
  __device__ static __forceinline__ uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                      pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
};

template <typename T>
__device__ __forceinline__ float bias_leaky(float c, float b, float slope) {
  const float t = Elem<T>::round(c + b);
  return t > 0.0f ? t : Elem<T>::round(t * slope);
}

template <typename T>
__device__ __forceinline__ float leaky_grad(float y, float g, float slope) {
  return y >= 0.0f ? g : Elem<T>::round(g * slope);
}

// Forward over 16-byte vectors.  channels_last: vector v holds channels
// (v % groups) * VEC .. + VEC - 1 of one pixel (groups = C / VEC); else it
// lies in channel (v / groups) % C (groups = spatial / VEC).
template <typename T>
__global__ void __launch_bounds__(kThreads)
bias_leaky_relu_fwd_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                           T* __restrict__ y, long long nvec, long long groups,
                           int C, int channels_last, float slope) {
  constexpr int V = Elem<T>::kVec;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  // channels-last with a stride of whole pixels: this thread's biases once
  const bool fixed = channels_last && stride % groups == 0;
  float bv[V];
  if (fixed) {
    const long long c0 = (first % groups) * V;
#pragma unroll
    for (int k = 0; k < V; ++k) bv[k] = Elem<T>::get(bias, c0 + k);
  }
  for (long long v0 = first; v0 < nvec; v0 += stride * kUnroll) {
    uint4 in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * stride;
      if (v < nvec) in[u] = xv[v];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * stride;
      if (v >= nvec) break;
      float f[V];
      Elem<T>::unpack(in[u], f);
      if (fixed) {
#pragma unroll
        for (int k = 0; k < V; ++k) f[k] = bias_leaky<T>(f[k], bv[k], slope);
      } else if (channels_last) {
        const long long c0 = (v % groups) * V;
#pragma unroll
        for (int k = 0; k < V; ++k)
          f[k] = bias_leaky<T>(f[k], Elem<T>::get(bias, c0 + k), slope);
      } else {
        const float b = Elem<T>::get(bias, (v / groups) % C);
#pragma unroll
        for (int k = 0; k < V; ++k) f[k] = bias_leaky<T>(f[k], b, slope);
      }
      yv[v] = Elem<T>::pack(f);
    }
  }
}

// Forward one element at a time: channel (i / spatial) % C, spatial 1 in
// channels-last.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bias_leaky_relu_fwd_scalar_kernel(const T* __restrict__ x,
                                  const T* __restrict__ bias,
                                  T* __restrict__ y, long long n,
                                  long long spatial, int C, float slope) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float b = Elem<T>::get(bias, (i / spatial) % C);
    Elem<T>::put(y, i, bias_leaky<T>(Elem<T>::get(x, i), b, slope));
  }
}

// Backward: the first nvec * VEC elements as vectors (nvec = 0: none), the
// rest one at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads)
leaky_relu_bwd_kernel(const T* __restrict__ y, const T* __restrict__ g,
                      T* __restrict__ dx, long long n, long long nvec,
                      float slope) {
  constexpr int V = Elem<T>::kVec;
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  const uint4* gv = reinterpret_cast<const uint4*>(g);
  uint4* dv = reinterpret_cast<uint4*>(dx);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long v0 = first; v0 < nvec; v0 += stride * kUnroll) {
    uint4 ys[kUnroll], gs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * stride;
      if (v < nvec) {
        ys[u] = yv[v];
        gs[u] = gv[v];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * stride;
      if (v >= nvec) break;
      float fy[V], fg[V];
      Elem<T>::unpack(ys[u], fy);
      Elem<T>::unpack(gs[u], fg);
#pragma unroll
      for (int k = 0; k < V; ++k) fg[k] = leaky_grad<T>(fy[k], fg[k], slope);
      dv[v] = Elem<T>::pack(fg);
    }
  }
  for (long long i = nvec * V + first; i < n; i += stride)
    Elem<T>::put(dx, i, leaky_grad<T>(Elem<T>::get(y, i), Elem<T>::get(g, i),
                                      slope));
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// Blocks for `work` threads' worth of elements: at most kWaves waves of
// the blocks the SMs hold at once, and a multiple of 16 blocks, so the
// stride is a multiple of 4096 threads: of whole pixels wherever C / VEC
// divides 4096.
unsigned blocks_for(long long work, int device) {
  static int sms[64] = {0};
  const int d = device >= 0 && device < 64 ? device : 0;
  if (sms[d] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess || n <= 0)
      n = 132;
    sms[d] = n;
  }
  const long long most = (long long)sms[d] * (2048 / kThreads) * kWaves;
  long long b = (work + kThreads - 1) / kThreads;
  b = b < most ? b : most;
  b = (b + 15) / 16 * 16;
  return (unsigned)b;
}

template <typename T>
void fwd(const void* x, const void* bias, void* y, long long n, int C,
         long long spatial, int channels_last, float slope, int device,
         cudaStream_t s) {
  constexpr int V = Elem<T>::kVec;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bias);
  T* yt = static_cast<T*>(y);
  // the elements a vector may span: a pixel's channels, or one channel's
  // points
  const long long run = channels_last ? C : spatial;
  if (run % V == 0 && aligned16(x) && aligned16(y)) {
    const long long nvec = n / V;
    bias_leaky_relu_fwd_kernel<T><<<blocks_for(nvec, device), kThreads, 0, s>>>(
        xt, bt, yt, nvec, run / V, C, channels_last, slope);
  } else {
    // channel = (i / per) % C in both layouts: per is 1 in channels-last
    const long long per = channels_last ? 1 : spatial;
    bias_leaky_relu_fwd_scalar_kernel<T><<<blocks_for(n, device), kThreads, 0, s>>>(
        xt, bt, yt, n, per, C, slope);
  }
}

template <typename T>
void bwd(const void* y, const void* g, void* dx, long long n, float slope,
         int device, cudaStream_t s) {
  constexpr int V = Elem<T>::kVec;
  const bool vec = aligned16(y) && aligned16(g) && aligned16(dx);
  const long long nvec = vec ? n / V : 0;
  const long long work = nvec > 0 ? nvec : n;
  leaky_relu_bwd_kernel<T><<<blocks_for(work, device), kThreads, 0, s>>>(
      static_cast<const T*>(y), static_cast<const T*>(g), static_cast<T*>(dx),
      n, nvec, slope);
}

}  // namespace

// x, y: n elements of C channels, channels-last (channels_last = 1) or
// contiguous NC(D)HW with `spatial` points a channel; bias: C elements.
extern "C" int df_bias_leaky_relu_fwd(const void* x, const void* bias, void* y,
                                      long long n, int C, long long spatial,
                                      int channels_last, float slope,
                                      int dtype, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || n == 0) return (int)err;
  if (C <= 0 || spatial <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    fwd<float>(x, bias, y, n, C, spatial, channels_last, slope, device, s);
  } else if (dtype == 1) {
    fwd<__nv_bfloat16>(x, bias, y, n, C, spatial, channels_last, slope,
                       device, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// y, g, dx: n elements in one layout.
extern "C" int df_leaky_relu_bwd(const void* y, const void* g, void* dx,
                                 long long n, float slope, int dtype,
                                 int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || n == 0) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    bwd<float>(y, g, dx, n, slope, device, s);
  } else if (dtype == 1) {
    bwd<__nv_bfloat16>(y, g, dx, n, slope, device, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
