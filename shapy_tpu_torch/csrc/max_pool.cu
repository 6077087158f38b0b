// K11: the ResNet's 3x3 / stride-2 / pad-1 max pool, forward and backward,
// on NHWC activations in float32 or bfloat16:
//
//   y[n, i, j, c] = max over taps (r, s) in 3 x 3 of x[n, 2i - 1 + r,
//                   2j - 1 + s, c], the padding never a candidate
//
// Replaces: shapy_tpu/models/backbones/resnet.py:57-60, the
// jax.lax.reduce_window max (init -inf) after the stem, and its VJP (JAX
// autodiff: select_and_scatter_add, which sends each window's cotangent to
// the first maximum of the window in row-major order and never to a padded
// position). After the stem's ReLU many windows are all zeros, so the tie
// rule decides most of the gradient: the kernel keeps it exactly.
//
// What bounds it on the H100: bytes. The forward reads x once and writes y
// (67.1 + 16.8 MB at batch 32 and 64 x 128^2); the backward reads dy and x
// and writes dx (25.2 + 100.7 + 100.7 MB at batch 48). A few compares per
// element: far below the ridge.
//
// Design: one thread per 16 bytes (8 bf16 or 4 f32 channels) of one output
// pixel (forward, and the backward's first pass) or one input pixel (the
// backward's second pass), neighbouring threads on neighbouring chunks of
// a pixel, 16-byte loads and stores. A window's maximum is its first valid
// tap in row-major order unless a later tap is strictly larger. The
// backward finds each window's maximum again from x, once, into a byte a
// channel (N Ho Wo C bytes of scratch, 12.6 MB at batch 48: an eighth of
// x), then gathers: an input pixel lies in at most 2 x 2 windows (the
// windows whose rows 2i - 1 .. 2i + 1 and columns hold it); it visits them
// in row-major window order and adds the window's dy where that maximum is
// this pixel, in f32, rounding once. No atomics: the sums run in one fixed
// order (the windows' row-major order, as the plain version and JAX's
// scatter add them). The maxima are found again rather than saved by the
// forward: the backward needs only x, which the stem's ReLU keeps alive
// for its own gradient anyway, so the forward writes nothing but y in
// training and in eval alike. (Finding them in the gather itself, up to 4
// windows x 9 taps a pixel, took 0.55 ms at batch 48 on an H100, against
// the library backward's 0.44.) Inputs are taken to hold no NaN (a NaN
// window's maximum is not held to the plain version's).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kThreads = 256;

// The channels of a 16-byte chunk.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int n = 4;
};
template <>
struct Chunk<bf16> {
  static constexpr int n = 8;
};

__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}

__device__ __forceinline__ void load16(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(bf16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

struct PoolShape {
  int N, H, W, C, Ho, Wo;
};

// The maximum of window (n, i, j) for the chunk's channels at x + c0:
// best[] its values, arg[] its taps (3 r + s), the first valid tap in
// row-major order unless a later one is strictly larger.
template <typename T>
__device__ __forceinline__ void window_max(const T* __restrict__ x,
                                           const PoolShape& s, int n, int i,
                                           int j, int c0,
                                           float (&best)[Chunk<T>::n],
                                           int (&arg)[Chunk<T>::n]) {
  constexpr int V = Chunk<T>::n;
  bool any = false;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int h = 2 * i - 1 + r;
    if (h < 0 || h >= s.H) continue;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const int w = 2 * j - 1 + t;
      if (w < 0 || w >= s.W) continue;
      float v[V];
      load16(x + (((size_t)n * s.H + h) * s.W + w) * s.C + c0, v);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (!any || v[k] > best[k]) {
          best[k] = v[k];
          arg[k] = 3 * r + t;
        }
      }
      any = true;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) max_pool_forward_kernel(
    const T* __restrict__ x, T* __restrict__ y, PoolShape s,
    long long items) {
  constexpr int V = Chunk<T>::n;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= items) return;
  const int chunks = s.C / V;
  const int c0 = (int)(e % chunks) * V;
  long long pix = e / chunks;
  const int j = (int)(pix % s.Wo);
  pix /= s.Wo;
  const int i = (int)(pix % s.Ho);
  const int n = (int)(pix / s.Ho);
  float best[V];
  int arg[V];
  window_max(x, s, n, i, j, c0, best, arg);
  store16(y + (((size_t)n * s.Ho + i) * s.Wo + j) * s.C + c0, best);
}

// The channels' taps (0..8) of a chunk as bytes: 8 for bf16, 4 for f32.
__device__ __forceinline__ void store_taps(uint8_t* p, const int (&a)[8]) {
  uint2 u = make_uint2(0, 0);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    u.x |= (unsigned)a[k] << (8 * k);
    u.y |= (unsigned)a[k + 4] << (8 * k);
  }
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void store_taps(uint8_t* p, const int (&a)[4]) {
  unsigned u = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) u |= (unsigned)a[k] << (8 * k);
  *reinterpret_cast<unsigned*>(p) = u;
}

__device__ __forceinline__ void load_taps(const uint8_t* p, int (&a)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[k] = (u.x >> (8 * k)) & 255;
    a[k + 4] = (u.y >> (8 * k)) & 255;
  }
}

__device__ __forceinline__ void load_taps(const uint8_t* p, int (&a)[4]) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = (u >> (8 * k)) & 255;
}

// The backward's first pass: each window's first maximum, a tap a channel
// (N, Ho, Wo, C bytes), found as the forward finds it.
template <typename T>
__global__ void __launch_bounds__(kThreads) max_pool_argmax_kernel(
    const T* __restrict__ x, uint8_t* __restrict__ arg, PoolShape s,
    long long items) {
  constexpr int V = Chunk<T>::n;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= items) return;
  const int chunks = s.C / V;
  const int c0 = (int)(e % chunks) * V;
  long long pix = e / chunks;
  const int j = (int)(pix % s.Wo);
  pix /= s.Wo;
  const int i = (int)(pix % s.Ho);
  const int n = (int)(pix / s.Ho);
  float best[V];
  int taps[V];
  window_max(x, s, n, i, j, c0, best, taps);
  store_taps(arg + (((size_t)n * s.Ho + i) * s.Wo + j) * s.C + c0, taps);
}

// The second pass: dx of one input pixel's chunk, the dy of each window
// whose maximum it is, in the windows' row-major order.
template <typename T>
__global__ void __launch_bounds__(kThreads) max_pool_gather_kernel(
    const T* __restrict__ dy, const uint8_t* __restrict__ arg,
    T* __restrict__ dx, PoolShape s, long long items) {
  constexpr int V = Chunk<T>::n;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= items) return;
  const int chunks = s.C / V;
  const int c0 = (int)(e % chunks) * V;
  long long pix = e / chunks;
  const int w = (int)(pix % s.W);
  pix /= s.W;
  const int h = (int)(pix % s.H);
  const int n = (int)(pix / s.H);
  // Padded coordinates: window i covers padded rows 2i .. 2i + 2.
  const int p = h + 1, q = w + 1;
  const int i0 = (p - 1) / 2, i1 = min(s.Ho - 1, p / 2);
  const int j0 = (q - 1) / 2, j1 = min(s.Wo - 1, q / 2);
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  for (int i = i0; i <= i1; ++i) {
    for (int j = j0; j <= j1; ++j) {
      const int tap = 3 * (p - 2 * i) + (q - 2 * j);
      const size_t at = (((size_t)n * s.Ho + i) * s.Wo + j) * s.C + c0;
      int taps[V];
      load_taps(arg + at, taps);
      bool hit = false;
#pragma unroll
      for (int k = 0; k < V; ++k) hit |= taps[k] == tap;
      if (!hit) continue;
      float g[V];
      load16(dy + at, g);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (taps[k] == tap) acc[k] += g[k];
      }
    }
  }
  store16(dx + (((size_t)n * s.H + h) * s.W + w) * s.C + c0, acc);
}

PoolShape pool_shape(int N, int H, int W, int C) {
  PoolShape s;
  s.N = N; s.H = H; s.W = W; s.C = C;
  s.Ho = (H - 1) / 2 + 1;
  s.Wo = (W - 1) / 2 + 1;
  return s;
}

// Whether the shape is one the kernels take: 16-byte rows of C channels.
bool pool_ok(int N, int H, int W, int C, int dtype) {
  const int v = dtype == 0 ? 4 : 8;
  return N >= 0 && H >= 1 && W >= 1 && C >= 0 && C % v == 0 &&
         (dtype == 0 || dtype == 1);
}

int blocks_for(long long items) {
  return (int)((items + kThreads - 1) / kThreads);
}

}  // namespace

// x (N, H, W, C) -> y (N, Ho, Wo, C), Ho = (H - 1) / 2 + 1, NHWC, both
// 16-byte aligned; dtype 0 = float32 (C % 4 == 0), 1 = bfloat16 (C % 8 ==
// 0). Returns cudaGetLastError(), or cudaErrorInvalidValue for what it
// does not take.
extern "C" int max_pool_forward(const void* x, void* y, int N, int H, int W,
                                int C, int dtype, void* stream) {
  if (!pool_ok(N, H, W, C, dtype)) return (int)cudaErrorInvalidValue;
  const PoolShape s = pool_shape(N, H, W, C);
  const long long items =
      (long long)N * s.Ho * s.Wo * (C / (dtype == 0 ? 4 : 8));
  if (items == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    max_pool_forward_kernel<float><<<blocks_for(items), kThreads, 0, st>>>(
        (const float*)x, (float*)y, s, items);
  } else {
    max_pool_forward_kernel<bf16><<<blocks_for(items), kThreads, 0, st>>>(
        (const bf16*)x, (bf16*)y, s, items);
  }
  return (int)cudaGetLastError();
}

// dx (N, H, W, C) = the VJP of max_pool_forward at x for the cotangent dy
// (N, Ho, Wo, C), all NHWC, 16-byte aligned, of one dtype as above; arg:
// N Ho Wo C bytes of scratch (each window's maximum, a tap a channel).
// Returns cudaGetLastError(), or cudaErrorInvalidValue.
extern "C" int max_pool_backward(const void* dy, const void* x, void* arg,
                                 void* dx, int N, int H, int W, int C,
                                 int dtype, void* stream) {
  if (!pool_ok(N, H, W, C, dtype)) return (int)cudaErrorInvalidValue;
  const PoolShape s = pool_shape(N, H, W, C);
  const int chunks = C / (dtype == 0 ? 4 : 8);
  const long long windows = (long long)N * s.Ho * s.Wo * chunks;
  const long long pixels = (long long)N * H * W * chunks;
  if (pixels == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    max_pool_argmax_kernel<float><<<blocks_for(windows), kThreads, 0, st>>>(
        (const float*)x, (uint8_t*)arg, s, windows);
  } else {
    max_pool_argmax_kernel<bf16><<<blocks_for(windows), kThreads, 0, st>>>(
        (const bf16*)x, (uint8_t*)arg, s, windows);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0) {
    max_pool_gather_kernel<float><<<blocks_for(pixels), kThreads, 0, st>>>(
        (const float*)dy, (const uint8_t*)arg, (float*)dx, s, pixels);
  } else {
    max_pool_gather_kernel<bf16><<<blocks_for(pixels), kThreads, 0, st>>>(
        (const bf16*)dy, (const uint8_t*)arg, (bf16*)dx, s, pixels);
  }
  return (int)cudaGetLastError();
}
