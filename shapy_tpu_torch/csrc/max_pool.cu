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
// Design, forward: one thread per 16 bytes (8 bf16 or 4 f32 channels) of
// one output pixel, neighbouring threads on neighbouring chunks of a
// pixel, 16-byte loads and stores. A window's maximum is its first valid
// tap in row-major order unless a later tap is strictly larger.
//
// Backward, one launch and no scratch in device memory: a block takes a
// tile of th x tw output windows and a slice of cs channels (the wrapper's
// plan, from the shape alone) and writes the dx of the input pixels those
// windows own, rows 2 i0 .. 2 i0 + 2 th - 1 and likewise in columns. They
// receive from windows i0 .. i0 + th (one halo window below and to the
// right, also taken by the next tile), which read x rows 2 i0 - 1 .. 2 i0
// + 2 th + 1. Two TMA copies bring that box of x ((2 th + 3) x (2 tw + 3)
// pixels) and the windows' dy into shared memory; the block finds each
// window's first maximum once, into a 16-bit tap code a channel (bf16
// compared two channels at once), then a thread takes a window's 2 x 2
// pixels: each lies in at most 2 x 2 windows (this one and those to its
// right and below), visited in row-major window order, adding in f32 the
// window's dy where that maximum is this pixel (+0 where it is not: the
// same sum), rounded once; dx leaves as 16-byte vectors. No atomics: the
// sums run in one fixed order (the windows' row-major order, as the plain
// version and JAX's scatter add them). A tap out of the image is never a
// candidate: it is skipped by its coordinates (TMA's zero fill would tie
// with the ReLU's zeros and take their gradient). The maxima are found
// again rather than saved by the forward: the backward needs only x, which
// the stem's ReLU keeps alive for its own gradient anyway, so the forward
// writes nothing but y in training and in eval alike. At 8 x 8 windows
// and 64 bf16 channels a tile stages 19 x 19 x 128 B of x (1.41x the
// bytes it owns, re-read from L2), 10 KB of dy and 10 KB of tap codes,
// three blocks an SM; it takes 0.095 ms at batch 48 on an H100 at 700 W,
// 71% of its byte bound, each block's copies, maxima and gather in series
// (PERF.md). Inputs are taken to hold no NaN (a NaN window's maximum is
// not held to the plain version's).
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kThreads = 256;
// The most dynamic shared memory a block of an H100 may take, and the
// devices whose limit is raised.
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;

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

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"((uint32_t)__cvta_generic_to_shared(bar)),
               "r"(bytes)
               : "memory");
}
// Waits until the phase of parity `parity` has completed; a wait of more
// than 2^34 clocks (~9 s) is a lost copy, a fault of the kernel: it traps.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t b = (uint32_t)__cvta_generic_to_shared(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          (uint32_t)__cvta_generic_to_shared(dst)),
      "l"(reinterpret_cast<uint64_t>(map)),
      "r"((uint32_t)__cvta_generic_to_shared(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

struct PoolShape {
  int N, H, W, C, Ho, Wo;
};

// The maximum of window (n, i, j) for the chunk's channels at x + c0, over
// its taps in the image.
template <typename T>
__device__ __forceinline__ void window_max(const T* __restrict__ x,
                                           const PoolShape& s, int n, int i,
                                           int j, int c0,
                                           float (&best)[Chunk<T>::n]) {
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
        if (!any || v[k] > best[k]) best[k] = v[k];
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
  window_max(x, s, n, i, j, c0, best);
  store16(y + (((size_t)n * s.Ho + i) * s.Wo + j) * s.C + c0, best);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The backward's tiles, from the wrapper's plan (layers
// .max_pool_backward_plan, from the shape alone): th x tw windows and cs
// channels (a power of two of 16-byte chunks) a tile; the grid is N x
// tiles_h x tiles_w x slices blocks, slices fastest.
struct PoolTile {
  int th, tw, cs, tiles_h, tiles_w, slices;
};

// A tile's shared memory (bytes, each part on a 128-byte boundary): x's
// box of (2 th + 3) x (2 tw + 3) pixels and the dy of its (th + 1) x (tw
// + 1) windows, cs channels each, as the two TMA boxes land; the windows'
// taps, 16 bits a channel; the mbarrier. Its offsets as out[0..3] and the
// total (with 128 bytes to align the base) as the value.
__host__ __device__ inline int tile_layout(const PoolTile& p, int esize,
                                           int* out) {
  const int box = (2 * p.th + 3) * (2 * p.tw + 3);
  const int win = (p.th + 1) * (p.tw + 1);
  auto up = [](int b) { return (b + 127) / 128 * 128; };
  out[0] = 0;
  out[1] = up(box * p.cs * esize);
  out[2] = out[1] + up(win * p.cs * esize);
  out[3] = out[2] + up(win * p.cs * 2);
  return out[3] + 8 + 128;
}

// A window's first maximum over the taps of x's staged box in the image,
// a chunk at xb (the box's pixel (2a, 2c) of the window's top left tap,
// `row` elements a box row, `px` a pixel): codes[] the taps (3 r + s), 16
// bits a channel. bf16 compares two channels at once.
__device__ __forceinline__ void first_max(const bf16* xb, int row, int px,
                                          unsigned rows, unsigned cols,
                                          uint32_t (&codes)[4]) {
  uint32_t best[4];
  bool any = false;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    if (!(rows >> r & 1)) continue;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      if (!(cols >> t & 1)) continue;
      const uint4 u = *reinterpret_cast<const uint4*>(xb + r * row + t * px);
      const uint32_t v[4] = {u.x, u.y, u.z, u.w};
      const uint32_t code = (3u * r + t) * 0x10001u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!any) {
          best[k] = v[k];
          codes[k] = code;
          continue;
        }
        const uint32_t m =
            __hgt2_mask(*reinterpret_cast<const __nv_bfloat162*>(&v[k]),
                        *reinterpret_cast<const __nv_bfloat162*>(&best[k]));
        best[k] = (v[k] & m) | (best[k] & ~m);
        codes[k] = (code & m) | (codes[k] & ~m);
      }
      any = true;
    }
  }
}

__device__ __forceinline__ void first_max(const float* xb, int row, int px,
                                          unsigned rows, unsigned cols,
                                          uint32_t (&codes)[2]) {
  float best[4];
  uint32_t arg[4];
  bool any = false;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    if (!(rows >> r & 1)) continue;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      if (!(cols >> t & 1)) continue;
      float v[4];
      load16(xb + r * row + t * px, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!any || v[k] > best[k]) {
          best[k] = v[k];
          arg[k] = 3u * r + t;
        }
      }
      any = true;
    }
  }
  codes[0] = arg[0] | arg[1] << 16;
  codes[1] = arg[2] | arg[3] << 16;
}

// dx of one tile's input pixels, rows 2 i0 .. 2 i0 + 2 th - 1 and columns
// 2 j0 .. 2 j0 + 2 tw - 1 (clipped to the image), for one slice of cs
// channels: they receive from the windows i0 .. i0 + th (the last one the
// halo, which the next tile also takes) and likewise in j.
template <typename T>
__global__ void __launch_bounds__(kThreads) max_pool_backward_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap gmap, T* __restrict__ dx,
    PoolShape s, PoolTile p) {
  constexpr int V = Chunk<T>::n;
  constexpr int W16 = V / 2;  // words of 16-bit codes a chunk
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* const smem =
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  int at[4];
  tile_layout(p, (int)sizeof(T), at);
  const int tid = threadIdx.x;
  const int chunks = p.cs / V, cshift = __ffs(chunks) - 1;
  const int bw = 2 * p.tw + 3, ww = p.tw + 1;
  const int boxes = (2 * p.th + 3) * bw, wins = (p.th + 1) * ww;
  const T* const xs = reinterpret_cast<const T*>(smem + at[0]);
  const T* const gs = reinterpret_cast<const T*>(smem + at[1]);
  uint32_t* const as = reinterpret_cast<uint32_t*>(smem + at[2]);
  uint64_t* const bar = reinterpret_cast<uint64_t*>(smem + at[3]);
  int b = blockIdx.x;
  const int slice = b % p.slices;
  b /= p.slices;
  const int tj = b % p.tiles_w;
  b /= p.tiles_w;
  const int ti = b % p.tiles_h;
  const int n = b / p.tiles_h;
  const int i0 = ti * p.th, j0 = tj * p.tw, c0 = slice * p.cs;

  // x's box (from pixel (2 i0 - 1, 2 j0 - 1)) and the windows' dy, one TMA
  // copy each; what lies out of the image comes as zeros and is never
  // taken as a tap.
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, (boxes + wins) * p.cs * (int)sizeof(T));
    tma_load_4d(smem + at[0], &xmap, bar, c0, 2 * j0 - 1, 2 * i0 - 1, n);
    tma_load_4d(smem + at[1], &gmap, bar, c0, j0, i0, n);
  }
  __syncthreads();
  mbar_wait(bar, 0);

  // Each window's first maximum, a 16-bit tap code a channel: the first
  // tap in the image in row-major order unless a later one is strictly
  // larger. A tap out of the image is skipped by its coordinates, never by
  // a filled value (a filled zero would tie with the ReLU's zeros). A
  // window past the last takes code 0xffff, which no pixel matches.
  for (int e = tid; e < wins * chunks; e += kThreads) {
    const int q = e & (chunks - 1), win = e >> cshift;
    const int a = win / ww, c = win - a * ww;
    const int i = i0 + a, j = j0 + c;
    uint32_t codes[W16];
    if (i < s.Ho && j < s.Wo) {
      unsigned rows = 0, cols = 0;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        rows |= (unsigned)(2 * i - 1 + r >= 0 && 2 * i - 1 + r < s.H) << r;
        cols |= (unsigned)(2 * j - 1 + r >= 0 && 2 * j - 1 + r < s.W) << r;
      }
      first_max(xs + ((2 * a) * bw + 2 * c) * p.cs + q * V, bw * p.cs, p.cs,
                rows, cols, codes);
    } else {
#pragma unroll
      for (int k = 0; k < W16; ++k) codes[k] = 0xffffffffu;
    }
#pragma unroll
    for (int k = 0; k < W16; ++k) as[(win * p.cs + q * V) / 2 + k] = codes[k];
  }
  __syncthreads();

  // dx of window (i, j)'s 2 x 2 pixels (2i .. 2i + 1, 2j .. 2j + 1): they
  // receive from windows (i, j), (i, j + 1), (i + 1, j), (i + 1, j + 1),
  // each at one tap; each pixel sums, in f32 and in the windows'
  // row-major order, the dy of those whose maximum it is (+0 for the
  // others: the same sum), rounded once. Neighbouring threads take
  // neighbouring chunks, then neighbouring windows of a row.
  for (int e = tid; e < p.th * p.tw * chunks; e += kThreads) {
    const int q = e & (chunks - 1), blk = e >> cshift;
    const int a = blk / p.tw, c = blk - a * p.tw;
    const int i = i0 + a, j = j0 + c;
    if (i >= s.Ho || j >= s.Wo) continue;
    int code[4][V];
    float g[4][V];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int win = (a + (u >> 1)) * ww + c + (u & 1);
      const uint32_t* t = as + (win * p.cs + q * V) / 2;
#pragma unroll
      for (int k = 0; k < W16; ++k) {
        const uint32_t w = t[k];
        code[u][2 * k] = w & 0xffff;
        code[u][2 * k + 1] = w >> 16;
      }
      load16(gs + win * p.cs + q * V, g[u]);
    }
    // (pixel row, column) offsets, and each window's tap for the pixel
    // (-1: no tap of that window), windows in row-major order.
    constexpr int kTap[4][4] = {{4, -1, -1, -1},
                                {5, 3, -1, -1},
                                {7, -1, 1, -1},
                                {8, 6, 2, 0}};
    T* const out = dx + (((size_t)n * s.H + 2 * i) * s.W + 2 * j) * s.C +
                   c0 + q * V;
#pragma unroll
    for (int px = 0; px < 4; ++px) {
      const int dh = px >> 1, dw = px & 1;
      if (2 * i + dh >= s.H || 2 * j + dw >= s.W) continue;
      float acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (kTap[px][u] < 0) continue;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          acc[k] += code[u][k] == kTap[px][u] ? g[u][k] : 0.f;
        }
      }
      store16(out + ((size_t)dh * s.W + dw) * s.C, acc);
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time (no -lcuda): a 4-D map of
// an NHWC tensor (C, W, H, N) with boxes of (cs, bw, bh, 1) elements, no
// swizzle, zeros out of bounds.
cudaError_t encode_nhwc(CUtensorMap* map, const void* base, int dtype, int N,
                        int H, int W, int C, int cs, int bw, int bh) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return cudaErrorNotSupported;
    }
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  // The encoding needs the device's context current on this host thread:
  // an autograd worker thread (where the backward runs) may not have
  // bound it yet. Bound once a thread.
  thread_local bool bound = false;
  if (!bound) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaSetDevice(dev);
    if (err != cudaSuccess) return err;
    bound = true;
  }
  const cuuint64_t es = dtype == 0 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)N};
  const cuuint64_t strides[3] = {C * es, (cuuint64_t)W * C * es,
                                 (cuuint64_t)H * W * C * es};
  const cuuint32_t box[4] = {(cuuint32_t)cs, (cuuint32_t)bw, (cuuint32_t)bh,
                             1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map,
      dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims, strides, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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
// (N, Ho, Wo, C), all NHWC, 16-byte aligned, of one dtype as above, in
// one launch of max_pool_backward_kernel on the plan's tiles (th x tw
// windows, cs channels, cs / 8 (bf16) or cs / 4 (f32) a power of two;
// tiles_h = ceil(Ho / th), tiles_w = ceil(Wo / tw), slices = C / cs),
// with tile_layout's bytes of dynamic shared memory. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take.
extern "C" int max_pool_backward(const void* dy, const void* x, void* dx,
                                 int N, int H, int W, int C, int dtype,
                                 int th, int tw, int cs, void* stream) {
  if (!pool_ok(N, H, W, C, dtype)) return (int)cudaErrorInvalidValue;
  const PoolShape s = pool_shape(N, H, W, C);
  const int v = dtype == 0 ? 4 : 8, esize = dtype == 0 ? 4 : 2;
  const int chunks = cs / v;
  auto misaligned = [](const void* p) { return (uintptr_t)p % 16 != 0; };
  if (th < 1 || tw < 1 || 2 * tw + 3 > 256 || 2 * th + 3 > 256 ||
      cs < v || cs % v != 0 || cs > 256 || (chunks & (chunks - 1)) != 0 ||
      (C > 0 && C % cs != 0) || misaligned(dy) || misaligned(x) ||
      misaligned(dx)) {
    return (int)cudaErrorInvalidValue;
  }
  PoolTile p;
  p.th = th;
  p.tw = tw;
  p.cs = cs;
  p.tiles_h = (s.Ho + th - 1) / th;
  p.tiles_w = (s.Wo + tw - 1) / tw;
  p.slices = C / cs;
  int at[4];
  const int smem = tile_layout(p, esize, at);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)N * p.tiles_h * p.tiles_w * p.slices;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // The shared-memory limit, raised once a device and dtype.
  static bool configured[2][kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !configured[dtype][dev]) {
    err = dtype == 0
              ? cudaFuncSetAttribute(max_pool_backward_kernel<float>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     kMaxSmem)
              : cudaFuncSetAttribute(max_pool_backward_kernel<bf16>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) configured[dtype][dev] = true;
  }
  CUtensorMap xmap, gmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&gmap, 0, sizeof(gmap));
  err = encode_nhwc(&xmap, x, dtype, N, H, W, C, cs, 2 * tw + 3, 2 * th + 3);
  if (err == cudaSuccess) {
    err = encode_nhwc(&gmap, dy, dtype, N, s.Ho, s.Wo, C, cs, tw + 1, th + 1);
  }
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    max_pool_backward_kernel<float><<<(int)blocks, kThreads, smem, st>>>(
        xmap, gmap, (float*)dx, s, p);
  } else {
    max_pool_backward_kernel<bf16><<<(int)blocks, kThreads, smem, st>>>(
        xmap, gmap, (bf16*)dx, s, p);
  }
  return (int)cudaGetLastError();
}
