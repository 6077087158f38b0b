// K4: train-mode BatchNorm, forward and backward, on channels-last
// activations in float32 or bfloat16.
//
// Replaces: shapy_tpu/models/backbones/layers.py:bn_train_core (lines
// 174-245, the jax.custom_vjp with the fused two-reduction backward) and
// the running-stat EMA of batch_norm (:270-281). It keeps the JAX
// package's numerics, not cuDNN's:
//   * moments in f32 as E[x^2] - E[x]^2 (:142-159);
//   * x_hat = (x - mean) * inv and y = x_hat * gamma + beta in the
//     activation dtype, each operation rounded to it, with mean, inv =
//     rsqrt(var + eps), gamma and beta first rounded to it (:162-165);
//   * running_mean += momentum-EMA of mean, running_var of the unbiased
//     var * n / (n - 1), in f32 (:270-281);
//   * dx = gamma inv (dy - mean(dy) - x_hat mean(dy x_hat)) in the
//     activation dtype, with f32 sums; dgamma = sum dy x_hat, dbeta =
//     sum dy (:198-242). x_hat is recomputed from x, never stored.
//
// What bounds it on the H100: device memory. The forward reads x twice
// (moments, normalise) and writes y; the backward reads dy and x twice and
// writes dx. Per element that is a few FLOP against 2-4 bytes; the largest
// layer of the flagship at batch 48 holds ~50 M elements.
//
// Design: an activation is an (R, C) row-major matrix, R = N H W rows.
// The forward is three launches. (1) Per-channel partial sums over tiles
// of rows: a block of 32 channel lanes x 8 row lanes, a warp reading 32
// neighbouring channels of one row; each thread sums its rows in order,
// then the 8 row lanes are summed in order. (2) One block per 32 channels
// sums the partials in tile order (8 lanes over strided tiles, then the
// lanes in order), and derives the per-channel coefficients and updates
// the running stats. (3) An elementwise pass. The backward, redesigned
// for the H100, is described at its kernels below. No float atomics: two
// runs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;  // channels per block
constexpr int kRows = 8;    // row lanes per block

__device__ __forceinline__ float load(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Round to the activation dtype T (a no-op for float).
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// x_hat in the activation dtype, as a float.
template <typename T>
__device__ __forceinline__ float xhat(float x, float mean_t, float inv_t) {
  return rnd<T>(rnd<T>(x - mean_t) * inv_t);
}

// Pass 1 of the forward: per tile of rows, sum x and sum x^2 of each
// channel. partials (tiles, C, 2).
template <typename T>
__global__ void moments_partial_kernel(const T* __restrict__ x,
                                       float* __restrict__ partials, int R,
                                       int C, int rows_per_tile) {
  __shared__ float ss[kRows][kLanes + 1], sq[kRows][kLanes + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.y * kLanes + tx;
  const int r0 = blockIdx.x * rows_per_tile;
  const int r1 = min(R, r0 + rows_per_tile);
  float s = 0.f, q = 0.f;
  if (c < C) {
    for (int r = r0 + ty; r < r1; r += kRows) {
      const float v = load(x, (size_t)r * C + c);
      s += v;
      q += v * v;
    }
  }
  ss[ty][tx] = s;
  sq[ty][tx] = q;
  __syncthreads();
  if (ty == 0 && c < C) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      a += ss[k][tx];
      b += sq[k][tx];
    }
    float* p = partials + ((size_t)blockIdx.x * C + c) * 2;
    p[0] = a;
    p[1] = b;
  }
}

// Sums (tiles, C, 2) partials in tile order: lane ty takes tiles ty,
// ty + 8, ...; then the lanes in order. Returns the pair for channel c in
// row-lane 0 (other lanes get garbage).
__device__ __forceinline__ void sum_partials(
    const float* __restrict__ partials, int tiles, int C, int c, float* a,
    float* b) {
  __shared__ float ss[kRows][kLanes + 1], sq[kRows][kLanes + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  float s = 0.f, q = 0.f;
  if (c < C) {
    for (int k = ty; k < tiles; k += kRows) {
      const float* p = partials + ((size_t)k * C + c) * 2;
      s += p[0];
      q += p[1];
    }
  }
  ss[ty][tx] = s;
  sq[ty][tx] = q;
  __syncthreads();
  s = 0.f;
  q = 0.f;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    s += ss[k][tx];
    q += sq[k][tx];
  }
  *a = s;
  *b = q;
}

// Pass 2 of the forward: mean, var = E[x^2] - mean^2, inv = rsqrt(var +
// eps) (f32, rounded to the activation dtype where used), and the EMA of
// the running stats when they are given.
__global__ void moments_finalize_kernel(const float* __restrict__ partials,
                                        int tiles, int C, float n, float eps,
                                        float keep, float momentum,
                                        float unbias, float* running_mean,
                                        float* running_var,
                                        float* __restrict__ mean,
                                        float* __restrict__ inv) {
  const int c = blockIdx.x * kLanes + threadIdx.x;
  float s, q;
  sum_partials(partials, tiles, C, c, &s, &q);
  if (threadIdx.y != 0 || c >= C) return;
  const float m = s / n;
  const float var = q / n - m * m;
  mean[c] = m;
  inv[c] = rsqrtf(var + eps);
  if (running_mean != nullptr) {
    running_mean[c] = keep * running_mean[c] + momentum * m;
    running_var[c] = keep * running_var[c] + momentum * (var * unbias);
  }
}

// Pass 3 of the forward: y = x_hat * gamma + beta in the activation dtype.
template <typename T>
__global__ void normalize_kernel(const T* __restrict__ x,
                                 const float* __restrict__ mean,
                                 const float* __restrict__ inv,
                                 const float* __restrict__ gamma,
                                 const float* __restrict__ beta,
                                 T* __restrict__ y, unsigned R, unsigned C) {
  const size_t total = (size_t)R * C;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const unsigned c = (unsigned)(i % C);
    const float h = xhat<T>(load(x, i), rnd<T>(mean[c]), rnd<T>(inv[c]));
    store(y, i, rnd<T>(h * rnd<T>(gamma[c])) + rnd<T>(beta[c]));
  }
}

unsigned elementwise_blocks(size_t total) {
  const size_t want = (total + 255) / 256;
  return (unsigned)(want < 132 * 16 ? want : 132 * 16);
}

template <typename T>
int forward(const void* x, const void* gamma, const void* beta,
            void* running_mean, void* running_var, void* partials, void* mean,
            void* inv, void* y, int R, int C, int tiles, int rows_per_tile,
            float eps, float momentum, float unbias, cudaStream_t stream) {
  const dim3 block(kLanes, kRows);
  const int cblocks = (C + kLanes - 1) / kLanes;
  moments_partial_kernel<T><<<dim3(tiles, cblocks), block, 0, stream>>>(
      (const T*)x, (float*)partials, R, C, rows_per_tile);
  moments_finalize_kernel<<<cblocks, block, 0, stream>>>(
      (const float*)partials, tiles, C, (float)R, eps, 1.f - momentum,
      momentum, unbias, (float*)running_mean, (float*)running_var,
      (float*)mean, (float*)inv);
  normalize_kernel<T><<<elementwise_blocks((size_t)R * C), 256, 0, stream>>>(
      (const T*)x, (const float*)mean, (const float*)inv,
      (const float*)gamma, (const float*)beta, (T*)y, R, C);
  return (int)cudaGetLastError();
}

// ---- Backward -------------------------------------------------------------
//
// dx = gamma inv (dy - mean(dy) - x_hat mean(dy x_hat)), dgamma = sum dy
// x_hat, dbeta = sum dy: two f32 sums a channel over the R rows, then an
// elementwise pass; bound by the bytes of dy and x (read) and dx
// (written), and at the small layers by the latency of its dependent
// steps. A thread owns V = 8 neighbouring channels of a row (one 16-byte
// load of bf16, two of f32; 1 channel where C % 8 != 0) and loads its
// channels' coefficients once, as 16-byte vectors. Sums in a fixed order,
// no float atomics: two calls give the same bits. Two regimes, chosen by
// the wrapper from the shape alone (_bn_plan):
//   * the larger layers (the 128^2 to 32^2 maps, the widest 8^2 ones):
//     three launches. A 256-thread block is `lanes` row lanes x `group`
//     channel chunks, group = min(C / 8, 256), lanes = 256 / group: a warp
//     covers whole rows (4 rows of a 64-channel layer); blockIdx.y is the
//     chunk group where C > 2048. (1) The partial sums of each row tile: a
//     thread's rows in order, then the row lanes in order. (2) The
//     finalize, a block per 8 channels: 32 lanes over strided tiles, then
//     the lanes in order (bwd_finalize_kernel). (3) dx, a block per row
//     tile. dy and x are read twice.
//   * small layers (few rows): one launch of a thread-block cluster of 8
//     or 16 blocks per chunk of 8 channels (bwd_cluster_kernel). Block b of
//     the cluster takes rows [b rows, (b + 1) rows), a thread every 256th
//     of them; the block sums its 256 lanes (8 groups of 32 in order, then
//     the groups in order), the cluster's barrier publishes the block sums
//     in shared memory, and every block adds them in block order through
//     distributed shared memory, derives the coefficients and writes dx of
//     its rows (its first four rows from registers, the rest from L2). No
//     grid-wide barrier, no atomics, no partials in device memory.
constexpr int kThreads = 256;

struct BwdShape {
  int R, C, tiles, rows_per_tile, group, lanes;
};

template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&v)[V]) {
  if constexpr (V == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}
template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p,
                                       float (&v)[V]) {
  if constexpr (V == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[i]);
  }
}
template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}
template <int V>
__device__ __forceinline__ void store_v(__nv_bfloat16* p,
                                        const float (&v)[V]) {
  if constexpr (V == 8) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i],
                                                            v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

// V per-channel floats at p (16-byte aligned for V = 8).
template <int V>
__device__ __forceinline__ void load_f(const float* p, float (&v)[V]) {
  if constexpr (V == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

// This thread's row lane and first channel; `active` where both exist.
struct Slot {
  int lane, c0;
  bool active;
};
template <int V>
__device__ __forceinline__ Slot slot(const BwdShape& S) {
  Slot q;
  const int chunk = threadIdx.x % S.group;
  q.lane = threadIdx.x / S.group;
  q.c0 = (blockIdx.y * S.group + chunk) * V;
  q.active = q.lane < S.lanes && q.c0 < S.C;
  return q;
}

// V per-channel floats at p, each rounded to the activation dtype.
template <typename T, int V>
__device__ __forceinline__ void load_rounded(const float* p, float (&v)[V]) {
  load_f<V>(p, v);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = rnd<T>(v[i]);
}

// One row's V channels: s += dy, sx += dy x_hat.
template <typename T, int V>
__device__ __forceinline__ void add_row(const float (&d)[V],
                                        const float (&xv)[V],
                                        const float (&m)[V],
                                        const float (&iv)[V], float (&s)[V],
                                        float (&sx)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s[i] += d[i];
    sx[i] += d[i] * xhat<T>(xv[i], m[i], iv[i]);
  }
}

// One row's V channels of dx = (gamma inv) ((dy - mean(dy)) - x_hat
// mean(dy x_hat)), each operation rounded to the activation dtype; k0, k1,
// k2 are mean(dy), mean(dy x_hat) and gamma inv, rounded.
template <typename T, int V>
__device__ __forceinline__ void dx_row(const float (&d)[V],
                                       const float (&xv)[V],
                                       const float (&m)[V],
                                       const float (&iv)[V],
                                       const float (&k0)[V],
                                       const float (&k1)[V],
                                       const float (&k2)[V], T* out) {
  float o[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float h = xhat<T>(xv[i], m[i], iv[i]);
    const float a = rnd<T>(d[i] - k0[i]);
    const float b = rnd<T>(h * k1[i]);
    o[i] = k2[i] * rnd<T>(a - b);
  }
  store_v<V>(out, o);
}

// Calls row(dy, x, r) on channels c0 .. c0 + V - 1 of rows r, r + step,
// ... < r1, in row order, with four rows' loads in flight.
template <int V, typename T, typename Row>
__device__ __forceinline__ void walk_rows(const T* __restrict__ dy,
                                          const T* __restrict__ x, int C,
                                          int c0, int r, int r1, int step,
                                          Row row) {
  for (; r + 3 * step < r1; r += 4 * step) {
    float d[4][V], xv[4][V];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t at = (size_t)(r + j * step) * C + c0;
      load_v<V>(dy + at, d[j]);
      load_v<V>(x + at, xv[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) row(d[j], xv[j], r + j * step);
  }
  for (; r < r1; r += step) {
    float d[V], xv[V];
    const size_t at = (size_t)r * C + c0;
    load_v<V>(dy + at, d);
    load_v<V>(x + at, xv);
    row(d, xv, r);
  }
}

// Row tile blockIdx.x's partial sums of dy and dy x_hat for this block's
// channels, into partials (tiles, C, 2).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) bwd_partial_kernel(
    const T* __restrict__ dy, const T* __restrict__ x,
    const float* __restrict__ mean, const float* __restrict__ inv,
    float* __restrict__ partials, const BwdShape S) {
  __shared__ float sh[2][kThreads * V];
  const int tile = blockIdx.x;
  const Slot q = slot<V>(S);
  float s[V], sx[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = sx[i] = 0.f;
  if (q.active) {
    float m[V], iv[V];
    load_rounded<T, V>(mean + q.c0, m);
    load_rounded<T, V>(inv + q.c0, iv);
    walk_rows<V>(dy, x, S.C, q.c0, tile * S.rows_per_tile + q.lane,
                 min(S.R, (tile + 1) * S.rows_per_tile), S.lanes,
                 [&](const float (&d)[V], const float (&xv)[V], int) {
                   add_row<T, V>(d, xv, m, iv, s, sx);
                 });
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sh[0][threadIdx.x * V + i] = s[i];
    sh[1][threadIdx.x * V + i] = sx[i];
  }
  __syncthreads();
  if (q.active && q.lane == 0) {  // the row lanes in order
    float a[V], b[V];
#pragma unroll
    for (int i = 0; i < V; ++i) a[i] = b[i] = 0.f;
    for (int l = 0; l < S.lanes; ++l) {
      const int at = (l * S.group + threadIdx.x) * V;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        a[i] += sh[0][at + i];
        b[i] += sh[1][at + i];
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float* p = partials + ((size_t)tile * S.C + q.c0 + i) * 2;
      p[0] = a[i];
      p[1] = b[i];
    }
  }
}

// The finalize of channels 8 b .. 8 b + 7 (block b): tile lane l (of 32)
// sums the partials of tiles l, l + 32, ... (eight loads in flight), then
// the lanes in order; writes dgamma, dbeta and the dx coefficients coef
// (3, C) = [mean(dy), mean(dy x_hat), gamma * inv].
constexpr int kTileLanes = 32;
template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_finalize_kernel(
    const float* __restrict__ partials, int tiles, int C, float n,
    const float* __restrict__ gamma, const float* __restrict__ inv,
    float* __restrict__ dgamma, float* __restrict__ dbeta,
    float* __restrict__ coef) {
  __shared__ float ss[kTileLanes][9], sq[kTileLanes][9];
  const int ch = threadIdx.x & 7, l = threadIdx.x >> 3;
  const int c = blockIdx.x * 8 + ch;
  float s = 0.f, q = 0.f;
  if (c < C) {
#pragma unroll 8
    for (int k = l; k < tiles; k += kTileLanes) {
      const float* p = partials + ((size_t)k * C + c) * 2;
      s += p[0];
      q += p[1];
    }
  }
  ss[l][ch] = s;
  sq[l][ch] = q;
  __syncthreads();
  if (l != 0 || c >= C) return;
  s = 0.f;
  q = 0.f;
  for (int k = 0; k < kTileLanes; ++k) {
    s += ss[k][ch];
    q += sq[k][ch];
  }
  dgamma[c] = q;
  dbeta[c] = s;
  coef[c] = s / n;
  coef[C + c] = q / n;
  coef[2 * C + c] = gamma[c] * rnd<T>(inv[c]);
}

// dx of row tile blockIdx.x for this block's channels, from the
// coefficients coef (3, C).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) bwd_dx_kernel(
    const T* __restrict__ dy, const T* __restrict__ x,
    const float* __restrict__ mean, const float* __restrict__ inv,
    const float* __restrict__ coef, T* __restrict__ dx, const BwdShape S) {
  const int r0 = blockIdx.x * S.rows_per_tile;
  const int r1 = min(S.R, r0 + S.rows_per_tile);
  const Slot q = slot<V>(S);
  if (!q.active) return;
  float m[V], iv[V], k0[V], k1[V], k2[V];
  load_rounded<T, V>(mean + q.c0, m);
  load_rounded<T, V>(inv + q.c0, iv);
  load_rounded<T, V>(coef + q.c0, k0);
  load_rounded<T, V>(coef + S.C + q.c0, k1);
  load_rounded<T, V>(coef + 2 * S.C + q.c0, k2);
  walk_rows<V>(dy, x, S.C, q.c0, r0 + q.lane, r1, S.lanes,
               [&](const float (&d)[V], const float (&xv)[V], int r) {
                 dx_row<T, V>(d, xv, m, iv, k0, k1, k2,
                              dx + (size_t)r * S.C + q.c0);
               });
}

// The cluster regime. Thread-block cluster instructions: the barrier of
// the cluster's blocks (release / acquire), and a float of block `rank`'s
// shared memory at this block's address `local`.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ float ld_cluster(const float* local,
                                            unsigned rank) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(local);
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// Cluster blockIdx.y (channels c0 = V y .. c0 + V - 1) of kCl blocks, block
// blockIdx.x of it: rows [x rows_per_tile, ...), a thread every 256th. A
// thread's first four rows stay in registers from the sums to dx.
template <typename T, int V, int kCl>
__global__ void __launch_bounds__(kThreads) bwd_cluster_kernel(
    const T* __restrict__ dy, const T* __restrict__ x,
    const float* __restrict__ gamma, const float* __restrict__ mean,
    const float* __restrict__ inv, float* __restrict__ dgamma,
    float* __restrict__ dbeta, T* __restrict__ dx, const BwdShape S) {
  __shared__ float ss[kThreads][V + 1], sq[kThreads][V + 1];
  __shared__ float gs[8][V], gq[8][V];
  __shared__ float block_sum[2][V];  // read by the cluster's blocks
  __shared__ float coefs[3][V];      // the dx coefficients, rounded
  const int l = threadIdx.x, rank = blockIdx.x;
  const int c0 = blockIdx.y * V;
  const int r0 = rank * S.rows_per_tile + l;
  const int r1 = min(S.R, rank * S.rows_per_tile + S.rows_per_tile);
  float m[V], iv[V];
  load_rounded<T, V>(mean + c0, m);
  load_rounded<T, V>(inv + c0, iv);
  float s[V], sx[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = sx[i] = 0.f;
  auto at = [&](int r) { return (size_t)r * S.C + c0; };
  float d0[4][V], x0[4][V];  // rows r0, r0 + 256, r0 + 512, r0 + 768
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (r0 + j * kThreads < r1) {
      load_v<V>(dy + at(r0 + j * kThreads), d0[j]);
      load_v<V>(x + at(r0 + j * kThreads), x0[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (r0 + j * kThreads < r1) add_row<T, V>(d0[j], x0[j], m, iv, s, sx);
  }
  walk_rows<V>(dy, x, S.C, c0, r0 + 4 * kThreads, r1, kThreads,
               [&](const float (&d)[V], const float (&xv)[V], int) {
                 add_row<T, V>(d, xv, m, iv, s, sx);
               });
#pragma unroll
  for (int i = 0; i < V; ++i) {
    ss[l][i] = s[i];
    sq[l][i] = sx[i];
  }
  __syncthreads();
  if (l < 8 * V) {  // lanes 32 g .. 32 g + 31 in order, channel i
    const int i = l % V, g = l / V;
    float a = 0.f, b = 0.f;
    for (int k = 32 * g; k < 32 * g + 32; ++k) {
      a += ss[k][i];
      b += sq[k][i];
    }
    gs[g][i] = a;
    gq[g][i] = b;
  }
  __syncthreads();
  if (l < V) {  // the 8 groups in order
    float a = 0.f, b = 0.f;
    for (int g = 0; g < 8; ++g) {
      a += gs[g][l];
      b += gq[g][l];
    }
    block_sum[0][l] = a;
    block_sum[1][l] = b;
  }
  cluster_arrive();  // publishes block_sum to the cluster
  cluster_wait();
  if (l < V) {  // the cluster's blocks in order
    float sdy = 0.f, sdyx = 0.f;
    for (int b = 0; b < kCl; ++b) {
      sdy += ld_cluster(&block_sum[0][l], b);
      sdyx += ld_cluster(&block_sum[1][l], b);
    }
    const int c = c0 + l;
    const float n = (float)S.R;
    if (rank == 0) {
      dgamma[c] = sdyx;
      dbeta[c] = sdy;
    }
    coefs[0][l] = rnd<T>(sdy / n);
    coefs[1][l] = rnd<T>(sdyx / n);
    coefs[2][l] = rnd<T>(gamma[c] * rnd<T>(inv[c]));
  }
  // The remote reads are done once every block arrives again; each block
  // waits for that only before it exits (its block_sum must live on).
  cluster_arrive();
  __syncthreads();
  float k0[V], k1[V], k2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    k0[i] = coefs[0][i];
    k1[i] = coefs[1][i];
    k2[i] = coefs[2][i];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (r0 + j * kThreads < r1) {
      dx_row<T, V>(d0[j], x0[j], m, iv, k0, k1, k2,
                   dx + at(r0 + j * kThreads));
    }
  }
  walk_rows<V>(dy, x, S.C, c0, r0 + 4 * kThreads, r1, kThreads,
               [&](const float (&d)[V], const float (&xv)[V], int r) {
                 dx_row<T, V>(d, xv, m, iv, k0, k1, k2, dx + at(r));
               });
  cluster_wait();
}

template <typename T, int V, int kCl>
cudaError_t launch_cluster(const T* dy, const T* x, const float* gamma,
                           const float* mean, const float* inv,
                           float* dgamma, float* dbeta, T* dx,
                           const BwdShape& S, cudaStream_t stream) {
  if (kCl > 8) {  // above the portable cluster size: allowed once a device
    static bool allowed[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || !allowed[dev]) {
      err = cudaFuncSetAttribute(bwd_cluster_kernel<T, V, kCl>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed,
                                 1);
      if (err != cudaSuccess) return err;
      if (dev < 64) allowed[dev] = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCl, S.C / V);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, bwd_cluster_kernel<T, V, kCl>, dy, x,
                            gamma, mean, inv, dgamma, dbeta, dx, S);
}

template <typename T, int V>
cudaError_t backward(const void* dy, const void* x, const void* gamma,
                     const void* mean, const void* inv, void* partials,
                     void* coef, void* dgamma, void* dbeta, void* dx,
                     const BwdShape& S, int fused, cudaStream_t stream) {
  const T* dy_t = (const T*)dy;
  const T* x_t = (const T*)x;
  const float* mean_f = (const float*)mean;
  const float* inv_f = (const float*)inv;
  if (fused) {
    if (S.tiles == 16) {
      return launch_cluster<T, V, 16>(dy_t, x_t, (const float*)gamma, mean_f,
                                      inv_f, (float*)dgamma, (float*)dbeta,
                                      (T*)dx, S, stream);
    }
    return launch_cluster<T, V, 8>(dy_t, x_t, (const float*)gamma, mean_f,
                                   inv_f, (float*)dgamma, (float*)dbeta,
                                   (T*)dx, S, stream);
  }
  const int cgroups = (S.C / V + S.group - 1) / S.group;
  bwd_partial_kernel<T, V><<<dim3(S.tiles, cgroups), kThreads, 0, stream>>>(
      dy_t, x_t, mean_f, inv_f, (float*)partials, S);
  bwd_finalize_kernel<T><<<(S.C + 7) / 8, kThreads, 0, stream>>>(
      (const float*)partials, S.tiles, S.C, (float)S.R, (const float*)gamma,
      inv_f, (float*)dgamma, (float*)dbeta, (float*)coef);
  bwd_dx_kernel<T, V><<<dim3(S.tiles, cgroups), kThreads, 0, stream>>>(
      dy_t, x_t, mean_f, inv_f, (const float*)coef, (T*)dx, S);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward_any(const void* dy, const void* x, const void* gamma,
                         const void* mean, const void* inv, void* partials,
                         void* coef, void* dgamma, void* dbeta, void* dx,
                         const BwdShape& S, int vec, int fused,
                         cudaStream_t stream) {
  if (vec == 8) {
    return backward<T, 8>(dy, x, gamma, mean, inv, partials, coef, dgamma,
                          dbeta, dx, S, fused, stream);
  }
  return backward<T, 1>(dy, x, gamma, mean, inv, partials, coef, dgamma,
                        dbeta, dx, S, fused, stream);
}

}  // namespace

// x, y (R, C) channels-last activations, bf16 when is_bf16 else f32;
// gamma, beta (C,) f32; running_mean / running_var (C,) f32, updated in
// place, or both null; partials (tiles, C, 2) f32 scratch; mean, inv (C,)
// f32 outputs saved for the backward. Rows [k * rows_per_tile, ...) form
// tile k. Returns cudaGetLastError().
extern "C" int bn_forward(const void* x, const void* gamma, const void* beta,
                          void* running_mean, void* running_var,
                          void* partials, void* mean, void* inv, void* y,
                          int R, int C, int tiles, int rows_per_tile,
                          int is_bf16, float eps, float momentum, float unbias,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? forward<__nv_bfloat16>(x, gamma, beta, running_mean,
                                          running_var, partials, mean, inv, y,
                                          R, C, tiles, rows_per_tile, eps,
                                          momentum, unbias, s)
                 : forward<float>(x, gamma, beta, running_mean, running_var,
                                  partials, mean, inv, y, R, C, tiles,
                                  rows_per_tile, eps, momentum, unbias, s);
}

// dy, x, dx (R, C) in the activation dtype; gamma, mean, inv (C,) f32;
// dgamma, dbeta (C,) f32 outputs. vec: channels a thread takes, 8 (C % 8
// == 0; dy, x, mean and inv 16-byte aligned) or 1.
//   * fused 0: partials (tiles, C, 2) and coef (3, C) f32 scratch; rows
//     [k rows_per_tile, ...) form tile k.
//   * fused 1: one cluster of `tiles` blocks (8 or 16) per vec channels;
//     no scratch.
// Returns the launches' error, cudaErrorInvalidValue for arguments it does
// not take.
extern "C" int bn_backward(const void* dy, const void* x, const void* gamma,
                           const void* mean, const void* inv, void* partials,
                           void* coef, void* dgamma, void* dbeta, void* dx,
                           int R, int C, int tiles, int rows_per_tile,
                           int vec, int fused, int is_bf16, void* stream) {
  if (R <= 0 || C <= 0) return (int)cudaSuccess;
  if ((vec != 8 && vec != 1) || C % vec != 0 || tiles < 1 ||
      rows_per_tile < 1 || (long long)tiles * rows_per_tile < R ||
      (fused && ((tiles != 8 && tiles != 16) || C / vec > 65535))) {
    return (int)cudaErrorInvalidValue;
  }
  BwdShape S;
  S.R = R;
  S.C = C;
  S.tiles = tiles;
  S.rows_per_tile = rows_per_tile;
  S.group = C / vec < kThreads ? C / vec : kThreads;
  S.lanes = kThreads / S.group;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? (int)backward_any<__nv_bfloat16>(
                       dy, x, gamma, mean, inv, partials, coef, dgamma,
                       dbeta, dx, S, vec, fused, s)
                 : (int)backward_any<float>(dy, x, gamma, mean, inv,
                                            partials, coef, dgamma, dbeta,
                                            dx, S, vec, fused, s);
}
