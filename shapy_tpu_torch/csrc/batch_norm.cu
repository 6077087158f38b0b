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
// Each direction is three launches. (1) Per-channel partial sums over
// tiles of rows: a block of 32 channel lanes x 8 row lanes, a warp reading
// 32 neighbouring channels of one row; each thread sums its rows in order,
// then the 8 row lanes are summed in order. (2) One block per 32 channels
// sums the partials in tile order (8 lanes over strided tiles, then the
// lanes in order), and derives the per-channel coefficients (and, in the
// forward, updates the running stats). (3) An elementwise pass. No float
// atomics: two runs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// Pass 1 of the backward: per tile, sum dy and sum dy * x_hat.
template <typename T>
__global__ void grads_partial_kernel(const T* __restrict__ dy,
                                     const T* __restrict__ x,
                                     const float* __restrict__ mean,
                                     const float* __restrict__ inv,
                                     float* __restrict__ partials, int R,
                                     int C, int rows_per_tile) {
  __shared__ float ss[kRows][kLanes + 1], sq[kRows][kLanes + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.y * kLanes + tx;
  const int r0 = blockIdx.x * rows_per_tile;
  const int r1 = min(R, r0 + rows_per_tile);
  float s = 0.f, q = 0.f;
  if (c < C) {
    const float m = rnd<T>(mean[c]), iv = rnd<T>(inv[c]);
    for (int r = r0 + ty; r < r1; r += kRows) {
      const size_t i = (size_t)r * C + c;
      const float d = load(dy, i);
      s += d;
      q += d * xhat<T>(load(x, i), m, iv);
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

// Pass 2 of the backward: dgamma, dbeta and the dx coefficients
// coef (3, C) = [mean(dy), mean(dy x_hat), gamma * inv].
template <typename T>
__global__ void grads_finalize_kernel(const float* __restrict__ partials,
                                      int tiles, int C, float n,
                                      const float* __restrict__ gamma,
                                      const float* __restrict__ inv,
                                      float* __restrict__ dgamma,
                                      float* __restrict__ dbeta,
                                      float* __restrict__ coef) {
  const int c = blockIdx.x * kLanes + threadIdx.x;
  float sdy, sdyx;
  sum_partials(partials, tiles, C, c, &sdy, &sdyx);
  if (threadIdx.y != 0 || c >= C) return;
  dgamma[c] = sdyx;
  dbeta[c] = sdy;
  coef[c] = sdy / n;
  coef[C + c] = sdyx / n;
  coef[2 * C + c] = gamma[c] * rnd<T>(inv[c]);
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

// Pass 3 of the backward: dx = (gamma inv) * ((dy - mean(dy)) - x_hat *
// mean(dy x_hat)), each operation rounded to the activation dtype.
template <typename T>
__global__ void dx_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                          const float* __restrict__ mean,
                          const float* __restrict__ inv,
                          const float* __restrict__ coef, T* __restrict__ dx,
                          unsigned R, unsigned C) {
  const size_t total = (size_t)R * C;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const unsigned c = (unsigned)(i % C);
    const float h = xhat<T>(load(x, i), rnd<T>(mean[c]), rnd<T>(inv[c]));
    const float a = rnd<T>(load(dy, i) - rnd<T>(coef[c]));
    const float b = rnd<T>(h * rnd<T>(coef[C + c]));
    store(dx, i, rnd<T>(coef[2 * C + c]) * rnd<T>(a - b));
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

template <typename T>
int backward(const void* dy, const void* x, const void* gamma,
             const void* mean, const void* inv, void* partials, void* coef,
             void* dgamma, void* dbeta, void* dx, int R, int C, int tiles,
             int rows_per_tile, cudaStream_t stream) {
  const dim3 block(kLanes, kRows);
  const int cblocks = (C + kLanes - 1) / kLanes;
  grads_partial_kernel<T><<<dim3(tiles, cblocks), block, 0, stream>>>(
      (const T*)dy, (const T*)x, (const float*)mean, (const float*)inv,
      (float*)partials, R, C, rows_per_tile);
  grads_finalize_kernel<T><<<cblocks, block, 0, stream>>>(
      (const float*)partials, tiles, C, (float)R, (const float*)gamma,
      (const float*)inv, (float*)dgamma, (float*)dbeta, (float*)coef);
  dx_kernel<T><<<elementwise_blocks((size_t)R * C), 256, 0, stream>>>(
      (const T*)dy, (const T*)x, (const float*)mean, (const float*)inv,
      (const float*)coef, (T*)dx, R, C);
  return (int)cudaGetLastError();
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
// partials (tiles, C, 2) and coef (3, C) f32 scratch; dgamma, dbeta (C,)
// f32 outputs. Returns cudaGetLastError().
extern "C" int bn_backward(const void* dy, const void* x, const void* gamma,
                           const void* mean, const void* inv, void* partials,
                           void* coef, void* dgamma, void* dbeta, void* dx,
                           int R, int C, int tiles, int rows_per_tile,
                           int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? backward<__nv_bfloat16>(dy, x, gamma, mean, inv, partials,
                                           coef, dgamma, dbeta, dx, R, C,
                                           tiles, rows_per_tile, s)
                 : backward<float>(dy, x, gamma, mean, inv, partials, coef,
                                   dgamma, dbeta, dx, R, C, tiles,
                                   rows_per_tile, s);
}
