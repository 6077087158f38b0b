// K9 nearest-neighbour distances, forward only.
//
// Replaces: shapy_tpu/eval/metrics.py `_nn_dists` (:36), the core of
// `point_fscore` (:64). For each point of a (N, 3) the JAX package picks
// its nearest neighbour in b (M, 3) by the f32 expansion |a|^2 - 2 a.b +
// |b|^2, as (chunk, M) matmuls on the TPU's matrix unit and an argmin
// (first index on ties), then recomputes that one distance exactly from
// the coordinate difference, because the expansion cancels near zero.
//
// What bounds it on the H100: operations. At two SMPL-X bodies (N = M =
// 10475) the inputs are 250 KB and the output 42 KB, while the search is
// ~8 f32 operations for each of the 110 M (a, b) pairs (~13 us at 67
// TFLOP/s).
//
// Design: one thread per query point, b streamed through shared memory in
// tiles of 1024 points with their |b|^2. Each thread keeps a running
// minimum of aa - 2 * ab + bb, with ab summed x, then y, then z and no FMA
// contraction (the JAX order; 2 * ab equals the matmul of 2a with b, since
// doubling is exact), and replaces it only on a strictly smaller value, so
// ties keep the first index, as jnp.argmin and torch.argmin do. A body's
// ten thousand queries make only ~40 blocks, too few for 132 SMs, so b is
// also split into S contiguous ranges over blockIdx.y; a second launch
// merges each query's S candidates in range order (the first range wins a
// tie, so the first index overall does) and computes sqrt(max(|a - b|^2,
// 0)) for the winner.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
    nn_search_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     int N, int M, int span, float* __restrict__ best_d,
                     int* __restrict__ best_i) {
  __shared__ float bx[kTile], by[kTile], bz[kTile], bb[kTile];
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int lo = blockIdx.y * span, hi = min(M, lo + span);
  float ax = 0.f, ay = 0.f, az = 0.f;
  if (n < N) {
    ax = a[3 * n];
    ay = a[3 * n + 1];
    az = a[3 * n + 2];
  }
  const float aa = ax * ax + ay * ay + az * az;
  float best = __int_as_float(0x7f800000);  // +inf
  int best_j = 0;
  for (int base = lo; base < hi; base += kTile) {
    const int len = min(kTile, hi - base);
    for (int j = threadIdx.x; j < len; j += kThreads) {
      const float x = b[3 * (base + j)], y = b[3 * (base + j) + 1],
                  z = b[3 * (base + j) + 2];
      bx[j] = x;
      by[j] = y;
      bz[j] = z;
      bb[j] = x * x + y * y + z * z;
    }
    __syncthreads();
    for (int j = 0; j < len; ++j) {
      const float ab = ax * bx[j] + ay * by[j] + az * bz[j];
      const float d = aa - 2.f * ab + bb[j];
      if (d < best) {
        best = d;
        best_j = base + j;
      }
    }
    __syncthreads();
  }
  if (n < N) {
    best_d[(size_t)blockIdx.y * N + n] = best;
    best_i[(size_t)blockIdx.y * N + n] = best_j;
  }
}

__global__ void nn_merge_kernel(const float* __restrict__ a,
                                const float* __restrict__ b, int N, int S,
                                const float* __restrict__ best_d,
                                const int* __restrict__ best_i,
                                float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float best = __int_as_float(0x7f800000);
  int j = 0;
  for (int s = 0; s < S; ++s) {
    const float d = best_d[(size_t)s * N + n];
    if (d < best) {
      best = d;
      j = best_i[(size_t)s * N + n];
    }
  }
  const float dx = a[3 * n] - b[3 * j];
  const float dy = a[3 * n + 1] - b[3 * j + 1];
  const float dz = a[3 * n + 2] - b[3 * j + 2];
  out[n] = sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 0.f));
}

}  // namespace

// a (N, 3), b (M, 3) f32 with M >= 1; b split into S = ceil(M / span)
// ranges; best_d (S, N) f32 and best_i (S, N) int32 scratch; out (N,) f32.
// All contiguous on the device. Returns cudaGetLastError().
extern "C" int nn_dists_forward(const void* a, const void* b, void* best_d,
                                void* best_i, void* out, int N, int M,
                                int span, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int S = (M + span - 1) / span;
  nn_search_kernel<<<dim3((N + kThreads - 1) / kThreads, S), kThreads, 0,
                     s>>>((const float*)a, (const float*)b, N, M, span,
                          (float*)best_d, (int*)best_i);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  nn_merge_kernel<<<(N + 255) / 256, 256, 0, s>>>(
      (const float*)a, (const float*)b, N, S, (const float*)best_d,
      (const int*)best_i, (float*)out);
  return (int)cudaGetLastError();
}
