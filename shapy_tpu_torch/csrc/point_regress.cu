// K8a P2P-20k point error, forward only.
//
// Replaces: shapy_tpu/eval/metrics.py `SparsePointRegressor.regress`
// (:228, a padded (P, K) gather of (B, V, 3) vertices and a weighted sum
// over K) and `SparsePointRegressor.__call__` (:233-245: regress the
// prediction with one regressor and the ground truth with the same or a
// target regressor, translate the first point set onto the second's mean,
// per-point distance). The JAX package chose the padded gather over a
// sparse matmul for the TPU; XLA ran it as gathers and reductions.
//
// What bounds it on the H100: memory. At the evaluator's shapes (B = 32,
// V = 10475, P = 20000, K = 3) it must read the two vertex sets (8.0 MB)
// and the indices and weights (0.48 MB), and write (B, P) f32 errors
// (2.56 MB): 11.1 MB, ~3.3 us at 3.35 TB/s; ~1.2 MFLOP per body.
//
// Design: two launches over tiles of 256 points of one body. A body's
// regressed points (2 x 240 KB) do not fit in shared memory, and across
// blocks nothing is ordered, so the translation (the difference of the
// two sets' means) needs a pass of its own. Pass 1: each block regresses
// its tile for both meshes and writes the tile's six coordinate sums, in
// double and in a fixed reduction order, to a (B, tiles, 6) buffer. Pass 2:
// each block sums its body's tile partials in tile order (the same order
// in every block, so all blocks agree to the bit, and so do runs: no
// float atomics), regresses its tile again from the vertices, which stay
// in the 50 MB L2, rather than spilling 15 MB of points to memory and
// back, and writes |p1 + t - p2|. With align = 0 pass 1 is skipped.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;
constexpr int kWarps = kTile / 32;

__device__ __forceinline__ void regress_point(
    const float* __restrict__ verts, const int* __restrict__ idx,
    const float* __restrict__ w, int K, int p, float* out) {
  float x = 0.f, y = 0.f, z = 0.f;
  for (int k = 0; k < K; ++k) {
    const int v = idx[p * K + k];
    const float wk = w[p * K + k];
    x += wk * verts[v * 3];
    y += wk * verts[v * 3 + 1];
    z += wk * verts[v * 3 + 2];
  }
  out[0] = x;
  out[1] = y;
  out[2] = z;
}

__global__ void regress_sums_kernel(const float* __restrict__ v_in,
                                    const float* __restrict__ v_tgt,
                                    const int* __restrict__ idx1,
                                    const float* __restrict__ w1, int K1,
                                    const int* __restrict__ idx2,
                                    const float* __restrict__ w2, int K2,
                                    int V1, int V2, int P,
                                    double* __restrict__ partials) {
  __shared__ double red[6 * kWarps];
  const int b = blockIdx.y;
  const int p = blockIdx.x * kTile + threadIdx.x;
  double s[6] = {0, 0, 0, 0, 0, 0};
  if (p < P) {
    float p1[3], p2[3];
    regress_point(v_in + (size_t)b * V1 * 3, idx1, w1, K1, p, p1);
    regress_point(v_tgt + (size_t)b * V2 * 3, idx2, w2, K2, p, p2);
    for (int k = 0; k < 3; ++k) {
      s[k] = p1[k];
      s[3 + k] = p2[k];
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    double x = s[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) red[i * kWarps + warp] = x;
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    double t = 0.0;
    for (int w = 0; w < kWarps; ++w) t += red[threadIdx.x * kWarps + w];
    partials[((size_t)b * gridDim.x + blockIdx.x) * 6 + threadIdx.x] = t;
  }
}

__global__ void regress_error_kernel(const float* __restrict__ v_in,
                                     const float* __restrict__ v_tgt,
                                     const int* __restrict__ idx1,
                                     const float* __restrict__ w1, int K1,
                                     const int* __restrict__ idx2,
                                     const float* __restrict__ w2, int K2,
                                     int V1, int V2, int P,
                                     const double* __restrict__ partials,
                                     int align, float* __restrict__ out) {
  __shared__ float shift[3];
  const int b = blockIdx.y;
  if (threadIdx.x < 3) {
    float t = 0.f;
    if (align) {
      const int k = threadIdx.x;
      const double* pb = partials + (size_t)b * gridDim.x * 6;
      double s1 = 0.0, s2 = 0.0;
      for (int i = 0; i < (int)gridDim.x; ++i) {
        s1 += pb[i * 6 + k];
        s2 += pb[i * 6 + 3 + k];
      }
      // The plain version's order: mean(p2) - mean(p1), each in float.
      t = (float)(s2 / P) - (float)(s1 / P);
    }
    shift[threadIdx.x] = t;
  }
  __syncthreads();
  const int p = blockIdx.x * kTile + threadIdx.x;
  if (p >= P) return;
  float p1[3], p2[3];
  regress_point(v_in + (size_t)b * V1 * 3, idx1, w1, K1, p, p1);
  regress_point(v_tgt + (size_t)b * V2 * 3, idx2, w2, K2, p, p2);
  const float dx = (p1[0] + shift[0]) - p2[0];
  const float dy = (p1[1] + shift[1]) - p2[1];
  const float dz = (p1[2] + shift[2]) - p2[2];
  out[(size_t)b * P + p] = sqrtf(dx * dx + dy * dy + dz * dz);
}

}  // namespace

// v_in (B, V1, 3), v_tgt (B, V2, 3) f32; idx1 (P, K1) int32 and w1 (P, K1)
// f32 regress v_in, idx2 (P, K2) and w2 (P, K2) regress v_tgt; partials
// (B, ceil(P / 256), 6) f64 scratch; out (B, P) f32. All contiguous on the
// device, indices inside [0, V). Returns cudaGetLastError().
extern "C" int point_regress_forward(const void* v_in, const void* v_tgt,
                                     const void* idx1, const void* w1,
                                     const void* idx2, const void* w2,
                                     void* partials, void* out, int B, int V1,
                                     int V2, int P, int K1, int K2, int align,
                                     void* stream) {
  const dim3 grid((P + kTile - 1) / kTile, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (align) {
    regress_sums_kernel<<<grid, kTile, 0, s>>>(
        (const float*)v_in, (const float*)v_tgt, (const int*)idx1,
        (const float*)w1, K1, (const int*)idx2, (const float*)w2, K2, V1, V2,
        P, (double*)partials);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  regress_error_kernel<<<grid, kTile, 0, s>>>(
      (const float*)v_in, (const float*)v_tgt, (const int*)idx1,
      (const float*)w1, K1, (const int*)idx2, (const float*)w2, K2, V1, V2, P,
      (const double*)partials, align, (float*)out);
  return (int)cudaGetLastError();
}
