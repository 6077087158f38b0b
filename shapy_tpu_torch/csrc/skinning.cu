// K3 skinning, forward and backward.
//
// Replaces: the skinning contraction of shapy_tpu/models/body/lbs.py:lbs
// (lines 97-101, `T = einsum("vj,bjmn->bvmn")` then `T[..., :3, :] @
// [v_posed; 1]`), which the deleted fused Pallas LBS kernel
// (ops/lbs_pallas.py) once carried on the TPU.
//
// What bounds it on the H100: memory traffic and latency, not FLOPs. Per
// (body, vertex) it reads 12 B of v_posed and J*4 B of weights (220 B at
// J = 55) and writes 12 B, for 2*12*J + 18 FLOPs (~1.3 kFLOP). The (V, J)
// weights (2.3 MB for SMPL-X) are the same for every body and stay in the
// 50 MB L2 across the batch.
//
// Design: one thread per (body, vertex), never materialising the
// (B, V, 4, 4) per-vertex transforms that the plain version writes and
// reads back (64 B per vertex each way). A block owns 128 consecutive
// vertices of one body. Their weight rows are contiguous in memory, so the
// block loads the 128 x J tile coalesced into shared memory (row stride J
// is odd for SMPL-X, so the per-thread row reads are free of bank
// conflicts), and stages the body's J transforms (top 3x4 rows) beside it.
// Each thread accumulates sum_j w_vj A_j in 12 f32 registers and applies
// it to [v_posed; 1].
//
// Backward (skin_backward), for dv the gradient of the output:
//   d v_posed[v] = (sum_j w_vj R_j)^T dv[v], recomputing the per-vertex 3x4
//     transform in registers as the forward does;
//   d A_j = sum_v w_vj dv[v] (x) [v_posed[v]; 1], a reduction over the V
//     vertices of a body for each of its J x 12 entries.
// The reduction is two passes with fixed-order sums and no float atomics,
// so two runs give the same bits: pass 1 (one block per 128-vertex tile of
// one body, as the forward) stages the tile's outer products dv (x) [v; 1]
// in shared memory beside its weight rows, and each thread sums some of the
// J x 12 entries over the tile in vertex order into a per-tile partial;
// pass 2 sums the partials of each (body, entry) in tile order. Pass 1 is
// bound by shared-memory reads (2 per multiply-add, 12 J per vertex), not
// by device memory.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;

__global__ void skin_kernel(const float* __restrict__ weights,
                            const float* __restrict__ transforms,
                            const float* __restrict__ v_posed,
                            float* __restrict__ out, int V, int J) {
  extern __shared__ float smem[];
  float* A = smem;           // J * 12: top 3x4 of each joint transform
  float* w = smem + J * 12;  // kTile * J: this block's weight rows
  const int b = blockIdx.y;
  const int v0 = blockIdx.x * kTile;
  const int nv = min(kTile, V - v0);

  const float* tb = transforms + (size_t)b * J * 16;
  for (int i = threadIdx.x; i < J * 12; i += blockDim.x) {
    A[i] = tb[(i / 12) * 16 + i % 12];
  }
  const float* wt = weights + (size_t)v0 * J;
  for (int i = threadIdx.x; i < nv * J; i += blockDim.x) w[i] = wt[i];
  __syncthreads();

  const int t = threadIdx.x;
  if (t >= nv) return;
  float T[12];
#pragma unroll
  for (int r = 0; r < 12; ++r) T[r] = 0.f;
  const float* wv = w + t * J;
  for (int j = 0; j < J; ++j) {
    const float wj = wv[j];
    const float* Aj = A + j * 12;
#pragma unroll
    for (int r = 0; r < 12; ++r) T[r] += wj * Aj[r];
  }
  const size_t o = ((size_t)b * V + v0 + t) * 3;
  const float x = v_posed[o], y = v_posed[o + 1], z = v_posed[o + 2];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    out[o + m] = T[4 * m] * x + T[4 * m + 1] * y + T[4 * m + 2] * z +
                 T[4 * m + 3];
  }
}

__global__ void skin_backward_tile_kernel(
    const float* __restrict__ weights, const float* __restrict__ transforms,
    const float* __restrict__ v_posed, const float* __restrict__ grad_out,
    float* __restrict__ grad_v_posed, float* __restrict__ partials, int V,
    int J) {
  extern __shared__ float smem[];
  float* A = smem;                  // J * 12
  float* w = smem + J * 12;         // kTile * J
  float* g = w + kTile * J;         // kTile * 12: dv (x) [v_posed; 1]
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int v0 = tile * kTile;
  const int nv = min(kTile, V - v0);

  const float* tb = transforms + (size_t)b * J * 16;
  for (int i = threadIdx.x; i < J * 12; i += blockDim.x) {
    A[i] = tb[(i / 12) * 16 + i % 12];
  }
  const float* wt = weights + (size_t)v0 * J;
  for (int i = threadIdx.x; i < nv * J; i += blockDim.x) w[i] = wt[i];
  __syncthreads();

  const int t = threadIdx.x;
  if (t < nv) {
    float T[12];
#pragma unroll
    for (int r = 0; r < 12; ++r) T[r] = 0.f;
    const float* wv = w + t * J;
    for (int j = 0; j < J; ++j) {
      const float wj = wv[j];
      const float* Aj = A + j * 12;
#pragma unroll
      for (int r = 0; r < 12; ++r) T[r] += wj * Aj[r];
    }
    const size_t o = ((size_t)b * V + v0 + t) * 3;
    const float vh[4] = {v_posed[o], v_posed[o + 1], v_posed[o + 2], 1.f};
    const float dv[3] = {grad_out[o], grad_out[o + 1], grad_out[o + 2]};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      grad_v_posed[o + k] = T[k] * dv[0] + T[4 + k] * dv[1] + T[8 + k] * dv[2];
    }
#pragma unroll
    for (int m = 0; m < 3; ++m) {
#pragma unroll
      for (int c = 0; c < 4; ++c) g[t * 12 + m * 4 + c] = dv[m] * vh[c];
    }
  }
  __syncthreads();

  float* out = partials + ((size_t)b * gridDim.x + tile) * J * 12;
  for (int i = threadIdx.x; i < J * 12; i += blockDim.x) {
    const int j = i / 12, r = i % 12;
    float s = 0.f;
    for (int v = 0; v < nv; ++v) s += w[v * J + j] * g[v * 12 + r];
    out[i] = s;
  }
}

__global__ void skin_backward_reduce_kernel(
    const float* __restrict__ partials, float* __restrict__ grad_transforms,
    int B, int J, int tiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * J * 16) return;
  const int b = i / (J * 16), rem = i % (J * 16);
  const int j = rem / 16, e = rem % 16;
  float s = 0.f;
  if (e < 12) {  // the bottom row [0 0 0 1] gets no gradient
    const float* p = partials + (size_t)b * tiles * J * 12 + j * 12 + e;
    for (int k = 0; k < tiles; ++k) s += p[(size_t)k * J * 12];
  }
  grad_transforms[i] = s;
}

}  // namespace

// weights (V, J), transforms (B, J, 4, 4), v_posed (B, V, 3), out (B, V, 3):
// contiguous float32 on the device. Returns cudaGetLastError().
extern "C" int skin_forward(const void* weights, const void* transforms,
                            const void* v_posed, void* out, int B, int V,
                            int J, void* stream) {
  const dim3 grid((V + kTile - 1) / kTile, B);
  const size_t smem = sizeof(float) * (size_t)J * (kTile + 12);
  skin_kernel<<<grid, kTile, smem, (cudaStream_t)stream>>>(
      (const float*)weights, (const float*)transforms,
      (const float*)v_posed, (float*)out, V, J);
  return (int)cudaGetLastError();
}

// The forward's inputs and grad_out (B, V, 3) -> grad_v_posed (B, V, 3) and
// grad_transforms (B, J, 4, 4); partials (B, ceil(V / 128), J, 12) is
// scratch. Contiguous float32 on the device. Returns cudaGetLastError().
extern "C" int skin_backward(const void* weights, const void* transforms,
                             const void* v_posed, const void* grad_out,
                             void* grad_v_posed, void* partials,
                             void* grad_transforms, int B, int V, int J,
                             void* stream) {
  const int tiles = (V + kTile - 1) / kTile;
  const dim3 grid(tiles, B);
  const size_t smem = sizeof(float) * (size_t)(J * 12 + kTile * (J + 12));
  skin_backward_tile_kernel<<<grid, kTile, smem, (cudaStream_t)stream>>>(
      (const float*)weights, (const float*)transforms, (const float*)v_posed,
      (const float*)grad_out, (float*)grad_v_posed, (float*)partials, V, J);
  const int n = B * J * 16;
  skin_backward_reduce_kernel<<<(n + 255) / 256, 256, 0,
                                (cudaStream_t)stream>>>(
      (const float*)partials, (float*)grad_transforms, B, J, tiles);
  return (int)cudaGetLastError();
}
