// K3 skinning, forward only.
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
