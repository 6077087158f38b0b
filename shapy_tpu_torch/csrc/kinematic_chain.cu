// K3-chain: the kinematic chain, forward and backward.
//
// Replaces: shapy_tpu/core/kinematics.py:batch_rigid_transform (lines
// 54-104), the depth-scheduled composition of the joint tree that the JAX
// package shaped for the TPU (one batched einsum per tree level).
//
// What bounds it on the H100: latency, not bytes or FLOPs. A body is 55
// joints, 8 levels deep for SMPL-X; each level is one dependent 3x4
// composition per joint (~60 FLOP). Per body it reads 55 x 12 floats and
// writes 55 x 35. The plain PyTorch version spends ~3 launches per level.
//
// Design: one block of 64 threads per body (J <= 64). The body's rest
// joints, its local 3x4 transforms and its world 3x4 transforms live in
// shared memory. The levels are walked in order, one thread per joint of a
// level, with a barrier between levels. The bottom row of every 4x4 is the
// constant [0 0 0 1] and is never multiplied.
//
// Backward: with W_j = [M_j | t_j] the world transform, the outputs are
// posed_j = t_j, world_j = W_j and rel_j = [M_j | t_j - M_j J_j]. Each
// joint's own gradient (dM_j, dt_j) comes from those three; then the levels
// are walked in reverse and a parent pulls from its children, in the order
// of the level schedule (no float atomics: two runs give the same bits):
//   dM_p += dM_c R_c^T + dt_c a_c^T,   dt_p += dt_c,
// with a_c the child's rest offset. Then dR_j = M_p^T dM_j, da_j =
// M_p^T dt_j (the root's parent is the identity), and the rest joints get
// dJ_j = da_j - sum_{children c} da_c - M_j^T d(rel_j translation), the
// last term from rotated_rest (kinematics.py:101-102).
#include <cuda_runtime.h>

namespace {

constexpr int kMaxJoints = 64;

// Rest offset of joint j: J_j - J_parent, and J_0 for the root.
__device__ __forceinline__ void rest_offset(const float* Jr,
                                            const int* parents, int j,
                                            float* a) {
  const int p = parents[j];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a[k] = j == 0 ? Jr[j * 3 + k] : Jr[j * 3 + k] - Jr[p * 3 + k];
  }
}

__global__ void chain_forward_kernel(const float* __restrict__ rot,
                                     const float* __restrict__ joints,
                                     const int* __restrict__ parents,
                                     const int* __restrict__ order,
                                     const int* __restrict__ level_offsets,
                                     float* __restrict__ posed,
                                     float* __restrict__ rel,
                                     float* __restrict__ world, int J,
                                     int L) {
  __shared__ float Jr[kMaxJoints * 3];
  __shared__ float A[kMaxJoints * 12];  // local [R | a], row-major 3x4
  __shared__ float W[kMaxJoints * 12];  // world [M | t]
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  if (t < J) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      Jr[t * 3 + k] = joints[((size_t)b * J + t) * 3 + k];
    }
  }
  __syncthreads();
  if (t < J) {
    const float* R = rot + ((size_t)b * J + t) * 9;
    float a[3];
    rest_offset(Jr, parents, t, a);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) A[t * 12 + r * 4 + c] = R[r * 3 + c];
      A[t * 12 + r * 4 + 3] = a[r];
    }
#pragma unroll
    for (int i = 0; i < 12; ++i) W[t * 12 + i] = A[t * 12 + i];
  }
  __syncthreads();
  for (int l = 1; l < L; ++l) {
    const int i = level_offsets[l] + t;
    if (i < level_offsets[l + 1]) {
      const int j = order[i];
      const float* P = W + parents[j] * 12;
      const float* Aj = A + j * 12;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float s = P[r * 4] * Aj[c] + P[r * 4 + 1] * Aj[4 + c] +
                    P[r * 4 + 2] * Aj[8 + c];
          if (c == 3) s += P[r * 4 + 3];
          W[j * 12 + r * 4 + c] = s;
        }
      }
    }
    __syncthreads();
  }
  if (t < J) {
    const float* Wj = W + t * 12;
    const size_t o = (size_t)b * J + t;
    float* rel_j = rel + o * 16;
    float* world_j = world + o * 16;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float rotated = Wj[r * 4] * Jr[t * 3] +
                            Wj[r * 4 + 1] * Jr[t * 3 + 1] +
                            Wj[r * 4 + 2] * Jr[t * 3 + 2];
      posed[o * 3 + r] = Wj[r * 4 + 3];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        world_j[r * 4 + c] = Wj[r * 4 + c];
        rel_j[r * 4 + c] = c == 3 ? Wj[r * 4 + 3] - rotated : Wj[r * 4 + c];
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      world_j[12 + c] = c == 3 ? 1.f : 0.f;
      rel_j[12 + c] = c == 3 ? 1.f : 0.f;
    }
  }
}

__global__ void chain_backward_kernel(
    const float* __restrict__ rot, const float* __restrict__ joints,
    const float* __restrict__ world, const int* __restrict__ parents,
    const int* __restrict__ order, const int* __restrict__ level_offsets,
    const float* __restrict__ d_posed, const float* __restrict__ d_rel,
    const float* __restrict__ d_world, float* __restrict__ d_rot,
    float* __restrict__ d_joints, int J, int L) {
  __shared__ float Jr[kMaxJoints * 3];
  __shared__ float W[kMaxJoints * 12];
  __shared__ float G[kMaxJoints * 12];  // [dM | dt] of each joint
  __shared__ float Da[kMaxJoints * 3];  // gradient of each rest offset
  __shared__ float Dd[kMaxJoints * 3];  // direct rest-joint gradient
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  if (t < J) {
    const size_t o = (size_t)b * J + t;
#pragma unroll
    for (int k = 0; k < 3; ++k) Jr[t * 3 + k] = joints[o * 3 + k];
    const float* dr = d_rel + o * 16;
    const float* dw = d_world ? d_world + o * 16 : nullptr;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        W[t * 12 + r * 4 + c] = world[o * 16 + r * 4 + c];
      }
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float drt = dr[r * 4 + 3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float g = dr[r * 4 + c] - drt * joints[o * 3 + c];
        if (dw) g += dw[r * 4 + c];
        G[t * 12 + r * 4 + c] = g;
      }
      float gt = d_posed[o * 3 + r] + drt;
      if (dw) gt += dw[r * 4 + 3];
      G[t * 12 + r * 4 + 3] = gt;
    }
    // rotated_rest = M_j J_j enters rel's translation with a minus sign.
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      Dd[t * 3 + c] = -(W[t * 12 + c] * dr[3] + W[t * 12 + 4 + c] * dr[7] +
                        W[t * 12 + 8 + c] * dr[11]);
    }
  }
  __syncthreads();
  for (int l = L - 1; l >= 0; --l) {
    const int i = level_offsets[l] + t;
    if (i < level_offsets[l + 1] && l + 1 < L) {
      const int j = order[i];
      float g[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) g[k] = G[j * 12 + k];
      for (int ci = level_offsets[l + 1]; ci < level_offsets[l + 2]; ++ci) {
        const int c = order[ci];
        if (parents[c] != j) continue;
        const float* R = rot + ((size_t)b * J + c) * 9;
        const float* Gc = G + c * 12;
        float a[3];
        rest_offset(Jr, parents, c, a);
#pragma unroll
        for (int r = 0; r < 3; ++r) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            // (dM_c R_c^T)[r][k] + dt_c[r] a_c[k]
            g[r * 4 + k] += Gc[r * 4] * R[k * 3] +
                            Gc[r * 4 + 1] * R[k * 3 + 1] +
                            Gc[r * 4 + 2] * R[k * 3 + 2] +
                            Gc[r * 4 + 3] * a[k];
          }
          g[r * 4 + 3] += Gc[r * 4 + 3];
        }
      }
#pragma unroll
      for (int k = 0; k < 12; ++k) G[j * 12 + k] = g[k];
    }
    __syncthreads();
  }
  if (t < J) {
    const size_t o = (size_t)b * J + t;
    const float* Gj = G + t * 12;
    float* dR = d_rot + o * 9;
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) dR[r * 3 + c] = Gj[r * 4 + c];
        Da[r] = Gj[r * 4 + 3];
      }
    } else {
      const float* Mp = W + parents[t] * 12;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          dR[k * 3 + c] =
              Mp[k] * Gj[c] + Mp[4 + k] * Gj[4 + c] + Mp[8 + k] * Gj[8 + c];
        }
        Da[t * 3 + k] = Mp[k] * Gj[3] + Mp[4 + k] * Gj[7] + Mp[8 + k] * Gj[11];
      }
    }
  }
  __syncthreads();
  if (t < J) {
    float d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = Dd[t * 3 + k] + Da[t * 3 + k];
    for (int c = 1; c < J; ++c) {  // children in index order
      if (parents[c] != t) continue;
#pragma unroll
      for (int k = 0; k < 3; ++k) d[k] -= Da[c * 3 + k];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) d_joints[((size_t)b * J + t) * 3 + k] = d[k];
  }
}

}  // namespace

// rot (B, J, 3, 3), joints (B, J, 3) f32; parents (J,), order (J,) the
// joints level by level, level_offsets (L + 1,) int32; outputs posed
// (B, J, 3), rel and world (B, J, 4, 4) f32; all contiguous on the device.
// J <= 64. Returns cudaGetLastError().
extern "C" int chain_forward(const void* rot, const void* joints,
                             const void* parents, const void* order,
                             const void* level_offsets, void* posed, void* rel,
                             void* world, int B, int J, int L, void* stream) {
  chain_forward_kernel<<<B, kMaxJoints, 0, (cudaStream_t)stream>>>(
      (const float*)rot, (const float*)joints, (const int*)parents,
      (const int*)order, (const int*)level_offsets, (float*)posed,
      (float*)rel, (float*)world, J, L);
  return (int)cudaGetLastError();
}

// The forward's inputs and its world output; d_posed (B, J, 3), d_rel
// (B, J, 4, 4) and d_world (B, J, 4, 4, or null for zero) -> d_rot
// (B, J, 3, 3), d_joints (B, J, 3). Returns cudaGetLastError().
extern "C" int chain_backward(const void* rot, const void* joints,
                              const void* world, const void* parents,
                              const void* order, const void* level_offsets,
                              const void* d_posed, const void* d_rel,
                              const void* d_world, void* d_rot, void* d_joints,
                              int B, int J, int L, void* stream) {
  chain_backward_kernel<<<B, kMaxJoints, 0, (cudaStream_t)stream>>>(
      (const float*)rot, (const float*)joints, (const float*)world,
      (const int*)parents, (const int*)order, (const int*)level_offsets,
      (const float*)d_posed, (const float*)d_rel, (const float*)d_world,
      (float*)d_rot, (float*)d_joints, J, L);
  return (int)cudaGetLastError();
}
