// K3-chain: the kinematic chain, forward and backward.
//
// Replaces: shapy_tpu/core/kinematics.py:batch_rigid_transform (lines
// 54-104), the depth-scheduled composition of the joint tree that the JAX
// package shaped for the TPU (one batched einsum per tree level).
//
// What bounds it on the H100: latency, not bytes or FLOPs. A body is at
// most 64 joints: SMPL-X's 55 are 6 levels deep on the synthetic tree
// (models/body/assets.py: a binary tree) and 11 on the published one
// (pelvis, spine, collar, shoulder, elbow, wrist, three finger joints);
// each level is one dependent 3x4 composition per joint (~60 FLOP). A body
// reads 55 x 12 floats and writes 55 x 35: at batch 48 the forward moves
// 0.5 MB, ~0.15 us at 3.35 TB/s, less than a launch costs.
//
// Design: the tree is packed once per tree on the host
// (core/kinematics.py:_schedule) into a Schedule passed by value as a
// __grid_constant__ parameter: each joint's parent, depth (its level) and
// children (CSR, in index order) in one word; no level reads an index
// from global memory. A block of 64 threads takes a body, a thread a
// joint: on an H100 that measured faster than a warp a body (two joints a
// lane, __syncwarp between levels, four bodies a forward block and two a
// backward one), which runs more levels' work a thread on fewer SMs
// (PERF.md). The body's inputs are staged into shared memory once by
// cp.async (16 bytes where aligned) and the outputs leave from shared
// memory as contiguous rows (the 4x4 ones as float4). The levels are
// walked in order with only a barrier between them; a joint composes its
// parent's world transform with its own local one, held in registers.
// The bottom row of every 4x4 is the constant [0 0 0 1] and is never
// multiplied.
//
// Backward: with W_j = [M_j | t_j] the world transform, the outputs are
// posed_j = t_j, world_j = W_j and rel_j = [M_j | t_j - M_j J_j]. Each
// joint's own gradient (dM_j, dt_j) comes from those three; then the levels
// are walked in reverse and a parent adds its children's, each child in
// index order from its CSR list:
//   dM_p += dM_c R_c^T + dt_c a_c^T,   dt_p += dt_c,
// with a_c the child's rest offset. Then dR_j = M_p^T dM_j, da_j =
// M_p^T dt_j (the root's parent is the identity), and the rest joints get
// dJ_j = da_j - sum_{children c} da_c - M_j^T d(rel_j translation), the
// last term from rotated_rest (kinematics.py:101-102). No atomics and a
// fixed order: two runs give the same bits, and a body's bits do not
// depend on its batch.
//
// Built with --fmad=false: every product and sum rounds as written, and
// core/kinematics.py:chain_forward_replay / chain_backward_replay repeat
// the same operations in plain PyTorch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxJoints = 64;  // a thread a joint, a block a body

// The tree. node[j]: the parent + 1 (0 for the root, joint 0), the depth,
// the first child's slot in children[] and the number of children, a byte
// each from the lowest.
struct Schedule {
  int J, L;  // joints, levels
  uint32_t node[kMaxJoints];
  uint8_t children[kMaxJoints];  // each joint's children in index order
};
static_assert(sizeof(Schedule) == 328, "core/kinematics.py packs 328 bytes");

struct Node {
  int parent, depth, first, count;
};
__device__ __forceinline__ Node node(const Schedule& s, int j) {
  const uint32_t w = s.node[j];
  return {(int)(w & 0xFF) - 1, (int)(w >> 8 & 0xFF), (int)(w >> 16 & 0xFF),
          (int)(w >> 24)};
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// n floats from src (global) to dst (shared, 16-byte aligned) by the
// block's threads, as 16-byte copies where src is 16-byte aligned; the
// caller waits (cp.async.wait_all) and synchronises. Here and below the
// strided loops step by blockDim.x (64), read at run time: stepping by
// the constant measured 0.2 us slower in the forward and 0.8 in the
// backward on an H100 (PERF.md).
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  int done = 0;
  if (((uintptr_t)src & 15) == 0) {
    done = n & ~3;
    for (int i = 4 * threadIdx.x; i < done; i += 4 * blockDim.x) {
      cp_async16(dst + i, src + i);
    }
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) {
    cp_async4(dst + i, src + i);
  }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

__global__ void __launch_bounds__(kMaxJoints)
    chain_forward_kernel(const float* __restrict__ rot,
                         const float* __restrict__ joints,
                         float* __restrict__ posed, float* __restrict__ rel,
                         float* __restrict__ world,
                         const __grid_constant__ Schedule s) {
  __shared__ __align__(16) float Rs[kMaxJoints * 9];   // rotations
  __shared__ __align__(16) float Js[kMaxJoints * 3];   // rest joints
  __shared__ __align__(16) float Ws[kMaxJoints * 12];  // world [M | t], 3x4
  const int J = s.J, b = blockIdx.x, j = threadIdx.x;
  stage(Rs, rot + (size_t)b * J * 9, J * 9);
  stage(Js, joints + (size_t)b * J * 3, J * 3);
  stage_wait();

  float A[12];  // the joint's local [R | a]
  Node nd = {0, -1, 0, 0};
  if (j < J) {
    nd = node(s, j);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) A[r * 4 + c] = Rs[j * 9 + r * 3 + c];
      A[r * 4 + 3] = j == 0 ? Js[r] : Js[j * 3 + r] - Js[nd.parent * 3 + r];
    }
    if (j == 0) {
#pragma unroll
      for (int i = 0; i < 12; ++i) Ws[i] = A[i];
    }
  }
  __syncthreads();
  for (int l = 1; l < s.L; ++l) {
    if (nd.depth == l) {
      const float* P = Ws + nd.parent * 12;
      float* Wj = Ws + j * 12;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float v = P[r * 4] * A[c] + P[r * 4 + 1] * A[4 + c] +
                    P[r * 4 + 2] * A[8 + c];
          if (c == 3) v += P[r * 4 + 3];
          Wj[r * 4 + c] = v;
        }
      }
    }
    __syncthreads();
  }

  float* posed_b = posed + (size_t)b * J * 3;
  for (int i = j; i < J * 3; i += blockDim.x) {
    posed_b[i] = Ws[i / 3 * 12 + i % 3 * 4 + 3];
  }
  float4* rel4 = reinterpret_cast<float4*>(rel + (size_t)b * J * 16);
  float4* world4 = reinterpret_cast<float4*>(world + (size_t)b * J * 16);
  for (int i = j; i < J * 4; i += blockDim.x) {
    const int q = i >> 2, r = i & 3;  // joint q, row r
    float4 w = make_float4(0.f, 0.f, 0.f, 1.f), e = w;
    if (r < 3) {
      const float* Wq = Ws + q * 12 + r * 4;
      const float* Jq = Js + q * 3;
      const float rotated = Wq[0] * Jq[0] + Wq[1] * Jq[1] + Wq[2] * Jq[2];
      w = make_float4(Wq[0], Wq[1], Wq[2], Wq[3]);
      e = make_float4(Wq[0], Wq[1], Wq[2], Wq[3] - rotated);
    }
    world4[i] = w;
    rel4[i] = e;
  }
}

__global__ void __launch_bounds__(kMaxJoints)
    chain_backward_kernel(const float* __restrict__ rot,
                          const float* __restrict__ joints,
                          const float* __restrict__ world,
                          const float* __restrict__ d_posed,
                          const float* __restrict__ d_rel,
                          const float* __restrict__ d_world,
                          float* __restrict__ d_rot,
                          float* __restrict__ d_joints,
                          const __grid_constant__ Schedule s) {
  constexpr int kN = kMaxJoints;
  __shared__ __align__(16) float Rs[kN * 9];   // rotations, then d_rot
  __shared__ __align__(16) float Js[kN * 3];   // rest joints, then d_joints
  __shared__ __align__(16) float Ws[kN * 16];  // world
  __shared__ __align__(16) float Dp[kN * 3];   // d_posed
  __shared__ __align__(16) float Dr[kN * 16];  // d_rel
  __shared__ __align__(16) float Dw[kN * 16];  // d_world
  __shared__ float Gs[kN * 12];  // [dM | dt]: own, then with the subtree's
  __shared__ float Da[kN * 3];   // gradient of each rest offset
  const int J = s.J, b = blockIdx.x, j = threadIdx.x;
  const size_t o9 = (size_t)b * J * 9, o3 = (size_t)b * J * 3,
               o16 = (size_t)b * J * 16;
  stage(Rs, rot + o9, J * 9);
  stage(Js, joints + o3, J * 3);
  stage(Ws, world + o16, J * 16);
  stage(Dp, d_posed + o3, J * 3);
  stage(Dr, d_rel + o16, J * 16);
  if (d_world) stage(Dw, d_world + o16, J * 16);
  stage_wait();

  float G[12], Dd[3];
  Node nd = {0, -1, 0, 0};
  if (j < J) {
    nd = node(s, j);
    const float* dr = Dr + j * 16;
    const float* dw = Dw + j * 16;
    const float* M = Ws + j * 16;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float drt = dr[r * 4 + 3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float g = dr[r * 4 + c] - drt * Js[j * 3 + c];
        if (d_world) g += dw[r * 4 + c];
        G[r * 4 + c] = g;
      }
      float gt = Dp[j * 3 + r] + drt;
      if (d_world) gt += dw[r * 4 + 3];
      G[r * 4 + 3] = gt;
    }
    // rotated_rest = M_j J_j enters rel's translation with a minus sign.
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      Dd[c] = -(M[c] * dr[3] + M[4 + c] * dr[7] + M[8 + c] * dr[11]);
    }
#pragma unroll
    for (int i = 0; i < 12; ++i) Gs[j * 12 + i] = G[i];
  }
  __syncthreads();
  // Reverse levels: a joint adds its children's (complete) gradients.
  for (int l = s.L - 2; l >= 0; --l) {
    if (nd.depth == l && nd.count > 0) {
      for (int n = 0; n < nd.count; ++n) {
        const int c = s.children[nd.first + n];
        const float* R = Rs + c * 9;
        const float* Gc = Gs + c * 12;
        float a[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) a[i] = Js[c * 3 + i] - Js[j * 3 + i];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            // (dM_c R_c^T)[r][i] + dt_c[r] a_c[i]
            G[r * 4 + i] += Gc[r * 4] * R[i * 3] + Gc[r * 4 + 1] * R[i * 3 + 1] +
                            Gc[r * 4 + 2] * R[i * 3 + 2] + Gc[r * 4 + 3] * a[i];
          }
          G[r * 4 + 3] += Gc[r * 4 + 3];
        }
      }
#pragma unroll
      for (int i = 0; i < 12; ++i) Gs[j * 12 + i] = G[i];
    }
    __syncthreads();
  }
  // dR_j = M_p^T dM_j and da_j = M_p^T dt_j; rot is read no more, so d_rot
  // takes its place.
  if (nd.depth >= 0) {
    float* dR = Rs + j * 9;
    if (nd.parent < 0) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) dR[r * 3 + c] = G[r * 4 + c];
        Da[j * 3 + r] = G[r * 4 + 3];
      }
    } else {
      const float* Mp = Ws + nd.parent * 16;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          dR[i * 3 + c] = Mp[i] * G[c] + Mp[4 + i] * G[4 + c] +
                          Mp[8 + i] * G[8 + c];
        }
        Da[j * 3 + i] = Mp[i] * G[3] + Mp[4 + i] * G[7] + Mp[8 + i] * G[11];
      }
    }
  }
  __syncthreads();
  // dJ_j = Dd_j + da_j - the children's da, in index order; the rest
  // joints are read no more, so d_joints takes their place.
  if (nd.depth >= 0) {
    float d[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) d[i] = Dd[i] + Da[j * 3 + i];
    for (int n = 0; n < nd.count; ++n) {
      const int c = s.children[nd.first + n];
#pragma unroll
      for (int i = 0; i < 3; ++i) d[i] -= Da[c * 3 + i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) Js[j * 3 + i] = d[i];
  }
  __syncthreads();
  for (int i = j; i < J * 9; i += blockDim.x) d_rot[o9 + i] = Rs[i];
  for (int i = j; i < J * 3; i += blockDim.x) d_joints[o3 + i] = Js[i];
}

}  // namespace

// rot (B, J, 3, 3), joints (B, J, 3) f32, contiguous on the device;
// schedule a host pointer to the packed tree (328 bytes, J <= 64); outputs
// posed (B, J, 3), rel and world (B, J, 4, 4) f32. Returns
// cudaGetLastError().
extern "C" int chain_forward(const void* rot, const void* joints, void* posed,
                             void* rel, void* world, int B,
                             const void* schedule, void* stream) {
  const Schedule s = *(const Schedule*)schedule;
  chain_forward_kernel<<<B, kMaxJoints, 0, (cudaStream_t)stream>>>(
      (const float*)rot, (const float*)joints, (float*)posed, (float*)rel,
      (float*)world, s);
  return (int)cudaGetLastError();
}

// The forward's inputs and its world output; d_posed (B, J, 3), d_rel
// (B, J, 4, 4) and d_world (B, J, 4, 4, or null for zero) -> d_rot
// (B, J, 3, 3), d_joints (B, J, 3). Returns cudaGetLastError().
extern "C" int chain_backward(const void* rot, const void* joints,
                              const void* world, const void* d_posed,
                              const void* d_rel, const void* d_world,
                              void* d_rot, void* d_joints, int B,
                              const void* schedule, void* stream) {
  const Schedule s = *(const Schedule*)schedule;
  chain_backward_kernel<<<B, kMaxJoints, 0, (cudaStream_t)stream>>>(
      (const float*)rot, (const float*)joints, (const float*)world,
      (const float*)d_posed, (const float*)d_rel, (const float*)d_world,
      (float*)d_rot, (float*)d_joints, s);
  return (int)cudaGetLastError();
}
