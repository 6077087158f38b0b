// K3 skinning, forward and backward.
//
// Replaces: the skinning contraction of shapy_tpu/models/body/lbs.py:lbs
// (lines 97-101, `T = einsum("vj,bjmn->bvmn")` then `T[..., :3, :] @
// [v_posed; 1]`), which the deleted fused Pallas LBS kernel
// (ops/lbs_pallas.py) once carried on the TPU.
//
// What bounds it on the H100: f32 multiply-adds. Per (body, vertex) the
// forward makes 12 J of them (660 at J = 55) from 12 B of v_posed and the
// vertex's J weights; the backward twice that. The (V, J) weights (2.3 MB
// for SMPL-X) are the same for every body. Measured (PERF.md): the
// forward's staging, loads and stores take about as long as its sums and
// do not overlap them (every block of a batch fits in one wave, so all
// stage, then all sum); the sums make 7 shared loads per 48
// multiply-adds.
//
// Design. The work is a product of the (V, J) weights with each body's
// (J, 12) transforms (the top 3x4 rows), so it is tiled as a matrix
// product on the CUDA cores, in registers:
// - A block owns a tile of 128 vertices and a run of bodies, one warp a
//   body (`skin_plan` in models/body/lbs.py picks the run from the shape).
//   The tile's weight rows are copied once into shared memory, as they
//   lie (rows of stride J), by 16-byte cp.async and serve every body of
//   the run. With J odd (SMPL-X's 55) the lanes' reads of 32 rows hit
//   distinct banks.
// - Lane l of a warp owns vertices l, l + 32, l + 64, l + 96 of the tile
//   and their 4 x 12 sums in registers. Per joint it reads its 4 weights
//   and the joint's 3x4 transform as 3 float4 broadcasts: 7 shared loads
//   for 48 multiply-adds.
// - Every inner product is an explicit __fmaf_rn chain in ascending j,
//   one chain per entry (the build's --fmad=false does not touch them).
//   An output depends on nothing but its own chain, so a body's outputs
//   are the same bits whatever batch or run it shares a block with.
//
// Backward (skin_backward), for dv the gradient of the output and
// g = dv (x) [v_posed; 1] (12 products a vertex):
//   d v_posed[v] = (sum_j w_vj R_j)^T dv[v], the transform rebuilt in
//     registers as the forward builds it;
//   d A_j = sum_v w_vj g[v], a (J x V) by (V x 12) product per body.
// A block owns a run of bodies and a partition of the vertex tiles (a
// fixed number of tiles from `skin_plan`, chosen from V and J alone). For
// each tile it stages the weights (double-buffered: the next tile's copy
// overlaps this tile's work), rebuilds the transforms, writes d v_posed,
// and stages g in shared memory; then lane (q, s) of body w's warp adds
// 4 joints (q, q + nq, q + 2 nq, q + 3 nq; nq = J / 4 rounded up) x the
// 12 entries over the tile's vertices s, s + S, ... (S = 32 / nq
// sub-ranges) into 48 registers: per vertex its 4 weights and 3 float4
// broadcasts of g for 48 multiply-adds. At the end of the partition the S sub-range sums
// are added in order, and the block writes one partial per (body,
// partition). A second launch sums each (body, entry)'s partials in
// partition order. No float atomics: two calls give the same bits, and
// the order, fixed by V and J alone, is replayed in plain PyTorch by
// lbs.skin_backward_replay.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;   // vertices a tile: 32 lanes x 4
constexpr int kMaxRun = 4;   // bodies a block, one warp each (skin_plan's)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes from src, of which the first `bytes` are read and the rest
// zero.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Tile rows [v0, v0 + nv) of weights (V, J; 16-byte aligned, v0 a
// multiple of 128) into ws as they lie, nv J floats; rows [nv, kTile) are
// left as they are (their sums are never stored).
__device__ __forceinline__ void stage_weights(float* ws,
                                              const float* __restrict__ wg,
                                              int v0, int nv, int J) {
  const float* src = wg + (size_t)v0 * J;
  const int n = nv * J;
  for (int i = threadIdx.x; 4 * i < n; i += blockDim.x) {
    cp_async16(ws + 4 * i, src + 4 * i, 4 * min(4, n - 4 * i));
  }
}

// The top 3x4 rows of bodies [b0, b0 + nb)'s J transforms (16-byte
// aligned) into As (J x 12 floats a body).
__device__ __forceinline__ void stage_transforms(
    float* As, const float* __restrict__ transforms, int b0, int nb,
    int J) {
  for (int i = threadIdx.x; i < nb * J; i += blockDim.x) {
    const int r = i / J, j = i - r * J;
    const float* src = transforms + ((size_t)(b0 + r) * J + j) * 16;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      cp_async16(As + (r * J + j) * 12 + m * 4, src + m * 4);
    }
  }
}

// Joint j's 3x4 transform, 3 float4 (a broadcast: every lane of a warp
// reads the same body's).
__device__ __forceinline__ void load12(float (&a)[12], const float* A) {
  const float4* a4 = reinterpret_cast<const float4*>(A);
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const float4 r = a4[m];
    a[4 * m] = r.x;
    a[4 * m + 1] = r.y;
    a[4 * m + 2] = r.z;
    a[4 * m + 3] = r.w;
  }
}

// T[k][e] = sum_j w[v_k][j] A_j[e], v_k = this lane's k-th vertex, whose
// weight row starts at wrow + 32 k J; one __fmaf_rn chain a (k, e) in
// ascending j. A: the body's J x 12 transforms.
__device__ __forceinline__ void transform_sums(float (&T)[4][12],
                                               const float* wrow,
                                               const float* A, int J) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int e = 0; e < 12; ++e) T[k][e] = 0.f;
  }
#pragma unroll 2
  for (int j = 0; j < J; ++j) {
    float w[4], a[12];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = wrow[32 * k * J + j];
    load12(a, A + j * 12);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int e = 0; e < 12; ++e) T[k][e] = __fmaf_rn(w[k], a[e], T[k][e]);
    }
  }
}

__global__ void __launch_bounds__(32 * kMaxRun) skin_forward_kernel(
    const float* __restrict__ weights, const float* __restrict__ transforms,
    const float* __restrict__ v_posed, float* __restrict__ out, int B,
    int V, int J, int run) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;              // kTile x J
  float* As = smem + kTile * J;  // run x J x 12
  const int v0 = blockIdx.x * kTile, nv = min(kTile, V - v0);
  const int b0 = blockIdx.y * run, nb = min(run, B - b0);
  stage_weights(ws, weights, v0, nv, J);
  stage_transforms(As, transforms, b0, nb, J);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (w >= nb) return;

  const size_t o = ((size_t)(b0 + w) * V + v0) * 3;
  // v_posed's loads are issued before the sums, which hide their latency
  float vp[4][3];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int v = min(lane + 32 * k, nv - 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) vp[k][c] = v_posed[o + v * 3 + c];
  }
  float T[4][12];
  transform_sums(T, ws + lane * J, As + w * J * 12, J);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int v = lane + 32 * k;
    if (v < nv) {
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const float* t = T[k] + 4 * m;
        out[o + v * 3 + m] = __fmaf_rn(
            t[2], vp[k][2],
            __fmaf_rn(t[1], vp[k][1], __fmaf_rn(t[0], vp[k][0], t[3])));
      }
    }
  }
}

__global__ void __launch_bounds__(32 * kMaxRun, 1) skin_backward_kernel(
    const float* __restrict__ weights, const float* __restrict__ transforms,
    const float* __restrict__ v_posed, const float* __restrict__ grad_out,
    float* __restrict__ grad_v_posed, float* __restrict__ partials, int B,
    int V, int J, int run, int tiles_per_part) {
  extern __shared__ __align__(16) float smem[];
  float* ws0 = smem;                 // 2 x kTile x J: double-buffered
  float* As = smem + 2 * kTile * J;  // run x J x 12
  float* gs = As + run * J * 12;     // run x kTile x 12: dv (x) [v; 1]
  const int ntiles = (V + kTile - 1) / kTile;
  const int part = blockIdx.x, nparts = gridDim.x;
  const int t0 = part * tiles_per_part;
  const int t1 = min(ntiles, t0 + tiles_per_part);
  const int b0 = blockIdx.y * run, nb = min(run, B - b0);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // d A's lanes: joints q + nq jj over vertices s, s + S, ...
  const int nq = (J + 3) / 4, S = 32 / nq, q = lane % nq, s = lane / nq;
  const bool summing = w < nb && s < S;

  stage_transforms(As, transforms, b0, nb, J);
  stage_weights(ws0, weights, t0 * kTile, min(kTile, V - t0 * kTile), J);
  cp_async_commit();

  float acc[4][12];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int e = 0; e < 12; ++e) acc[k][e] = 0.f;
  }
  for (int t = t0; t < t1; ++t) {
    const int v0 = t * kTile, nv = min(kTile, V - v0);
    const float* ws = ws0 + (t - t0) % 2 * kTile * J;
    if (t + 1 < t1) {
      stage_weights(ws0 + (t + 1 - t0) % 2 * kTile * J, weights, v0 + kTile,
                    min(kTile, V - v0 - kTile), J);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (w < nb) {
      const size_t o = ((size_t)(b0 + w) * V + v0) * 3;
      float T[4][12];
      transform_sums(T, ws + lane * J, As + w * J * 12, J);
      float vp[4][3], dv[4][3];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int v = min(lane + 32 * k, nv - 1);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          vp[k][c] = v_posed[o + v * 3 + c];
          dv[k][c] = grad_out[o + v * 3 + c];
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int v = lane + 32 * k;
        if (v < nv) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            grad_v_posed[o + v * 3 + c] = __fmaf_rn(
                T[k][8 + c], dv[k][2],
                __fmaf_rn(T[k][4 + c], dv[k][1], T[k][c] * dv[k][0]));
          }
          float4* g = reinterpret_cast<float4*>(gs + (w * kTile + v) * 12);
#pragma unroll
          for (int m = 0; m < 3; ++m) {
            g[m] = make_float4(dv[k][m] * vp[k][0], dv[k][m] * vp[k][1],
                               dv[k][m] * vp[k][2], dv[k][m]);
          }
        }
      }
    }
    __syncthreads();

    if (summing) {
      const float* wq = ws + q;
      const float4* g = reinterpret_cast<const float4*>(gs + w * kTile * 12);
#pragma unroll 4
      for (int v = s; v < nv; v += S) {
        const float* wr = wq + v * J;
        const float wv[4] = {wr[0], wr[nq], wr[2 * nq], wr[3 * nq]};
        const float4 g0 = g[v * 3], g1 = g[v * 3 + 1], g2 = g[v * 3 + 2];
        const float ge[12] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y,
                              g1.z, g1.w, g2.x, g2.y, g2.z, g2.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int e = 0; e < 12; ++e) {
            acc[jj][e] = __fmaf_rn(wv[jj], ge[e], acc[jj][e]);
          }
        }
      }
    }
    __syncthreads();  // ws and gs are written again by the next tile
  }

  // The S sub-range sums of each (body, joint group), added in order.
  float* scratch = gs + (w * 32 + lane) * 48;
  if (summing && s > 0) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int e = 0; e < 12; ++e) scratch[jj * 12 + e] = acc[jj][e];
    }
  }
  __syncthreads();
  if (summing && s == 0) {
    for (int r = 1; r < S; ++r) {
      const float* other = gs + (w * 32 + r * nq + q) * 48;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int e = 0; e < 12; ++e) acc[jj][e] += other[jj * 12 + e];
      }
    }
    float* p = partials + (((size_t)(b0 + w) * nparts + part) * J) * 12;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = q + nq * jj;
      if (j < J) {
#pragma unroll
        for (int e = 0; e < 12; ++e) p[j * 12 + e] = acc[jj][e];
      }
    }
  }
}

// d A (B, J, 4, 4): each (body, entry)'s partials summed in partition
// order; the bottom row [0 0 0 1] gets no gradient.
__global__ void skin_backward_reduce_kernel(
    const float* __restrict__ partials, float* __restrict__ grad_transforms,
    int B, int J, int nparts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * J * 16) return;
  const int b = i / (J * 16), rem = i % (J * 16);
  const int j = rem / 16, e = rem % 16;
  float s = 0.f;
  if (e < 12) {
    const float* p = partials + (size_t)b * nparts * J * 12 + j * 12 + e;
    s = p[0];
    for (int k = 1; k < nparts; ++k) s += p[(size_t)k * J * 12];
  }
  grad_transforms[i] = s;
}

// Raises `kernel`'s dynamic shared memory to `smem` bytes where it needs
// more than the default 48 KB, once a device (as far as a launch needed).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t (&smem_set)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024 && (dev >= 64 || smem > smem_set[dev])) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) smem_set[dev] = smem;
  }
  return cudaSuccess;
}

}  // namespace

// weights (V, J) and transforms (B, J, 4, 4), both 16-byte aligned, v_posed
// (B, V, 3), out (B, V, 3): contiguous float32 on the device; a block
// takes `run` (1 .. 4) bodies of a 128-vertex tile. Returns
// cudaGetLastError().
extern "C" int skin_forward(const void* weights, const void* transforms,
                            const void* v_posed, void* out, int B, int V,
                            int J, int run, void* stream) {
  // the weight tile and the run's transforms
  const size_t smem = sizeof(float) * (size_t)(kTile * J + run * J * 12);
  static size_t smem_set[64] = {};
  const cudaError_t err = allow_smem(skin_forward_kernel, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((V + kTile - 1) / kTile, (B + run - 1) / run);
  skin_forward_kernel<<<grid, 32 * run, smem, (cudaStream_t)stream>>>(
      (const float*)weights, (const float*)transforms,
      (const float*)v_posed, (float*)out, B, V, J, run);
  return (int)cudaGetLastError();
}

// The forward's inputs and grad_out (B, V, 3) -> grad_v_posed (B, V, 3)
// and grad_transforms (B, J, 4, 4); partials (B, parts, J, 12) is
// scratch, parts = ceil(ceil(V / 128) / tiles_per_part). A block takes
// `run` (1 .. 4) bodies of `tiles_per_part` 128-vertex tiles. Contiguous
// float32 on the device. Returns cudaGetLastError().
extern "C" int skin_backward(const void* weights, const void* transforms,
                             const void* v_posed, const void* grad_out,
                             void* grad_v_posed, void* partials,
                             void* grad_transforms, int B, int V, int J,
                             int run, int tiles_per_part, void* stream) {
  const int ntiles = (V + kTile - 1) / kTile;
  const int parts = (ntiles + tiles_per_part - 1) / tiles_per_part;
  // two weight tiles, the run's transforms and its g rows
  const size_t smem = sizeof(float) * (size_t)(2 * kTile * J + run * J * 12 +
                                               run * kTile * 12);
  static size_t smem_set[64] = {};
  const cudaError_t err = allow_smem(skin_backward_kernel, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(parts, (B + run - 1) / run);
  skin_backward_kernel<<<grid, 32 * run, smem, (cudaStream_t)stream>>>(
      (const float*)weights, (const float*)transforms, (const float*)v_posed,
      (const float*)grad_out, (float*)grad_v_posed, (float*)partials, B, V,
      J, run, tiles_per_part);
  const int n = B * J * 16;
  skin_backward_reduce_kernel<<<(n + 255) / 256, 256, 0,
                                (cudaStream_t)stream>>>(
      (const float*)partials, (float*)grad_transforms, B, J, parts);
  return (int)cudaGetLastError();
}
