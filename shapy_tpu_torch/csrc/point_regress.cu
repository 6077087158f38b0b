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
// (2.56 MB): 11.1 MB, ~3.3 us at 3.35 TB/s; ~1.2 MFLOP per body. What
// stands between it and that: each point gathers K random 12-byte
// vertices of each mesh.
//
// Design: one launch, a thread-block cluster per body (grid (cluster, B)),
// its size from regress_plan in eval/metrics.py (the shape alone: at most
// the portable 8 CTAs); CTA r takes the contiguous run of row slots
// [r span, (r + 1) span).
//   * Each point is regressed once, for both meshes, into shared memory
//     (24 B a point, ~60 KB at the evaluator's shapes), in the plain
//     version's order (x = 0; x += w_k v_k, built with --fmad=false).
//   * The translation's six coordinate sums are taken in double: per
//     thread in slot order, a fixed warp-shuffle tree, the warps in order,
//     then every CTA stores its partials into every rank's shared memory
//     (distributed shared memory) and, after the cluster's barrier, each
//     sums the ranks in rank order: the same bits in every rank and every
//     run (no atomics). align = 0 skips them.
//   * The distances |p1 + t - p2| are written from shared memory: nothing
//     is regressed twice, no partials go through device memory, one
//     launch.
//   * The gathers: SparsePointRegressor sorts its rows once, by their
//     first vertex, so that a warp's neighbouring slots gather neighbouring
//     vertices (the L1 serves most of them); `order` maps slot j to its
//     row, where its error is written (null: the identity).
// Rank 0 also writes each body's six totals (B, 6) so that a caller can
// hold the reduction order against a replay of it
// (metrics.regress_sums_replay).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 512 threads: the gathers are bound by latency, so each thread takes
// fewer points (~5 at the evaluator's shapes) and more are in flight.
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;

struct Shared {
  double red[6 * kWarps];
  double peer[kMaxCluster][6];  // from each rank r, stored by rank r
  double mine[6];
  double tot[6];
  float shift[4];
};
static_assert(sizeof(Shared) % 16 == 0, "the regressed points follow");

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void st_cluster(double* local, unsigned rank,
                                           double v) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(local);
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.f64 [%0], %1;\n" ::"r"(remote), "d"(v)
               : "memory");
}

// The vertex v of a mesh, coordinate c.
__device__ __forceinline__ float vertex(const float* __restrict__ verts,
                                        int v, int c) {
  return __ldg(verts + v * 3 + c);
}

__device__ __forceinline__ void regress_point(
    const float* __restrict__ verts, const int* __restrict__ idx,
    const float* __restrict__ w, int K, int j, float* out) {
  float x = 0.f, y = 0.f, z = 0.f;
  for (int k = 0; k < K; ++k) {
    const int v = __ldg(idx + j * K + k);
    const float wk = __ldg(w + j * K + k);
    x += wk * vertex(verts, v, 0);
    y += wk * vertex(verts, v, 1);
    z += wk * vertex(verts, v, 2);
  }
  out[0] = x;
  out[1] = y;
  out[2] = z;
}

__global__ void __launch_bounds__(kThreads) regress_cluster_kernel(
    const float* __restrict__ v_in, const float* __restrict__ v_tgt,
    const int* __restrict__ idx1, const float* __restrict__ w1, int K1,
    const int* __restrict__ idx2, const float* __restrict__ w2, int K2,
    int V1, int V2, int P, int span, const int* __restrict__ order,
    int align, double* __restrict__ sums, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  float* p1 = reinterpret_cast<float*>(smem + sizeof(Shared));
  float* p2 = p1 + 3 * span;
  const unsigned rank = blockIdx.x, ranks = gridDim.x;  // the cluster
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const bool clustered = ranks > 1;
  if (clustered) cluster_arrive_relaxed();
  const int lo = min(P, (int)rank * span);
  const int n = min(P, lo + span) - lo;
  const float* vi = v_in + (size_t)b * V1 * 3;
  const float* vt = v_tgt + (size_t)b * V2 * 3;
  double s[6] = {0, 0, 0, 0, 0, 0};
  for (int j = tid; j < n; j += kThreads) {
    float* a = p1 + 3 * j;
    float* c = p2 + 3 * j;
    regress_point(vi, idx1, w1, K1, lo + j, a);
    regress_point(vt, idx2, w2, K2, lo + j, c);
    if (align) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s[k] += a[k];
        s[3 + k] += c[k];
      }
    }
  }
  if (tid < 6) sh.tot[tid] = 0.0;
  if (tid < 4) sh.shift[tid] = 0.f;
  if (clustered) cluster_wait();  // every rank has started
  __syncthreads();
  if (align) {
    // The block's sums in a fixed order (shuffle tree, warps in order).
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s[i] += __shfl_down_sync(0xffffffffu, s[i], o);
      }
      if (lane == 0) sh.red[i * kWarps + warp] = s[i];
    }
    __syncthreads();
    if (tid < 6) {
      double t = 0.0;
      for (int w = 0; w < kWarps; ++w) t += sh.red[tid * kWarps + w];
      sh.mine[tid] = t;
    }
    __syncthreads();
    if (clustered) {
      if (tid < 6 * (int)ranks) {
        st_cluster(&sh.peer[rank][tid % 6], tid / 6, sh.mine[tid % 6]);
      }
      cluster_sync();  // every rank's partials are here
    }
    if (tid < 6) {
      double t = 0.0;
      for (unsigned r = 0; r < ranks; ++r) {
        t += clustered ? sh.peer[r][tid] : sh.mine[tid];
      }
      sh.tot[tid] = t;
    }
    __syncthreads();
    if (tid < 3) {
      // The plain version's order: mean(p2) - mean(p1), each in float.
      sh.shift[tid] = (float)(sh.tot[3 + tid] / P) -
                      (float)(sh.tot[tid] / P);
    }
    __syncthreads();
  }
  if (rank == 0 && tid < 6) sums[(size_t)b * 6 + tid] = sh.tot[tid];
  const float tx = sh.shift[0], ty = sh.shift[1], tz = sh.shift[2];
  float* ob = out + (size_t)b * P;
  for (int j = tid; j < n; j += kThreads) {
    const float* a = p1 + 3 * j;
    const float* c = p2 + 3 * j;
    const float dx = (a[0] + tx) - c[0];
    const float dy = (a[1] + ty) - c[1];
    const float dz = (a[2] + tz) - c[2];
    ob[order ? __ldg(order + lo + j) : lo + j] =
        sqrtf(dx * dx + dy * dy + dz * dz);
  }
}

}  // namespace

// v_in (B, V1, 3), v_tgt (B, V2, 3) f32; idx1 (P, K1) int32 and w1 (P, K1)
// f32 regress v_in, idx2 (P, K2) and w2 (P, K2) regress v_tgt, rows in slot
// order; order (P,) int32, slot j's row (null: the identity); sums (B, 6)
// f64; out (B, P) f32. A cluster of `cluster` (1 to 8) CTAs a body, each
// `span` slots (span * cluster >= P). All contiguous on the device,
// indices inside [0, V). Returns cudaGetLastError().
extern "C" int point_regress_forward(const void* v_in, const void* v_tgt,
                                     const void* idx1, const void* w1,
                                     const void* idx2, const void* w2,
                                     const void* order, void* sums, void* out,
                                     int B, int V1, int V2, int P, int K1,
                                     int K2, int cluster, int span, int align,
                                     void* stream) {
  if (B < 1 || B > 65535 || P < 1 || cluster < 1 || cluster > kMaxCluster ||
      span < 1 || (long long)span * cluster < P) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(Shared) + (size_t)6 * span * sizeof(float);
  // Per device: the shared memory raised as far as a launch needed.
  static size_t smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && (dev >= 64 || smem > smem_set[dev])) {
    err = cudaFuncSetAttribute(regress_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(
      &cfg, regress_cluster_kernel, (const float*)v_in, (const float*)v_tgt,
      (const int*)idx1, (const float*)w1, K1, (const int*)idx2,
      (const float*)w2, K2, V1, V2, P, span, (const int*)order, align,
      (double*)sums, (float*)out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
