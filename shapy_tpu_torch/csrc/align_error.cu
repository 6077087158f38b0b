// K8b aligned point errors: a group of point-set pairs in one launch.
//
// Replaces: shapy_tpu/eval/metrics.py `PointError.__call__` (:181), i.e. an
// alignment of the estimate onto the ground truth -- `no_alignment` (:87),
// `root_align` (:91), `translation_align` (:101), `scale_align` (:109) or
// `procrustes_align` (:123, batched SVD with the sign(det(U V^T))
// reflection fix) -- followed by `point_error` (:31). The JAX package left
// this to XLA on the TPU (jnp.linalg.svd of (B, 3, 3) plus elementwise
// passes over (B, P, 3)), one call per metric.
//
// What bounds it on the H100: memory. The evaluator asks nine alignments of
// four point-set pairs a batch (v2v: procrustes, scale, translation of the
// posed vertices; v2v_t: scale, translation of v_shaped; mpjpe and mpjpe14:
// root, procrustes of 55 / 14 joints). At B = 32, P = 10475 the two vertex
// pairs are 16.1 MB read once and their five (B, P) error sets 6.7 MB
// written once: 22.8 MB, ~6.8 us at 3.35 TB/s; the joints are negligible,
// the arithmetic ~70 FLOP a point and alignment plus one 3x3 SVD per
// (body, pair).
//
// Design: one launch for the whole group. A parameter table (Group) gives
// each pair's pointers, P, the alignments asked (a bit per mode), its root
// ids and its split, from align_plan in eval/metrics.py (the shape alone):
//   * a pair of many points takes a thread-block cluster per body (at most
//     the portable 8 CTAs, the launch's cluster size), CTA r the contiguous
//     run [r span, (r + 1) span); a pair of few points takes one CTA per
//     body, packed side by side into clusters that never synchronise;
//   * each CTA copies its run of both point sets into shared memory once
//     (24 B a point), so device memory is read once for the pair;
//   * the means, then the moments of the f32-centred points (var1, var2
//     and K = sum x1 x2^T, the order of operations of the plain version),
//     are summed in double: per thread in point order, by a fixed
//     warp-shuffle tree, the warps in order, then across the cluster: every
//     CTA stores its partials into every other CTA's shared memory
//     (distributed shared memory; stores, so no thread waits on a remote
//     load) and, after the cluster's barrier, sums the ranks in rank order.
//     No atomics: two calls give the same bits, and every rank the same
//     totals, so each rank solves the 3x3 problem itself (the same bits in
//     every rank) instead of waiting at a third barrier for rank 0's;
//   * root means are summed by warp 0 over the root ids (a shuffle tree);
//   * thread 0 solves the Procrustes problem in double in registers (~4
//     us on the H100, tools/perf_k8_sweep.py), while warps 1.. write the
//     pair's other alignments' errors:
//     Jacobi rotations diagonalise K^T K = V S^2 V^T, u_i = K v_i / |K v_i|
//     for the two largest singular values, the third axes are the cross
//     products v1 x v2 and u1 x u2, and R = sum_i v_i u_i^T is exactly the
//     proper rotation V diag(1, 1, sign det(U V^T)) U^T of the JAX code (no
//     sign ambiguity: each pair (u_i, v_i) flips together);
//   * the errors are written from the run in shared memory, coalesced,
//     each formed in float in the plain version's order (built with
//     --fmad=false): the other alignments' during the solve, then
//     Procrustes'.
// Rank 0 also writes the (body, pair)'s double totals (Sums below) so that
// a caller can hold the reduction order against a replay of it
// (metrics.aligned_sums_replay).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPairs = 8;
constexpr int kMaxRoot = 16;
constexpr int kMaxCluster = 8;
constexpr int kModes = 5;

enum Mode { kNone = 0, kRoot = 1, kTranslation = 2, kScale = 3,
            kProcrustes = 4 };

// A (body, pair)'s totals: est and gt coordinate sums, then var1, var2 and
// K row-major over the f32-centred points, then the root ids' coordinate
// sums (0 where not asked).
enum Sums { kMeanSums = 0, kMomentSums = 6, kRootSums = 17, kSums = 23 };

// Broadcast values: means of est and gt, root means of est and gt, the
// scale alignment's and the Procrustes alignment's scale, R row-major.
enum Params { kMean = 0, kRootMean = 6, kScaleS = 12, kScaleP = 13,
              kRot = 14, kParams = 23 };

// One point-set pair of the group. Fields as the wrapper's table rows.
struct Pair {
  const float* est;  // (B, P, 3)
  const float* gt;   // (B, P, 3)
  float* out[kModes];  // (B, P) per mode; null where not asked
  double* sums;        // (B, kSums)
  int P;
  int span;   // points a CTA takes
  int ranks;  // 1: one CTA a body; else a cluster a body
  int cta0;   // the pair's first CTA (a multiple of the cluster size)
  int modes;  // bit m: mode m asked
  int n_root;
  int root[kMaxRoot];
};

struct Group {
  Pair pair[kMaxPairs];
  int n_pairs;
  int B;
};

struct Shared {
  double red[11 * kWarps];
  // from each rank r: its partial means / moments, stored by rank r
  double peer_mean[kMaxCluster][6];
  double peer_moment[kMaxCluster][11];
  double mine[11];
  double tot[kSums];
  float prm[kParams + 1];  // padded to 16 bytes
};
static_assert(sizeof(Shared) % 16 == 0, "the staged points follow Shared");

// Thread-block cluster instructions, as csrc/measure.cu: the cluster's
// barrier (arrive relaxed at the start, wait before the first remote
// store; or both with release / acquire) and a store of v to CTA `rank`'s
// shared memory at this CTA's address `local`.
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

// Sums v[i] over the block in a fixed order: a shuffle tree in each warp,
// then the warps in order. The result is valid in thread 0.
template <int N>
__device__ __forceinline__ void block_sum(double (&v)[N], double* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    double x = v[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    v[i] = x;
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[i * kWarps + warp] = v[i];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      double s = 0.0;
      for (int w = 0; w < kWarps; ++w) s += red[i * kWarps + w];
      v[i] = s;
    }
  }
  __syncthreads();  // `red` may be reused after this
}

// The totals over the pair's CTAs of each thread's v[0..N): the block's
// sums (block_sum), then, in a cluster, every rank's in rank order (the
// `peer` slots, one row per rank). Written to tot[0..N) in every CTA.
template <int N>
__device__ void pair_total(double (&v)[N], Shared& sh, double (*peer)[N],
                           double* tot, bool clustered, unsigned rank,
                           unsigned ranks) {
  block_sum<N>(v, sh.red);
  const int tid = threadIdx.x;
  if (!clustered) {
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) tot[i] = v[i];
    }
    __syncthreads();
    return;
  }
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) sh.mine[i] = v[i];
  }
  __syncthreads();
  if (tid < N * (int)ranks) {
    st_cluster(&peer[rank][tid % N], tid / N, sh.mine[tid % N]);
  }
  cluster_sync();  // every rank's partials are here
  if (tid < N) {
    double s = 0.0;
    for (unsigned r = 0; r < ranks; ++r) s += peer[r][tid];
    tot[tid] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ void cross(const double* a, const double* b,
                                      double* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void normalize(double* a) {
  const double n = sqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]);
  const double inv = n > 0.0 ? 1.0 / n : 0.0;
  a[0] *= inv;
  a[1] *= inv;
  a[2] *= inv;
}

// Any unit vector orthogonal to the unit vector a.
__device__ void orthogonal(const double* a, double* out) {
  const double e[3][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
  int k = 0;
  if (fabs(a[1]) < fabs(a[k])) k = 1;
  if (fabs(a[2]) < fabs(a[k])) k = 2;
  cross(a, e[k], out);
  normalize(out);
}

// The rotation R (row-major) of the Procrustes alignment of x1 onto x2
// from K = sum_p x1_p x2_p^T (row-major): R = V Z U^T with K = U S V^T.
__device__ void procrustes_rotation(const double* K, double* R) {
  // A = K^T K, symmetric; Jacobi rotations A <- J^T A J, V <- V J.
  double a[3][3], v[3][3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      a[i][j] = K[0 * 3 + i] * K[0 * 3 + j] + K[1 * 3 + i] * K[1 * 3 + j] +
                K[2 * 3 + i] * K[2 * 3 + j];
      v[i][j] = i == j ? 1.0 : 0.0;
    }
  }
  const int P_[3] = {0, 0, 1};
  const int Q_[3] = {1, 2, 2};
  for (int sweep = 0; sweep < 32; ++sweep) {
    const double off = a[0][1] * a[0][1] + a[0][2] * a[0][2] +
                       a[1][2] * a[1][2];
    const double diag = a[0][0] * a[0][0] + a[1][1] * a[1][1] +
                        a[2][2] * a[2][2];
    if (!(off > 1e-30 * diag)) break;
    for (int r = 0; r < 3; ++r) {
      const int p = P_[r], q = Q_[r];
      if (a[p][q] == 0.0) continue;
      const double theta = (a[q][q] - a[p][p]) / (2.0 * a[p][q]);
      const double t = (theta >= 0.0 ? 1.0 : -1.0) /
                       (fabs(theta) + sqrt(theta * theta + 1.0));
      const double c = 1.0 / sqrt(t * t + 1.0);
      const double s = t * c;
      for (int k = 0; k < 3; ++k) {
        const double akp = a[k][p], akq = a[k][q];
        a[k][p] = c * akp - s * akq;
        a[k][q] = s * akp + c * akq;
      }
      for (int k = 0; k < 3; ++k) {
        const double apk = a[p][k], aqk = a[q][k];
        a[p][k] = c * apk - s * aqk;
        a[q][k] = s * apk + c * aqk;
      }
      for (int k = 0; k < 3; ++k) {
        const double vkp = v[k][p], vkq = v[k][q];
        v[k][p] = c * vkp - s * vkq;
        v[k][q] = s * vkp + c * vkq;
      }
    }
  }
  // The two largest eigenvalues of K^T K (squared singular values).
  int i1 = 0;
  if (a[1][1] > a[i1][i1]) i1 = 1;
  if (a[2][2] > a[i1][i1]) i1 = 2;
  int i2 = i1 == 0 ? 1 : 0;
  for (int k = 0; k < 3; ++k) {
    if (k != i1 && a[k][k] > a[i2][i2]) i2 = k;
  }
  double v1[3] = {v[0][i1], v[1][i1], v[2][i1]};
  double v2[3] = {v[0][i2], v[1][i2], v[2][i2]};
  double u1[3], u2[3], u3[3], v3[3];
  for (int i = 0; i < 3; ++i) {
    u1[i] = K[i * 3 + 0] * v1[0] + K[i * 3 + 1] * v1[1] + K[i * 3 + 2] * v1[2];
    u2[i] = K[i * 3 + 0] * v2[0] + K[i * 3 + 1] * v2[1] + K[i * 3 + 2] * v2[2];
  }
  normalize(u1);
  if (u1[0] == 0.0 && u1[1] == 0.0 && u1[2] == 0.0) u1[0] = 1.0;  // K = 0
  // Gram-Schmidt keeps U orthonormal when sigma_2 is tiny.
  const double d = u1[0] * u2[0] + u1[1] * u2[1] + u1[2] * u2[2];
  for (int i = 0; i < 3; ++i) u2[i] -= d * u1[i];
  const double n2 = sqrt(u2[0] * u2[0] + u2[1] * u2[1] + u2[2] * u2[2]);
  if (n2 > 1e-300) {
    for (int i = 0; i < 3; ++i) u2[i] /= n2;
  } else {
    orthogonal(u1, u2);  // rank <= 1: any completion is a solution
  }
  cross(v1, v2, v3);
  cross(u1, u2, u3);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      R[i * 3 + j] = v1[i] * u1[j] + v2[i] * u2[j] + v3[i] * u3[j];
    }
  }
}

__device__ __forceinline__ float norm3(float dx, float dy, float dz) {
  return sqrtf(dx * dx + dy * dy + dz * dz);
}

// At most 85 registers a thread, so that three CTAs share an SM and the
// evaluator's group (320 CTAs at B = 32) runs in one wave.
__global__ void __launch_bounds__(kThreads, 3) align_group_kernel(
    const __grid_constant__ Group g) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  float* se = reinterpret_cast<float*>(smem + sizeof(Shared));
  const int tid = threadIdx.x;
  int i = 0;
  while (i + 1 < g.n_pairs && (int)blockIdx.x >= g.pair[i + 1].cta0) ++i;
  const Pair& pr = g.pair[i];
  const bool clustered = pr.ranks > 1;
  // In a cluster, the launch's cluster size and this CTA's rank.
  unsigned rank = 0, ranks = 1;
  if (clustered) {
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
    asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(ranks));
    cluster_arrive_relaxed();  // waited for before the first remote store
  }
  const int local = (int)blockIdx.x - pr.cta0;
  const int b = clustered ? local / (int)ranks : local;
  if (b >= g.B) return;  // packing's padding: never in a cluster's barrier
  const int P = pr.P, modes = pr.modes;
  const int lo = min(P, (int)rank * pr.span);
  const int n = min(P, lo + pr.span) - lo;
  float* sg = se + 3 * pr.span;
  const float* e = pr.est + ((size_t)b * P + lo) * 3;
  const float* gp = pr.gt + ((size_t)b * P + lo) * 3;
  for (int k = tid; k < 3 * n; k += kThreads) {
    se[k] = __ldg(e + k);
    sg[k] = __ldg(gp + k);
  }
  if (tid < kSums) sh.tot[tid] = 0.0;
  if (tid < kParams) sh.prm[tid] = 0.f;
  if (clustered) cluster_wait();  // every rank has started
  __syncthreads();

  const bool scale = modes & (1 << kScale);
  const bool procrustes = modes & (1 << kProcrustes);
  const bool moments = scale || procrustes;
  if (moments || (modes & (1 << kTranslation))) {
    double s[6] = {0, 0, 0, 0, 0, 0};
    for (int p = tid; p < n; p += kThreads) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s[k] += se[p * 3 + k];
        s[3 + k] += sg[p * 3 + k];
      }
    }
    pair_total<6>(s, sh, sh.peer_mean, sh.tot + kMeanSums, clustered, rank,
                  ranks);
    if (tid < 6) sh.prm[kMean + tid] = (float)(sh.tot[kMeanSums + tid] / P);
    __syncthreads();
  }
  if ((modes & (1 << kRoot)) && tid < 32) {
    const float* eb = pr.est + (size_t)b * P * 3;
    const float* gb = pr.gt + (size_t)b * P * 3;
    double s[6] = {0, 0, 0, 0, 0, 0};
    for (int r = tid; r < pr.n_root; r += 32) {
      const int p = pr.root[r];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s[k] += eb[p * 3 + k];
        s[3 + k] += gb[p * 3 + k];
      }
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s[k] += __shfl_down_sync(0xffffffffu, s[k], o);
      }
    }
    if (tid == 0) {
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        sh.tot[kRootSums + k] = s[k];
        sh.prm[kRootMean + k] = (float)(s[k] / pr.n_root);
      }
    }
  }
  __syncthreads();

  if (moments) {
    const float m1x = sh.prm[kMean + 0], m1y = sh.prm[kMean + 1],
                m1z = sh.prm[kMean + 2];
    const float m2x = sh.prm[kMean + 3], m2y = sh.prm[kMean + 4],
                m2z = sh.prm[kMean + 5];
    // var1, var2, K row-major
    double s[11] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
    for (int p = tid; p < n; p += kThreads) {
      const float x1[3] = {se[p * 3] - m1x, se[p * 3 + 1] - m1y,
                           se[p * 3 + 2] - m1z};
      const float x2[3] = {sg[p * 3] - m2x, sg[p * 3 + 1] - m2y,
                           sg[p * 3 + 2] - m2z};
      s[0] += (double)x1[0] * x1[0] + (double)x1[1] * x1[1] +
              (double)x1[2] * x1[2];
      if (scale) {
        s[1] += (double)x2[0] * x2[0] + (double)x2[1] * x2[1] +
                (double)x2[2] * x2[2];
      }
      if (procrustes) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
          for (int c = 0; c < 3; ++c) s[2 + a * 3 + c] += (double)x1[a] * x2[c];
        }
      }
    }
    pair_total<11>(s, sh, sh.peer_moment, sh.tot + kMomentSums, clustered,
                   rank, ranks);
  }
  if (rank == 0 && tid < kSums) pr.sums[(size_t)b * kSums + tid] = sh.tot[tid];
  const double* t = sh.tot + kMomentSums;
  const double var1 = fmax(t[0], 1e-12);
  // The scale alignment's factor: the same bits in every thread.
  const float ss = scale ? (float)sqrt(t[1] / var1) : 0.f;
  if (procrustes && tid == 0) {
    double R[9];
    procrustes_rotation(t + 2, R);
    double trace = 0.0;  // trace(R K)
    for (int a = 0; a < 3; ++a) {
      for (int c = 0; c < 3; ++c) trace += R[a * 3 + c] * t[2 + c * 3 + a];
    }
    sh.prm[kScaleP] = (float)(trace / var1);
    for (int k = 0; k < 9; ++k) sh.prm[kRot + k] = (float)R[k];
  }

  // The other alignments' errors, by warps 1.. while thread 0 solves.
  const float* m = sh.prm;
  const float* mr = sh.prm + kRootMean;
  const size_t o0 = (size_t)b * P + lo;
  const int first = procrustes ? 32 : 0;
  for (int p = tid - first; tid >= first && p < n; p += kThreads - first) {
    const float ex = se[p * 3], ey = se[p * 3 + 1], ez = se[p * 3 + 2];
    const float gx = sg[p * 3], gy = sg[p * 3 + 1], gz = sg[p * 3 + 2];
    if (modes & (1 << kNone)) {
      pr.out[kNone][o0 + p] = norm3(ex - gx, ey - gy, ez - gz);
    }
    if (modes & (1 << kRoot)) {
      pr.out[kRoot][o0 + p] = norm3((ex - mr[0]) - (gx - mr[3]),
                                    (ey - mr[1]) - (gy - mr[4]),
                                    (ez - mr[2]) - (gz - mr[5]));
    }
    if (modes & (1 << kTranslation)) {
      pr.out[kTranslation][o0 + p] = norm3((ex - m[0]) - (gx - m[3]),
                                           (ey - m[1]) - (gy - m[4]),
                                           (ez - m[2]) - (gz - m[5]));
    }
    if (scale) {
      pr.out[kScale][o0 + p] = norm3((ss * (ex - m[0]) + m[3]) - gx,
                                     (ss * (ey - m[1]) + m[4]) - gy,
                                     (ss * (ez - m[2]) + m[5]) - gz);
    }
  }
  if (!procrustes) return;
  __syncthreads();  // R and the scale are in shared memory
  const float sp = m[kScaleP];
  const float* R = m + kRot;
  for (int p = tid; p < n; p += kThreads) {
    const float x = se[p * 3] - m[0], y = se[p * 3 + 1] - m[1],
                z = se[p * 3 + 2] - m[2];
    const float gx = sg[p * 3], gy = sg[p * 3 + 1], gz = sg[p * 3 + 2];
    pr.out[kProcrustes][o0 + p] =
        norm3((sp * (R[0] * x + R[1] * y + R[2] * z) + m[3]) - gx,
              (sp * (R[3] * x + R[4] * y + R[5] * z) + m[4]) - gy,
              (sp * (R[6] * x + R[7] * y + R[8] * z) + m[5]) - gz);
  }
}

// The table's int64 fields a pair: est, gt, out[5], sums, P, span, ranks,
// cta0, modes, n_root, root[kMaxRoot].
constexpr int kFields = 14 + kMaxRoot;

}  // namespace

// One launch for a group of n_pairs (1 to 8) point-set pairs of B bodies.
// table: host int64 (n_pairs, 30) as above (pointers to contiguous device
// f32 tensors; a pair's runs of `span` points cover [0, P): one CTA a body
// when ranks is 1, else `cluster` CTAs a body; root ids inside [0, P)).
// ctas: the grid, a multiple of cluster (1 to 8); span_max: the most
// points a CTA stages. Returns cudaGetLastError().
extern "C" int align_error_forward(const void* table, int n_pairs, int B,
                                   int cluster, int ctas, int span_max,
                                   void* stream) {
  if (n_pairs < 1 || n_pairs > kMaxPairs || B < 1 || cluster < 1 ||
      cluster > kMaxCluster || ctas < 1 || ctas % cluster != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long* t = static_cast<const long long*>(table);
  Group g = {};
  g.n_pairs = n_pairs;
  g.B = B;
  for (int i = 0; i < n_pairs; ++i) {
    const long long* f = t + (size_t)i * kFields;
    Pair& p = g.pair[i];
    p.est = reinterpret_cast<const float*>(f[0]);
    p.gt = reinterpret_cast<const float*>(f[1]);
    for (int m = 0; m < kModes; ++m) p.out[m] = reinterpret_cast<float*>(f[2 + m]);
    p.sums = reinterpret_cast<double*>(f[7]);
    p.P = (int)f[8];
    p.span = (int)f[9];
    p.ranks = (int)f[10];
    p.cta0 = (int)f[11];
    p.modes = (int)f[12];
    p.n_root = (int)f[13];
    const long long covered =
        (long long)p.span * (p.ranks > 1 ? cluster : 1);
    if (p.P < 1 || p.span < 1 || p.span > span_max || covered < p.P ||
        p.cta0 % cluster != 0 || p.modes < 1 || p.modes >= (1 << kModes) ||
        p.n_root < 0 || p.n_root > kMaxRoot ||
        ((p.modes & (1 << kRoot)) && p.n_root < 1)) {
      return (int)cudaErrorInvalidValue;
    }
    for (int m = 0; m < kModes; ++m) {
      if (((p.modes >> m) & 1) != (p.out[m] != nullptr)) {
        return (int)cudaErrorInvalidValue;
      }
    }
    for (int r = 0; r < p.n_root; ++r) {
      p.root[r] = (int)f[14 + r];
      if (p.root[r] < 0 || p.root[r] >= p.P) return (int)cudaErrorInvalidValue;
    }
  }
  const size_t smem = sizeof(Shared) + (size_t)6 * span_max * sizeof(float);
  // Per device: the shared memory raised as far as a launch needed.
  static size_t smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && (dev >= 64 || smem > smem_set[dev])) {
    err = cudaFuncSetAttribute(align_group_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
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
  err = cudaLaunchKernelEx(&cfg, align_group_kernel, g);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
