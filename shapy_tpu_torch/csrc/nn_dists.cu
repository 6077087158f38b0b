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
// 10475) the inputs are 250 KB and the output 42 KB a direction, while
// the search is ~8 f32 operations for each of the 110 M (a, b) pairs a
// direction (~13 us at 67 TFLOP/s, an FMA's rate). Built with --fmad=false
// so that every expansion rounds as the plain version's, a pair costs 8
// issued instructions (3 multiplies, 4 adds, a minimum): both directions'
// 219.5 M pairs are ~0.053 ms of issue slots on 132 SMs x 4 schedulers at
// 1.98 GHz, the floor this design aims at.
//
// Design: one launch searches both directions of `point_fscore` (a in b
// and b in a), a second merges. A thread holds kR query points in
// registers with -2 folded into their coordinates: (-2 a_x) b_x + (-2 a_y)
// b_y + (-2 a_z) b_z has the bits of -2 (a . b) summed x, then y, then z,
// since doubling is exact (for products and partial sums above 2^-126,
// i.e. unless a coordinate product falls below ~1e-38). It then adds
// |a|^2 and then |b|^2, the plain version's order. A block stages its range
// of b once as float4 (x, y, z, |b|^2): one broadcast 16-byte load feeds
// kR pairs. Each query keeps a running fminf over runs of kRun points of b
// and notes the last run that lowered it strictly; at the end of a tile it
// scans that run again, with the same bits, for the first point that
// reaches the minimum. So ties keep the first index, as jnp.argmin and
// torch.argmin do, at one instruction a pair for the minimum. The queries'
// blocks alone would fill ~22 of 132 SMs, so each direction's b is also
// split into contiguous ranges (`eval/metrics.py:nn_plan`); the merge takes
// each query's range minima in range order, strictly smaller only (the
// first range wins a tie, hence the first index overall), and computes
// sqrt(max(|a - b|^2, 0)) for the winner.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads a search block
constexpr int kR = 4;          // query points a thread
constexpr int kRun = 16;       // points of b a run
constexpr int kTile = 2048;    // points of b staged at once (32 KB)

// One direction: each of the n query points q's nearest neighbour in the
// m points t; `ranges` ranges of `span` points of t, `blocks` query blocks
// of kThreads * kR points; the range minima (ranges, n), their indices,
// the distances (n,) and the neighbours' indices (n,).
struct Search {
  const float* q;
  const float* t;
  int n, m, blocks, ranges, span;
  float* best_d;
  int* best_i;
  float* out;
  int* idx;
};

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// |a|^2 - 2 a.b + |b|^2 as the plain version rounds it, from q = -2 a.
__device__ __forceinline__ float expansion(float qx, float qy, float qz,
                                           float aa, float4 v) {
  float d = qx * v.x;
  d = d + qy * v.y;
  d = d + qz * v.z;
  d = aa + d;
  return d + v.w;
}

__global__ void __launch_bounds__(kThreads)
    nn_search_kernel(Search s0, Search s1) {
  __shared__ float4 tile[kTile + kRun];
  const int first = s0.blocks * s0.ranges;
  const bool second = (int)blockIdx.x >= first;
  const Search s = second ? s1 : s0;
  const int x = blockIdx.x - (second ? first : 0);
  const int qb = x % s.blocks, range = x / s.blocks;
  const int lo = range * s.span, hi = min(s.m, lo + s.span);

  float qx[kR], qy[kR], qz[kR], aa[kR], m[kR], p[kR];
  int run[kR], best_j[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int n = qb * kThreads * kR + r * kThreads + threadIdx.x;
    float ax = 0.f, ay = 0.f, az = 0.f;
    if (n < s.n) {
      ax = s.q[3 * n];
      ay = s.q[3 * n + 1];
      az = s.q[3 * n + 2];
    }
    aa[r] = ax * ax + ay * ay + az * az;
    qx[r] = -2.f * ax;
    qy[r] = -2.f * ay;
    qz[r] = -2.f * az;
    m[r] = pos_inf();
    run[r] = -1;
    best_j[r] = lo;
  }
  for (int base = lo; base < hi; base += kTile) {
    const int len = min(kTile, hi - base);
    const int padded = (len + kRun - 1) / kRun * kRun;
    __syncthreads();  // the previous tile's last reads
    for (int j = threadIdx.x; j < padded; j += kThreads) {
      float4 v = make_float4(0.f, 0.f, 0.f, pos_inf());  // never a minimum
      if (j < len) {
        const float* b = s.t + 3 * (size_t)(base + j);
        v.x = b[0];
        v.y = b[1];
        v.z = b[2];
        v.w = v.x * v.x + v.y * v.y + v.z * v.z;
      }
      tile[j] = v;
    }
    __syncthreads();
    for (int j0 = 0; j0 < padded; j0 += kRun) {
#pragma unroll
      for (int r = 0; r < kR; ++r) p[r] = m[r];
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const float4 v = tile[j0 + j];
#pragma unroll
        for (int r = 0; r < kR; ++r)
          m[r] = fminf(m[r], expansion(qx[r], qy[r], qz[r], aa[r], v));
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) run[r] = m[r] < p[r] ? base + j0 : run[r];
    }
    // The first point of the last lowering run that reaches the minimum.
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (run[r] >= base) {
        const int j0 = run[r] - base;
        int found = kRun - 1;
#pragma unroll
        for (int j = kRun - 1; j >= 0; --j)
          if (expansion(qx[r], qy[r], qz[r], aa[r], tile[j0 + j]) == m[r])
            found = j;
        best_j[r] = run[r] + found;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int n = qb * kThreads * kR + r * kThreads + threadIdx.x;
    if (n < s.n) {
      s.best_d[(size_t)range * s.n + n] = m[r];
      s.best_i[(size_t)range * s.n + n] = best_j[r];
    }
  }
}

__global__ void nn_merge_kernel(Search s0, Search s1) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool second = i >= s0.n;
  const Search s = second ? s1 : s0;
  if (second) i -= s0.n;
  if (i >= s.n) return;
  float best = pos_inf();
  int j = 0;
  for (int r = 0; r < s.ranges; ++r) {
    const float d = s.best_d[(size_t)r * s.n + i];
    if (d < best) {
      best = d;
      j = s.best_i[(size_t)r * s.n + i];
    }
  }
  const float dx = s.q[3 * i] - s.t[3 * j];
  const float dy = s.q[3 * i + 1] - s.t[3 * j + 1];
  const float dz = s.q[3 * i + 2] - s.t[3 * j + 2];
  s.out[i] = sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 0.f));
  s.idx[i] = j;
}

}  // namespace

// a (N, 3) in b (M, 3) and, where blocks1 > 0, b in a, all f32 with N, M
// >= 1. Direction 0 splits b into ranges0 ranges of span0 points over
// blocks0 query blocks of 1024 points; direction 1 likewise. best_d f32
// and best_i int32 scratch of ranges0 * N + ranges1 * M; out f32 and idx
// int32 of N (+ M): each point's distance and its neighbour's index,
// direction 0 first. All contiguous on the device. Returns
// cudaGetLastError().
extern "C" int nn_dists_forward(const void* a, const void* b, void* best_d,
                                void* best_i, void* out, void* idx, int N,
                                int M, int blocks0, int ranges0, int span0,
                                int blocks1, int ranges1, int span1,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t off = (size_t)ranges0 * N;
  const Search s0 = {(const float*)a, (const float*)b, N, M, blocks0,
                     ranges0, span0, (float*)best_d, (int*)best_i,
                     (float*)out, (int*)idx};
  Search s1 = {(const float*)b, (const float*)a, blocks1 > 0 ? M : 0, N,
               blocks1, ranges1, span1, (float*)best_d + off,
               (int*)best_i + off, (float*)out + N, (int*)idx + N};
  if (blocks1 <= 0) s1.ranges = 0;
  nn_search_kernel<<<blocks0 * ranges0 + s1.blocks * s1.ranges, kThreads, 0,
                     st>>>(s0, s1);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  nn_merge_kernel<<<(s0.n + s1.n + 255) / 256, 256, 0, st>>>(s0, s1);
  return (int)cudaGetLastError();
}
