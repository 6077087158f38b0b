// K6 mesh-mesh intersection, forward only.
//
// Replaces: shapy_tpu/ops/tri_tri.py `mesh_mesh_intersection` (:144) with
// `_plane` (:34), `_segment_on_line` (:42), `point_to_barycentric` (:71)
// and `_pairs_intersect` (:90). The JAX package tests every (query,
// target) triangle pair with the Möller interval test, masked by an AABB
// test, in (query chunk, F) tiles through the TPU's vector units, then
// keeps each query's first `max_collisions` valid target ids in index
// order (top_k on a 0/1 score) with the two segment endpoints as
// barycentric coordinates in the target triangle.
//
// What bounds it on the H100: bytes. At a full-width SMPL-X body pair (Q =
// F = 20908, M = 256) the (B, Q * M) ids and (B, Q * M, 2, 3) barycentrics
// are 150 MB a pair, written once (~45 us at 3.35 TB/s). Of the Q x F = 437
// M pairs only ~19 k have overlapping boxes and ~1.3 k cross, so a kernel
// that box-tests every pair spends its time on tests that a spatial
// hierarchy never makes.
//
// Design: a prologue of six short launches, then the query launch.
// 1-5. Each target's plane and box by id, as the JAX code hoists them out
//    of its query loop, and a Morton code of its box centre (5 bits an
//    axis in the body's box of centres); the ids sorted by code with ties
//    in id order, by a counting sort (a histogram by atomics, a scan, a
//    scatter by atomics, then each cell's ids
//    put in id order by ranking them: the result does not depend on the
//    atomics' order; no library sort).
// 6. The boxes in that order and, for each run of 32 consecutive targets
//    (a cluster) and each run of 32 clusters (a supercluster), the union
//    box. Min and max are exact, so a face whose box overlaps a query's
//    box lies in a cluster and a supercluster whose boxes overlap it.
// 7. `tri_tri_kernel`, a persistent grid, a warp a query triangle (a block
//    of 8 warps a query when there are few queries, as on the plane
//    route), the cluster boxes staged in shared memory: the superclusters
//    32 at a time, a lane each, then the clusters of each that overlaps,
//    then, a lane a face, the face boxes of each cluster that overlaps and
//    the Möller test. The hits go to a list in shared memory (`list_size`
//    ids, a power of 2), which a bitonic sort puts in id order; the first
//    `max_collisions` are written, with their endpoints computed again by
//    the same code (the same bits), and the rest of the query's slots are
//    filled with -1 and zeros by 16-byte stores. So a query with more
//    hits than slots keeps its smallest ids, as top_k gives them. A query
//    whose hits overflow its list sweeps all targets in index order
//    instead, 32 a step, stopping at `max_collisions` hits, and adds one
//    to the overflow counter.
// Every dot and cross product is summed x, then y, then z, and the build
// contracts no a * b + c into an FMA, so each sign, overlap and box
// decision rounds as in the plain PyTorch version
// (`ops/tri_tri.py:mesh_mesh_intersection_plain`); the culling only skips
// pairs whose boxes cannot overlap, so the ids and barycentrics are the
// plain version's bit for bit. `ops/tri_tri.py:mesh_mesh_intersection_replay`
// repeats the order, the clusters, the culled tests and the lists.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-9f;
constexpr int kCluster = 32;         // targets a cluster, clusters a
                                     // supercluster
constexpr int kThreads = 256;        // threads a prologue block
constexpr int kScanThreads = 1024;   // threads of the scan, a block a body
constexpr int kCellBits = 5;         // Morton bits an axis
constexpr int kCells = 1 << (3 * kCellBits);
constexpr int kWarps = 8;            // warps a query block
constexpr int kStageBytes = 96 * 1024;  // most cluster boxes staged
constexpr int kBlocksPerSM = 3;      // query blocks an SM, at least

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 load3(const float* p) {
  return {p[0], p[1], p[2]};
}
__device__ __forceinline__ V3 pick(bool c, V3 a, V3 b) { return c ? a : b; }

struct Segment {
  float lo, hi;
  V3 p_lo, p_hi;
  bool valid;
};

// The triangle p's crossing of the other plane (its vertices' signed
// distances s), parametrised along dir: `_segment_on_line`.
__device__ Segment segment_on_line(const V3 p[3], const float s[3], V3 dir) {
  V3 q[3];
  bool c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = i == 2 ? 0 : i + 1;
    c[i] = s[i] * s[j] < 0.f;
    const float denom = s[i] - s[j];
    const float t = s[i] / (fabsf(denom) > kEps ? denom : kEps);
    q[i] = {p[i].x + t * (p[j].x - p[i].x), p[i].y + t * (p[j].y - p[i].y),
            p[i].z + t * (p[j].z - p[i].z)};
  }
  Segment g;
  g.valid = (int)c[0] + (int)c[1] + (int)c[2] == 2;
  const V3 first = pick(c[0], q[0], q[1]);
  const V3 second = pick(c[2], q[2], q[1]);
  const float t0 = dot(first, dir), t1 = dot(second, dir);
  const bool keep = t0 <= t1;
  g.lo = fminf(t0, t1);
  g.hi = fmaxf(t0, t1);
  g.p_lo = pick(keep, first, second);
  g.p_hi = pick(keep, second, first);
  return g;
}

// `point_to_barycentric` of p in triangle t, into out[3].
__device__ void barycentric(const V3 t[3], V3 p, float* out) {
  const V3 v0 = sub(t[1], t[0]), v1 = sub(t[2], t[0]), v2 = sub(p, t[0]);
  const float d00 = dot(v0, v0), d01 = dot(v0, v1), d11 = dot(v1, v1);
  const float d20 = dot(v2, v0), d21 = dot(v2, v1);
  float denom = d00 * d11 - d01 * d01;
  denom = fabsf(denom) > kEps ? denom : kEps;
  const float v = (d11 * d20 - d01 * d21) / denom;
  const float w = (d00 * d21 - d01 * d20) / denom;
  out[0] = 1.f - v - w;
  out[1] = v;
  out[2] = w;
}

// A query triangle, its plane and its box.
struct Query {
  V3 v[3], n, mn, mx;
  float d;
};

__device__ Query load_query(const float* qp) {
  Query q;
  q.v[0] = load3(qp);
  q.v[1] = load3(qp + 3);
  q.v[2] = load3(qp + 6);
  q.n = cross(sub(q.v[1], q.v[0]), sub(q.v[2], q.v[0]));
  q.d = -dot(q.n, q.v[0]);
  q.mn = {fminf(fminf(q.v[0].x, q.v[1].x), q.v[2].x),
          fminf(fminf(q.v[0].y, q.v[1].y), q.v[2].y),
          fminf(fminf(q.v[0].z, q.v[1].z), q.v[2].z)};
  q.mx = {fmaxf(fmaxf(q.v[0].x, q.v[1].x), q.v[2].x),
          fmaxf(fmaxf(q.v[0].y, q.v[1].y), q.v[2].y),
          fmaxf(fmaxf(q.v[0].z, q.v[1].z), q.v[2].z)};
  return q;
}

// Box b (SoA, `stride` floats apart: min x, y, z, max x, y, z) at i
// overlaps the query's box. The six loads are issued together.
__device__ __forceinline__ bool box_overlaps(const float* b, size_t stride,
                                             int i, const Query& q) {
  const float x0 = b[i], y0 = b[stride + i], z0 = b[2 * stride + i];
  const float x1 = b[3 * stride + i], y1 = b[4 * stride + i],
              z1 = b[5 * stride + i];
  return (x0 <= q.mx.x) & (y0 <= q.mx.y) & (z0 <= q.mx.z) & (x1 >= q.mn.x) &
         (y1 >= q.mn.y) & (z1 >= q.mn.z);
}

// The Möller test of the query against target f (its vertices tv out) and
// the overlap's endpoints p0, p1: `_pairs_intersect` for one pair.
__device__ bool pair_test(const Query& q, const float* tb, const float* gb,
                          int F, int f, V3 tv[3], V3& p0, V3& p1) {
  const float* t = tb + (size_t)f * 9;
  tv[0] = load3(t);
  tv[1] = load3(t + 3);
  tv[2] = load3(t + 6);
  const V3 nt = {gb[f], gb[F + f], gb[2 * F + f]};
  const float dt = gb[3 * F + f];
  float dist_t[3], dist_q[3];
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    dist_t[v] = dot(q.n, tv[v]) + q.d;
    dist_q[v] = dot(nt, q.v[v]) + dt;
  }
  const V3 dir = cross(q.n, nt);
  const Segment st = segment_on_line(tv, dist_t, dir);
  const Segment sq = segment_on_line(q.v, dist_q, dir);
  const float lo = fmaxf(st.lo, sq.lo), hi = fminf(st.hi, sq.hi);
  p0 = pick(st.lo >= sq.lo, st.p_lo, sq.p_lo);
  p1 = pick(st.hi <= sq.hi, st.p_hi, sq.p_hi);
  return st.valid && sq.valid && hi > lo;
}

// p[lo, hi) = v, a warp's lanes together, by 16-byte stores where aligned.
__device__ void fill(uint32_t* p, size_t lo, size_t hi, uint32_t v,
                     int lane) {
  if (lo >= hi) return;
  size_t head = lo + ((4 - (((uintptr_t)(p + lo) >> 2) & 3)) & 3);
  head = head < hi ? head : hi;
  for (size_t i = lo + lane; i < head; i += 32) p[i] = v;
  const size_t n4 = (hi - head) / 4;
  uint4* p4 = reinterpret_cast<uint4*>(p + head);
  for (size_t i = lane; i < n4; i += 32) __stcs(p4 + i, make_uint4(v, v, v, v));
  for (size_t i = head + 4 * n4 + lane; i < hi; i += 32) p[i] = v;
}

__device__ __forceinline__ uint32_t spread3(uint32_t v) {
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

__device__ __forceinline__ uint32_t cell(float c, float lo, float scale) {
  const float t = (c - lo) * scale;
  return t < (float)((1 << kCellBits) - 1) ? (uint32_t)t
                                            : (1u << kCellBits) - 1;
}

__device__ __forceinline__ float pos_inf() {
  return __int_as_float(0x7f800000);
}
__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Scratch of a body: floats geom (10 F: each target's plane n (3) and d,
// then its box's min (3) and max (3), by id), centre (3 F: the boxes'
// centres), part (6 P: each geometry block's least and greatest centre, P
// = ceil(F / 256)), sbox (6 F: the boxes in Morton order), cbox (6 NC: the
// clusters' union boxes) and scbox (6 NS: the superclusters'); ints hist
// and cursor (kCells each: the cells' counts, and their first positions,
// each cell's end once launch 4 has filled it), order (F: the targets' ids in Morton order), code (F:
// each target's cell) and tmp (F: the ids by cell, unsorted within a
// cell). Each array holds all B bodies.
struct Scratch {
  float *geom, *centre, *part, *sbox, *cbox, *scbox;
  int *order, *code, *tmp, *hist, *cursor;
};

__host__ __device__ inline Scratch scratch(float* fs, int* is, int B, int F) {
  const int P = (F + kThreads - 1) / kThreads;
  const int NC = (F + kCluster - 1) / kCluster;
  Scratch r;
  r.geom = fs;
  r.centre = r.geom + (size_t)B * 10 * F;
  r.part = r.centre + (size_t)B * 3 * F;
  r.sbox = r.part + (size_t)B * 6 * P;
  r.cbox = r.sbox + (size_t)B * 6 * F;
  r.scbox = r.cbox + (size_t)B * 6 * NC;
  r.hist = is;
  r.cursor = r.hist + (size_t)B * kCells;
  r.order = r.cursor + (size_t)B * kCells;
  r.code = r.order + (size_t)B * F;
  r.tmp = r.code + (size_t)B * F;
  return r;
}

// The least (k < 3) or greatest (k >= 3) of v over the block, in every
// thread (red: 6 x 8 floats of shared memory).
__device__ float block_extreme(float v, int k, float (*red)[kThreads / 32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = k < 3 ? warp_min(v) : warp_max(v);
  if (lane == 0) red[k][warp] = v;
  __syncthreads();
  v = lane < kThreads / 32 ? red[k][lane] : (k < 3 ? pos_inf() : -pos_inf());
  return k < 3 ? warp_min(v) : warp_max(v);
}

// Launch 1, a thread a target: its plane and box (geom), its box's centre,
// each block's extremes of the centres (part); the cell counts zeroed for
// launch 2.
__global__ void __launch_bounds__(kThreads)
    target_geom_kernel(const float* __restrict__ target, int B, int F,
                       float* fs, int* is) {
  __shared__ float red[6][kThreads / 32];
  const Scratch sc = scratch(fs, is, B, F);
  const int b = blockIdx.y, t = threadIdx.x;
  const int f = blockIdx.x * kThreads + t;
  float c[3] = {pos_inf(), pos_inf(), pos_inf()};
  float e[3] = {-pos_inf(), -pos_inf(), -pos_inf()};
  if (f < F) {
    const float* tp = target + ((size_t)b * F + f) * 9;
    const V3 p0 = load3(tp), p1 = load3(tp + 3), p2 = load3(tp + 6);
    const V3 nrm = cross(sub(p1, p0), sub(p2, p0));
    const float mn[3] = {fminf(fminf(p0.x, p1.x), p2.x),
                         fminf(fminf(p0.y, p1.y), p2.y),
                         fminf(fminf(p0.z, p1.z), p2.z)};
    const float mx[3] = {fmaxf(fmaxf(p0.x, p1.x), p2.x),
                         fmaxf(fmaxf(p0.y, p1.y), p2.y),
                         fmaxf(fmaxf(p0.z, p1.z), p2.z)};
    float* g = sc.geom + (size_t)b * 10 * F + f;
    g[0] = nrm.x;
    g[F] = nrm.y;
    g[2 * (size_t)F] = nrm.z;
    g[3 * (size_t)F] = -dot(nrm, p0);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g[(4 + k) * (size_t)F] = mn[k];
      g[(7 + k) * (size_t)F] = mx[k];
      c[k] = e[k] = 0.5f * (mn[k] + mx[k]);
      sc.centre[((size_t)b * 3 + k) * F + f] = c[k];
    }
  }
  float* part = sc.part + ((size_t)b * gridDim.x + blockIdx.x) * 6;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float v = block_extreme(k < 3 ? c[k] : e[k - 3], k, red);
    if (t == 0) part[k] = v;
  }
  int* hist = sc.hist + (size_t)b * kCells;
  for (int i = blockIdx.x * kThreads + t; i < kCells; i += gridDim.x * kThreads)
    hist[i] = 0;
}

// Launch 2, a thread a target: the body's box of centres (from the parts),
// the target's cell (a Morton code of 5 bits an axis) and its count.
__global__ void __launch_bounds__(kThreads)
    target_cell_kernel(int B, int F, float* fs, int* is) {
  __shared__ float red[6][kThreads / 32];
  const Scratch sc = scratch(fs, is, B, F);
  const int b = blockIdx.y, t = threadIdx.x;
  const int f = blockIdx.x * kThreads + t;
  float ext[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) ext[k] = k < 3 ? pos_inf() : -pos_inf();
  for (int i = t; i < (int)gridDim.x; i += kThreads) {
    const float* p = sc.part + ((size_t)b * gridDim.x + i) * 6;
#pragma unroll
    for (int k = 0; k < 6; ++k)
      ext[k] = k < 3 ? fminf(ext[k], p[k]) : fmaxf(ext[k], p[k]);
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) ext[k] = block_extreme(ext[k], k, red);
  int* hist = sc.hist + (size_t)b * kCells;
  if (f < F) {
    uint32_t code = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float lo = ext[k], hi = ext[3 + k];
      const float scale = hi > lo ? (float)(1 << kCellBits) / (hi - lo) : 0.f;
      code |= spread3(cell(sc.centre[((size_t)b * 3 + k) * F + f], lo,
                           scale))
              << k;
    }
    sc.code[(size_t)b * F + f] = (int)code;
    atomicAdd(hist + code, 1);
  }
}

// Launch 3, a block a body: each cell's first position (cursor, for
// launch 4), an exclusive scan of the counts. The counts go through shared
// memory (one padding word every 32 cells, so that neither the coalesced
// copy nor a thread's run of 32 cells meets a bank twice): thread t scans
// cells [32 t, 32 t + 32).
__global__ void __launch_bounds__(kScanThreads)
    cell_scan_kernel(int B, int F, float* fs, int* is) {
  extern __shared__ int cells[];  // kCells + kCells / 32
  __shared__ int sums[kScanThreads / 32];
  const Scratch sc = scratch(fs, is, B, F);
  const int b = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  constexpr int kPer = kCells / kScanThreads;
  static_assert(kPer == 32, "a run of 32 cells a thread");
  const int* hist = sc.hist + (size_t)b * kCells;
  int* cursor = sc.cursor + (size_t)b * kCells;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = i * kScanThreads + t;
    cells[c + c / 32] = hist[c];
  }
  __syncthreads();
  int* run = cells + t * (kPer + 1);
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) sum += run[j];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  int at = incl - sum;
  for (int w = 0; w < warp; ++w) at += sums[w];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int n = run[j];
    run[j] = at;
    at += n;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = i * kScanThreads + t;
    cursor[c] = cells[c + c / 32];
  }
}

// Launch 4, a thread a target: its id at the next free position of its
// cell (the order inside a cell depends on the atomics; launch 5 fixes it).
__global__ void __launch_bounds__(kThreads)
    target_scatter_kernel(int B, int F, float* fs, int* is) {
  const Scratch sc = scratch(fs, is, B, F);
  const int b = blockIdx.y, f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= F) return;
  const int at = atomicAdd(
      sc.cursor + (size_t)b * kCells + sc.code[(size_t)b * F + f], 1);
  sc.tmp[(size_t)b * F + at] = f;
}

// Launch 5, a warp a cell: each id of the cell goes to its rank by id
// among the cell's ids. So the order is the targets sorted by cell, and by
// id inside a cell, whatever order the atomics took.
__global__ void __launch_bounds__(kThreads)
    cell_sort_kernel(int B, int F, float* fs, int* is) {
  const Scratch sc = scratch(fs, is, B, F);
  const int b = blockIdx.y, lane = threadIdx.x & 31;
  const int c = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int n = sc.hist[(size_t)b * kCells + c];
  if (n == 0) return;
  const int s = sc.cursor[(size_t)b * kCells + c] - n;  // launch 4 ran it
                                                       // to the end
  const int* ids = sc.tmp + (size_t)b * F + s;
  for (int i = lane; i < n; i += 32) {
    const int x = ids[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += ids[j] < x;
    sc.order[(size_t)b * F + s + rank] = x;
  }
}

// Launch 6, a warp a cluster (32 consecutive targets in the order), a
// block 32 clusters (a supercluster): the boxes in the order (sbox), the
// clusters' and the superclusters' union boxes (cbox, scbox).
__global__ void __launch_bounds__(kCluster * 32)
    cluster_box_kernel(int B, int F, float* fs, int* is) {
  __shared__ float box[6][kCluster];
  const Scratch sc = scratch(fs, is, B, F);
  const int b = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int NC = (F + kCluster - 1) / kCluster;
  const int NS = (NC + kCluster - 1) / kCluster;
  const int c = blockIdx.x * kCluster + warp;
  const int p = c * kCluster + lane;
  const bool in = p < F;
  const int f = in ? sc.order[(size_t)b * F + p] : 0;
  const float* g = sc.geom + (size_t)b * 10 * F + 4 * (size_t)F;
  float v[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = in ? g[k * (size_t)F + f] : 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    if (in) sc.sbox[((size_t)b * 6 + k) * F + p] = v[k];
    const float u = k < 3 ? warp_min(in ? v[k] : pos_inf())
                          : warp_max(in ? v[k] : -pos_inf());
    if (lane == 0) {
      box[k][warp] = u;
      if (c < NC) sc.cbox[((size_t)b * 6 + k) * NC + c] = u;
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float u = k < 3 ? warp_min(box[k][lane]) : warp_max(box[k][lane]);
      if (lane == 0) sc.scbox[((size_t)b * 6 + k) * NS + blockIdx.x] = u;
    }
  }
}

// Launch 7: a team of `team` warps (1, or all kWarps of the block) a query
// triangle, over a persistent grid. The block first stages the cluster and
// supercluster boxes in shared memory (where they fit). The team tests the
// superclusters 32 at a time, a lane each; in each that overlaps the
// query's box, its 32 clusters at once; the k-th overlapping cluster goes
// to warp k % team, which tests its faces' boxes and then the Möller test,
// a lane a face, and appends the hits to the team's list in shared memory.
// Then the list is sorted by id (bitonic, the team's threads) and the
// first M written; a query whose hits overflow the list sweeps the targets
// in index order instead (the team's first warp). With kCount the walk
// also adds the tests it made to tested[0..3]: supercluster boxes, cluster
// boxes, face boxes and Möller tests (faces whose boxes overlap), as
// `mesh_mesh_intersection_replay` counts them; the overflow sweep is not
// counted.
template <bool kCount>
__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSM)
    tri_tri_kernel(const float* __restrict__ query,
                   const float* __restrict__ target,
                   const float* __restrict__ geom,
                   const int* __restrict__ order,
                   const float* __restrict__ sbox,
                   const float* __restrict__ cbox,
                   const float* __restrict__ scbox, int Q, int F, int M,
                   int list_size, int team, int staged,
                   int* __restrict__ faces, float* __restrict__ bcs,
                   int* __restrict__ overflowed,
                   unsigned long long* __restrict__ tested) {
  extern __shared__ __align__(16) int lists[];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int teams = kWarps / team, tid = warp / team, rank = warp % team;
  const int NC = (F + kCluster - 1) / kCluster;
  const int NS = (NC + kCluster - 1) / kCluster;
  int* counts = lists + teams * list_size;
  const float* cb = cbox + (size_t)b * 6 * NC;
  const float* scb = scbox + (size_t)b * 6 * NS;
  if (staged) {
    float* s_cb = reinterpret_cast<float*>(counts + kWarps);
    float* s_scb = s_cb + 6 * NC;
    for (int i = threadIdx.x; i < 6 * NC; i += kWarps * 32) s_cb[i] = cb[i];
    for (int i = threadIdx.x; i < 6 * NS; i += kWarps * 32) s_scb[i] = scb[i];
    __syncthreads();
    cb = s_cb;
    scb = s_scb;
  }
  const float* tb = target + (size_t)b * F * 9;
  const float* gb = geom + (size_t)b * 10 * F;
  const float* sb = sbox + (size_t)b * 6 * F;
  const int* ob = order + (size_t)b * F;
  int* list = lists + tid * list_size;
  int* count = counts + tid;
  const unsigned lower = (1u << lane) - 1u;
  const int threads = team * 32, t = rank * 32 + lane;
  // kCount: this warp's tests (the team's first warp counts the
  // supercluster and cluster boxes, which every warp of the team tests)
  unsigned long long n_s = 0, n_c = 0, n_f = 0, n_b = 0;

  for (int qi = blockIdx.x * teams + tid; qi < Q;
       qi += gridDim.x * teams) {
    const Query q = load_query(query + ((size_t)b * Q + qi) * 9);
    const size_t row = ((size_t)b * Q + qi) * M;
    if (t == 0) *count = 0;
    if (team == 1) __syncwarp(); else __syncthreads();

    int k = 0;  // overlapping clusters so far, the same in every warp
    for (int s0 = 0; s0 < NS; s0 += 32) {
      const bool in_s = s0 + lane < NS;
      unsigned near_s = __ballot_sync(
          0xffffffffu, in_s && box_overlaps(scb, NS, s0 + lane, q));
      if (kCount && rank == 0) n_s += __popc(__ballot_sync(0xffffffffu, in_s));
      while (near_s) {
        const int s = s0 + __ffs(near_s) - 1;
        near_s &= near_s - 1;
        const int c = s * kCluster + lane;
        unsigned near_c =
            __ballot_sync(0xffffffffu, c < NC && box_overlaps(cb, NC, c, q));
        if (kCount && rank == 0)
          n_c += __popc(__ballot_sync(0xffffffffu, c < NC));
        while (near_c) {
          const int p = (s * kCluster + __ffs(near_c) - 1) * kCluster + lane;
          near_c &= near_c - 1;
          if (k++ % team != rank) continue;
          bool hit = false;
          const int f = p < F ? ob[p] : 0;
          const bool near_f = p < F && box_overlaps(sb, F, p, q);
          if (near_f) {
            V3 tv[3], p0, p1;
            hit = pair_test(q, tb, gb, F, f, tv, p0, p1);
          }
          if (kCount) {
            n_f += __popc(__ballot_sync(0xffffffffu, p < F));
            n_b += __popc(__ballot_sync(0xffffffffu, near_f));
          }
          const unsigned hits = __ballot_sync(0xffffffffu, hit);
          if (hits) {
            int at = 0;
            if (lane == 0) at = atomicAdd(count, __popc(hits));
            at = __shfl_sync(0xffffffffu, at, 0) + __popc(hits & lower);
            if (hit && at < list_size) list[at] = f;
          }
        }
      }
    }
    if (team == 1) __syncwarp(); else __syncthreads();
    const int n = *count;

    if (n > list_size) {
      // Overflow: the team's first warp sweeps the targets in index order,
      // boxes from geom.
      if (rank == 0) {
        int kept = 0;
        for (int base = 0; base < F && kept < M; base += 32) {
          const int f = base + lane;
          bool hit = false;
          V3 tv[3], p0, p1;
          if (f < F && box_overlaps(gb + 4 * (size_t)F, F, f, q))
            hit = pair_test(q, tb, gb, F, f, tv, p0, p1);
          const unsigned hits = __ballot_sync(0xffffffffu, hit);
          const int slot = kept + __popc(hits & lower);
          if (hit && slot < M) {
            faces[row + slot] = f;
            float* o = bcs + (row + slot) * 6;
            barycentric(tv, p0, o);
            barycentric(tv, p1, o + 3);
          }
          kept += __popc(hits);
        }
        kept = min(kept, M);
        fill(reinterpret_cast<uint32_t*>(faces), row + kept, row + M,
             0xffffffffu, lane);
        fill(reinterpret_cast<uint32_t*>(bcs), (row + kept) * 6,
             (row + M) * 6, 0u, lane);
        if (lane == 0) atomicAdd(overflowed, 1);
      }
    } else {
      // the list in id order: a bitonic sort over the next power of 2
      int n2 = 1;
      while (n2 < n) n2 <<= 1;
      for (int i = n + t; i < n2; i += threads) list[i] = 0x7fffffff;
      if (team == 1) __syncwarp(); else __syncthreads();
      for (int kk = 2; kk <= n2; kk <<= 1) {
        for (int j = kk >> 1; j > 0; j >>= 1) {
          for (int i = t; i < n2; i += threads) {
            const int ixj = i ^ j;
            if (ixj > i) {
              const int x = list[i], y = list[ixj];
              if ((x > y) == ((i & kk) == 0)) {
                list[i] = y;
                list[ixj] = x;
              }
            }
          }
          if (team == 1) __syncwarp(); else __syncthreads();
        }
      }
      const int kept = min(n, M);
      for (int s = t; s < kept; s += threads) {
        const int f = list[s];
        V3 tv[3], p0, p1;
        pair_test(q, tb, gb, F, f, tv, p0, p1);
        faces[row + s] = f;
        float* o = bcs + (row + s) * 6;
        barycentric(tv, p0, o);
        barycentric(tv, p1, o + 3);
      }
      // the rest of the slots, a contiguous share a warp
      const int share = (M - kept + team - 1) / team;
      const int lo = min(M, kept + rank * share), hi = min(M, lo + share);
      fill(reinterpret_cast<uint32_t*>(faces), row + lo, row + hi,
           0xffffffffu, lane);
      fill(reinterpret_cast<uint32_t*>(bcs), (row + lo) * 6, (row + hi) * 6,
           0u, lane);
    }
    if (team == 1) __syncwarp(); else __syncthreads();
  }
  if (kCount && lane == 0) {
    atomicAdd(tested, n_s);
    atomicAdd(tested + 1, n_c);
    atomicAdd(tested + 2, n_f);
    atomicAdd(tested + 3, n_b);
  }
}

// Launch 7 under its plan: dynamic shared memory for the teams' lists and
// the staged boxes, a persistent grid of as many blocks as the card holds
// at once, shared among the bodies.
template <bool kCount>
int launch_queries(const float* query, const float* target,
                   const Scratch& sc, int B, int Q, int F, int M,
                   int list_size, int team, int* faces, float* bcs,
                   int* overflowed, unsigned long long* tested,
                   cudaStream_t s) {
  const int NC = (F + kCluster - 1) / kCluster;
  const int NS = (NC + kCluster - 1) / kCluster;
  const int teams = kWarps / team;
  const int staged = 24 * (NC + NS) <= kStageBytes;
  const int smem = 4 * (teams * list_size + kWarps) +
                   (staged ? 24 * (NC + NS) : 0);
  int err = (int)cudaFuncSetAttribute(
      tri_tri_kernel<kCount>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != 0) return err;
  int dev = 0, sms = 0, fit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &fit, tri_tri_kernel<kCount>, kWarps * 32, smem);
  if (err != 0) return err;
  const int per_body = ((fit > 0 ? fit : 1) * sms + B - 1) / B;
  const int need = (Q + teams - 1) / teams;
  tri_tri_kernel<kCount><<<dim3(need < per_body ? need : per_body, B),
                           kWarps * 32, smem, s>>>(
      query, target, sc.geom, sc.order, sc.sbox, sc.cbox, sc.scbox, Q, F, M,
      list_size, team, staged, faces, bcs, overflowed, tested);
  return (int)cudaGetLastError();
}

}  // namespace

// query (B, Q, 3, 3) and target (B, F, 3, 3) f32; scratch: floats fs of
// B (19 F + 6 ceil(F / 256) + 6 NC + 6 NS) and ints is of B (2 * 32768 +
// 3 F), NC = ceil(F / 32), NS = ceil(NC / 32), laid out as `scratch` says
// (the targets' order after the cells' arrays); faces (B, Q * M) int32 and bcs (B, Q * M, 2, 3) f32 out;
// overflowed: an int32 counter that each query whose hits overflow its
// list of list_size ids (a power of 2, at most 1024) adds one to; team:
// warps a query (1 or 8); tested: null, or four uint64 counters that the
// query walk adds its tests to (`tri_tri_kernel`'s kCount). All contiguous
// on the device. Returns cudaGetLastError().
extern "C" int tri_tri_forward(const void* query, const void* target,
                               void* fs, void* is, void* faces, void* bcs,
                               void* overflowed, void* tested, int B, int Q,
                               int F, int M, int list_size, int team,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int NC = (F + kCluster - 1) / kCluster;
  const int NS = (NC + kCluster - 1) / kCluster;
  const Scratch sc = scratch((float*)fs, (int*)is, B, F);
  int err;
  if (F > 0) {
    const dim3 grid((F + kThreads - 1) / kThreads, B);
    target_geom_kernel<<<grid, kThreads, 0, s>>>((const float*)target, B, F,
                                                 (float*)fs, (int*)is);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    target_cell_kernel<<<grid, kThreads, 0, s>>>(B, F, (float*)fs, (int*)is);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    const int scan_smem = 4 * (kCells + kCells / 32);
    err = (int)cudaFuncSetAttribute(
        cell_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        scan_smem);
    if (err != 0) return err;
    cell_scan_kernel<<<B, kScanThreads, scan_smem, s>>>(B, F, (float*)fs,
                                                        (int*)is);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    target_scatter_kernel<<<grid, kThreads, 0, s>>>(B, F, (float*)fs,
                                                    (int*)is);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    cell_sort_kernel<<<dim3(kCells / (kThreads / 32), B), kThreads, 0, s>>>(
        B, F, (float*)fs, (int*)is);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    cluster_box_kernel<<<dim3(NS, B), kCluster * 32, 0, s>>>(
        B, F, (float*)fs, (int*)is);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  if (tested != nullptr)
    return launch_queries<true>(
        (const float*)query, (const float*)target, sc, B, Q, F, M, list_size,
        team, (int*)faces, (float*)bcs, (int*)overflowed,
        (unsigned long long*)tested, s);
  return launch_queries<false>((const float*)query, (const float*)target, sc,
                               B, Q, F, M, list_size, team, (int*)faces,
                               (float*)bcs, (int*)overflowed, nullptr, s);
}
