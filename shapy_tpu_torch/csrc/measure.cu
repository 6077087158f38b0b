// K1 measure: reference and exact slice modes, forward and backward.
//
// Replaces: shapy_tpu/measure/measurements.py:BodyMeasurements
// .forward_from_vertices (lines 313-390), i.e. the plane slice
// (ops/plane_slice.py:plane_slice_reference_soa, line 74, in
// slice_mode="reference"; plane_slice_soa, line 242, in slice_mode="exact")
// + ops/convex_hull.py:hull_perimeter_support_xz (line 53) for the chest,
// waist and hips planes, plus the signed-volume mass and the anchor height;
// and the VJP of all of it, which the JAX package takes by autodiff. The
// fused Pallas measurement kernel (ops/measure_pallas.py) that once did this
// on the TPU was deleted; the JAX package runs it as dense XLA ops over all
// 2F candidate points.
//
// What bounds it on the H100: latency and arithmetic per face, not memory.
// The body's vertices (126 KB for SMPL-X) are gathered through L1/L2; a
// plane walks its candidate faces (a few thousand with face subsets, all
// F = 20908 without) at ~100 FLOPs each for the six ordered hit tests; the
// hull is (hits x K/2) multiply-adds, and a slice of a body has only some
// hundreds of hits, against the 2F padded points the dense formulation
// projects.
//
// Forward (measure_forward, measure_exact_forward; the slice is a template
// parameter): a thread-block cluster of CTAs per (body, plane), plus one
// per body for mass and height (grid = (cluster, 4, B), the cluster along
// x). Its size comes from the faces walked and the batch (measure_plan in
// measure/measurements.py, from the shape alone: 16, non-portable, for
// one body on all F = 20908 faces, fewer as the batch fills the card or
// the walk shortens), and CTA r walks the contiguous walk positions
// [r span, (r + 1) span).
//   * Threads walk the CTA's faces in chunks of blockDim, one face each.
//     Reference mode runs the first-hit emulation of
//     plane_slice_reference_soa for both quad triangles: 3 Moller casts of
//     the quad edges (|det| >= 1e-4), then 3 body-edge crossings with
//     half-plane tests; the first hit wins; face id 0 (also the subset
//     padding) is dropped. Exact mode keeps both crossings of a face cut on
//     exactly two edges (strict sa * sb < 0, the 1e-20 guard, the first /
//     second edge rule of plane_slice_soa); face 0 is kept.
//   * Each CTA compacts its hits by a block-wide prefix sum per chunk into
//     its own run of a scratch row (2 slots per walked face, so any walk
//     fits), with each hit's code: walk position * 16 + which formula made
//     it (reference: quad triangle * 8 + candidate 0-5; exact: first /
//     second * 4 + edge), which the backward needs. Every CTA then stores
//     its hit count and sums into every other CTA's shared memory
//     (distributed shared memory; stores, so no thread waits on a remote
//     load) and, after the cluster's barrier, the counts of the ranks
//     before it give its offset: its hits are copied to the wrapper's
//     buffer in face order, as one block's walk would leave them. The
//     sums over the ranks in rank order give the centroid, the same bits
//     in every CTA.
//   * Hull: each CTA projects its staged hits, centred, on all K/2
//     antipodal direction pairs (theta_d, theta_d + pi) with all its
//     threads (256 / (K/2) threads a pair, each taking every so-many-th
//     hit), h = max(max proj, 0) + max(-min proj, 0), and stores its
//     extremes in rank 0's shared memory; rank 0 takes the max and min
//     over the ranks (exact in any order) and sums h over the pairs in a
//     fixed order, times 2 pi / K; the result is 0 with fewer than 2 hits.
//     The hit count and centroid are saved for the backward.
//   * Mass: |sum of the 6-term determinants| / 6 * density, in the term
//     order of measurements.py:354-358, each CTA over its range of faces,
//     rank 0 over the ranks in order (the signed sum is saved). Height:
//     |y(head) - y(heel)| at the barycentric anchors.
//   All sums run in an order fixed by the shape, so two calls give the
//   same bits. At a large batch the walk is bound by the gathers of each
//   face's three vertices, once per plane, from L2 (PERF.md).
//
// Backward (measure_backward, measure_exact_backward): a memset and two
// kernels, no floating-point atomics, every sum in an order fixed by the
// shape and the hit counts, so two calls give the same bits. A slice has a
// few hundred hits (~365 a plane in reference mode, ~730 in exact mode for
// SMPL-X) against K/2 = 128 direction pairs and V = 10475 vertices: the
// time is latency, not bytes or operations.
//   1. measure_backward_planes, one launch of two kinds of CTA (grid (B,
//      3 blocks + mass CTAs), every body's planes first):
//      * a cluster of `blocks` CTAs of 512 threads per (body, plane), from
//        the shape (measure_backward_plan in measure/measurements.py: up to
//        4 for a small batch, 1 from batch 45 on). CTA r sweeps its run of
//        the row's hits, [r span, (r + 1) span), staged in shared memory,
//        with every thread on (direction pair, share of the hits),
//        branch-free, for each pair's valid max and min and how many hits
//        reach each (the duplicates of shared body edges and the quad
//        diagonal; JAX and PyTorch split a tied extreme's gradient evenly,
//        and so does this), and stores them in every rank's shared memory
//        (distributed shared memory); max, min and integer counts are exact
//        in any order, so every CTA of the row then holds the same bits.
//        The dense formulation's masked points project to 0 and tie with a
//        0 extreme; the clamp max(h, 0) passes where h >= 0; a plane with
//        fewer than 2 hits has no gradient. The hits' point cotangents sum
//        to sum_d (share at the max x its hits - share at the min x its
//        hits) (cos, sin)_d, so every CTA has the centroid's
//        share from the pairs alone. Then a warp takes each group of 32
//        hits (groups dealt round-robin to the row's warps), a lane a hit:
//        its point cotangent (the pairs in order), the chain of its winning
//        formula (hit_vjp, once) to its face's 9 coordinates, stored beside
//        the hit as a record for the first `records` hits of a row, and to
//        the plane height, summed over the group in a fixed tree (the
//        vertices pass sums the groups in order); the face's three vertices
//        are marked for the plane. Each CTA also writes its share of the
//        row's hit map: per 16 walk positions a mask, 2 bits a position
//        (01: one hit there, 11: two), and the index of the word's first
//        hit.
//      * mass CTAs, a thread per (body, vertex): the mass term over the
//        vertex's (face, corner) list, whose entries carry the face's other
//        two vertex ids (a list built once on the host), then the height's
//        terms at the head-top and heel anchors; the result is the
//        gradient of every vertex but the marked ones'. A vertex of a
//        plane's anchor face is marked too.
//      Marks are integer atomics (an OR of plane bits a vertex; the first
//      mark appends the vertex to its body's list), so the marked set is
//      fixed, and each marked vertex is finished by one thread below.
//   2. measure_backward_vertices, after 1: the marked vertices, a thread
//      each (8 CTAs a body). Each marked plane's hits in
//      the faces around the vertex, in the list's order, found through the
//      hit map and read from their records (a hit past the records is
//      taken again from the saved hit, with the same operations, so the
//      same bits), summed and added to the vertex's gradient; then the
//      plane heights' terms at their anchors.
//
// K1-AoS (BodyMeasurements.forward on (B, F, 3, 3) triangles; replaces
// ops/plane_slice.py:plane_slice_triangles, line 28, plane_slice_reference,
// line 222, and ops/convex_hull.py:hull_perimeter_support, line 34, behind
// measure/measurements.py:396): the wrapper views the triangles as (B, 3F, 3)
// vertices with the faces (3f, 3f + 1, 3f + 2) and runs the forward and
// backward above on all faces; the values are then K1's. measure_points
// writes the slice points the JAX AoS surface returns from K1's saved hits.
// Reference mode: points (2F, 3), quad triangle q's point of face f at q * F
// + f, y the plane height on every slot, and a (2F,) mask. Exact mode:
// points (F, 2, 3), face f's first / second point at (f, 0) / (f, 1), y
// recomputed from the crossed edge as plane_slice_triangles does (the saved
// hits hold x and z only), and a (F,) mask; unhit slots are 0.
//   What bounds it: bytes. The 48.2 MB of points and 4 / 2 MB of masks at
//   batch 32 are nearly all the fill (35k hits of 4 M slots). One launch, a
//   block a tile of 2048 slots of a row: the fill staged in shared memory
//   as float4s, the tile's hits found by two binary searches of the row's
//   codes (one warp, 32 probes a step) and placed there, then the tile
//   stored once as 16-byte vectors (scalar heads and tails where a row does
//   not start on 16 bytes), so every byte is written once and nothing is
//   divided per element.
// measure_points_backward is their VJP, as JAX autodiff gives it for the
// plain slices: a block a tile of 256 faces of a body stages their
// triangles by 16-byte cp.async, and each thread recomputes its face's hits
// with slice_tri (the forward's operations, so the same hits and formulas)
// only in the planes where the forward's masks hold one of them (1.7% of
// the (face, plane) pairs at batch 32), then takes each hit's VJP at its
// slot (the crossed edge's endpoints, or the Moller cast's triangle, and
// the plane height; in exact mode through the recomputed y too); the
// gradient goes out through shared memory as 16-byte stores, and each
// block's plane-height cotangent per plane (in reference mode with every
// slot's y cotangent: the y is the plane height) is a partial that a
// second small launch sums in tile order. K1's backward takes it to the
// anchor triangle. What bounds it: bytes (the triangles read and their
// gradient written; in reference mode also every sector of the points'
// cotangent, for the y's). No atomics.
//
// Built with --fmad=false so the hit tests and projections round exactly as
// the plain PyTorch version: a contracted a*b+c could flip a boundary hit or
// a tie.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;  // hull points staged per pass (8 KB)
constexpr int kMaxHalfK = 2 * kThreads;  // two direction pairs per thread
constexpr float kEps = 1e-4f;
enum SliceMode { kReference = 0, kExact = 1 };

struct Planes {
  int off[3];  // start of each plane's face list in plane_faces
  int n[3];    // faces each plane walks
};

// The forward's cluster plan (measure_plan): CTA r of a plane's cluster
// walks positions [r plane[p], min(n_p, (r + 1) plane[p])), of the mass
// cluster faces [r mass, min(F, (r + 1) mass)).
struct Spans {
  int plane[3];
  int mass;
};

constexpr int kMaxCluster = 16;

// A forward CTA's shared memory, then rank 0's gather of the cluster's
// extremes (ranks x half_k x 2 floats; the same size in every CTA).
struct FwdShared {
  float red[32];
  int scan[32];
  // from each rank r: its hit count and its hits' count, x and z sums (the
  // mass cluster: its volume sum), stored here by rank r
  float peer[kMaxCluster][4];
  int offset;           // where this CTA's hits start in the plane's row
  float count, cx, cz;  // the plane's hit count and centroid
  float part_mx[kMaxHalfK], part_mn[kMaxHalfK];  // per (pair, share)
};
static_assert(sizeof(FwdShared) % 16 == 0, "the gather follows FwdShared");

// Sum over the block; every thread gets the result. red: 32 floats.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // red is free from any earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, o);
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// Exclusive prefix sum of v over the block in thread order; total gets the
// block's sum. buf: 32 ints.
__device__ int block_scan(int v, int* buf, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (int)(blockDim.x >> 5);
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();  // buf is free from any earlier call
  if (lane == 31) buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? buf[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    buf[lane] = w;
  }
  __syncthreads();
  total = buf[nwarps - 1];
  return (warp ? buf[warp - 1] : 0) + x - v;
}

// Thread-block cluster instructions. The cluster's barrier: arrive
// (relaxed, at the start: every CTA has started once the wait returns,
// before any CTA writes another's shared memory) and wait, or both with
// release / acquire; and a store of v to CTA `rank`'s shared memory at
// this CTA's address `local`. Values move by stores to the CTA that reads
// them, so no thread waits on a remote load.
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
__device__ __forceinline__ uint32_t cluster_addr(const void* local,
                                                 unsigned rank) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(local);
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  return remote;
}
__device__ __forceinline__ void st_cluster(float* local, unsigned rank,
                                           float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n"
               :
               : "r"(cluster_addr(local, rank)), "f"(v)
               : "memory");
}

struct Tri {
  float x[3], y[3], z[3];
  float e1x, e1y, e1z, e2x, e2y, e2z;
};

__device__ __forceinline__ void load_tri(const float* vb, const int* f,
                                         Tri& T) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* v = vb + 3 * f[k];
    T.x[k] = v[0];
    T.y[k] = v[1];
    T.z[k] = v[2];
  }
  T.e1x = T.x[1] - T.x[0]; T.e1y = T.y[1] - T.y[0]; T.e1z = T.z[1] - T.z[0];
  T.e2x = T.x[2] - T.x[0]; T.e2y = T.y[2] - T.y[0]; T.e2z = T.z[2] - T.z[0];
}

// y at anchor a (head top, left heel, chest, waist, hips) of body vb.
__device__ __forceinline__ float anchor_y(const float* vb, const int* faces,
                                          const int* anchor_face,
                                          const float* anchor_bary, int a) {
  const int* f = faces + 3 * anchor_face[a];
  const float* bc = anchor_bary + 3 * a;
  return vb[3 * f[0] + 1] * bc[0] + vb[3 * f[1] + 1] * bc[1] +
         vb[3 * f[2] + 1] * bc[2];
}

// Quad triangle q's edge c as (origin a, origin b, direction a, direction b)
// in the plane; the plain version's _Q_EDGES.
__device__ __forceinline__ float4 quad_edge(int q, int c) {
  if (q == 0) {
    if (c == 0) return make_float4(-1.f, -1.f, 2.f, 0.f);
    if (c == 1) return make_float4(1.f, -1.f, 0.f, 2.f);
    return make_float4(1.f, 1.f, -2.f, -2.f);
  }
  if (c == 0) return make_float4(-1.f, -1.f, 2.f, 2.f);
  if (c == 1) return make_float4(1.f, 1.f, -2.f, 0.f);
  return make_float4(-1.f, 1.f, 0.f, -2.f);
}

// A quad edge (origin (ox, h, oz), direction (dx, 0, dz)) against the body
// triangle: Moller-Trumbore, in plane_slice.py's operation order.
__device__ __forceinline__ bool quad_edge_hit(const Tri& T, float h, float4 E,
                                              float& ha, float& hb) {
  const float ox = E.x, oz = E.y, dx = E.z, dz = E.w;
  const float px = -dz * T.e2y;
  const float py = dz * T.e2x - dx * T.e2z;
  const float pz = dx * T.e2y;
  const float det = T.e1x * px + T.e1y * py + T.e1z * pz;
  if (!(fabsf(det) >= kEps)) return false;
  const float inv = 1.0f / det;
  const float tx = ox - T.x[0], ty = h - T.y[0], tz = oz - T.z[0];
  const float u = (tx * px + ty * py + tz * pz) * inv;
  if (!(u >= 0.f && u <= 1.f)) return false;
  const float qx = ty * T.e1z - tz * T.e1y;
  const float qy = tz * T.e1x - tx * T.e1z;
  const float qz = tx * T.e1y - ty * T.e1x;
  const float v = (dx * qx + dz * qz) * inv;
  if (!(v >= 0.f && u + v <= 1.f)) return false;
  const float t = (T.e2x * qx + T.e2y * qy + T.e2z * qz) * inv;
  if (!(t >= 0.f && t <= 1.f)) return false;
  ha = ox + t * dx;
  hb = oz + t * dz;
  return true;
}

// Body edge e (vertex e -> vertex e+1 mod 3) crossing the plane y = h inside
// quad triangle q.
__device__ __forceinline__ bool body_edge_hit(const Tri& T, int e, float h,
                                              int q, float& ha, float& hb) {
  const int a = e, b = e == 2 ? 0 : e + 1;
  const float dy = T.y[b] - T.y[a];
  if (!(fabsf(4.0f * dy) >= kEps)) return false;
  const float t = (h - T.y[a]) / dy;
  if (!(t >= 0.f && t <= 1.f)) return false;
  const float cx = T.x[a] + t * (T.x[b] - T.x[a]);
  const float cz = T.z[a] + t * (T.z[b] - T.z[a]);
  const bool in = q == 0
      ? (cx >= cz && cx - cz <= 2.f && cz >= -1.f && cx <= 1.f)
      : (cx >= -1.f && cx <= 1.f && cz >= cx && cz <= 1.f);
  if (!in) return false;
  ha = cx;
  hb = cz;
  return true;
}

// The winning candidate (0-2 quad edges, 3-5 body edges) for quad triangle
// q, or -1.
__device__ __forceinline__ int first_hit(const Tri& T, float h, int q,
                                         float& ha, float& hb) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (quad_edge_hit(T, h, quad_edge(q, c), ha, hb)) return c;
  }
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    if (body_edge_hit(T, e, h, q, ha, hb)) return 3 + e;
  }
  return -1;
}

// Exact mode: the crossing parameter of edge (sa, sb), plane_slice_soa's
// guarded division.
__device__ __forceinline__ float exact_denom(float sa, float sb) {
  const float denom = sa - sb;
  return fabsf(denom) > 1e-20f ? denom : 1e-20f;
}

__device__ __forceinline__ float2 exact_point(const Tri& T, const float* s,
                                              int e) {
  const int a = e, b = e == 2 ? 0 : e + 1;
  const float t = s[a] / exact_denom(s[a], s[b]);
  return make_float2(T.x[a] + t * (T.x[b] - T.x[a]),
                     T.z[a] + t * (T.z[b] - T.z[a]));
}

// The hits of triangle T, the face at walk position pos (face id `id`): up
// to two points (p0, then p1) and their codes. Returns their number.
template <int kMode>
__device__ __forceinline__ int slice_tri(const Tri& T, int id, int pos,
                                         float h, float2& p0, float2& p1,
                                         int& k0, int& k1) {
  if (kMode == kReference && id == 0) return 0;  // the reference drops it
  if (kMode == kReference) {
    int k = 0;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float ha, hb;
      const int c = first_hit(T, h, q, ha, hb);
      if (c >= 0) {
        if (k == 0) {
          p0 = make_float2(ha, hb);
          k0 = pos * 16 + q * 8 + c;
        } else {
          p1 = make_float2(ha, hb);
          k1 = pos * 16 + q * 8 + c;
        }
        ++k;
      }
    }
    return k;
  }
  float s[3];
#pragma unroll
  for (int v = 0; v < 3; ++v) s[v] = T.y[v] - h;
  const bool c0 = s[0] * s[1] < 0.f, c1 = s[1] * s[2] < 0.f,
             c2 = s[2] * s[0] < 0.f;
  if ((int)c0 + (int)c1 + (int)c2 != 2) return 0;
  const int first = c0 ? 0 : 1, second = c2 ? 2 : 1;
  p0 = exact_point(T, s, first);
  p1 = exact_point(T, s, second);
  k0 = pos * 16 + first;
  k1 = pos * 16 + 4 + second;
  return 2;
}

// slice_tri of the face at walk position pos (face id `id`) of body vb.
template <int kMode>
__device__ __forceinline__ int slice_face(const float* vb, const int* faces,
                                          int id, int pos, float h,
                                          float2& p0, float2& p1, int& k0,
                                          int& k1) {
  if (kMode == kReference && id == 0) return 0;
  Tri T;
  load_tri(vb, faces + 3 * id, T);
  return slice_tri<kMode>(T, id, pos, h, p0, p1, k0, k1);
}

// The VJP of one hit: point cotangent (ga, gb) -> the face's 9 coordinates
// (g[3 k + c] for vertex k, coordinate c) and the plane height (gh), through
// the formula named by `detail` (the low 4 bits of its code), recomputed
// with the forward's operations. In exact mode, gy is the cotangent of the
// point's y, which measure_points recomputes from the crossed edge (0 for
// the hull's hits, whose y is not an output; then the result is unchanged).
template <int kMode>
__device__ void hit_vjp(const Tri& T, float h, int detail, float ga, float gb,
                        float* g, float& gh, float gy = 0.f) {
#pragma unroll
  for (int k = 0; k < 9; ++k) g[k] = 0.f;
  gh = 0.f;
  int a, b;  // an edge's vertices (reference body edge or exact crossing)
  if (kMode == kReference) {
    const int q = detail >> 3, c = detail & 7;
    if (c < 3) {  // Moller cast of quad edge c
      const float4 E = quad_edge(q, c);
      const float ox = E.x, oz = E.y, dx = E.z, dz = E.w;
      const float px = -dz * T.e2y;
      const float py = dz * T.e2x - dx * T.e2z;
      const float pz = dx * T.e2y;
      const float det = T.e1x * px + T.e1y * py + T.e1z * pz;
      const float inv = 1.0f / det;
      const float tx = ox - T.x[0], ty = h - T.y[0], tz = oz - T.z[0];
      const float qx = ty * T.e1z - tz * T.e1y;
      const float qy = tz * T.e1x - tx * T.e1z;
      const float qz = tx * T.e1y - ty * T.e1x;
      const float num = T.e2x * qx + T.e2y * qy + T.e2z * qz;
      // a = ox + t dx, b = oz + t dz with t = num * inv
      const float gt = ga * dx + gb * dz;
      const float gnum = gt * inv;
      const float gdet = -(gt * num) * inv * inv;
      // num = e2 . q
      float ge2x = gnum * qx, ge2y = gnum * qy, ge2z = gnum * qz;
      const float gqx = gnum * T.e2x, gqy = gnum * T.e2y, gqz = gnum * T.e2z;
      // q = tvec x e1: d tvec = e1 x gq, d e1 = gq x tvec
      const float gtx = T.e1y * gqz - T.e1z * gqy;
      const float gty = T.e1z * gqx - T.e1x * gqz;
      const float gtz = T.e1x * gqy - T.e1y * gqx;
      float ge1x = gqy * tz - gqz * ty;
      float ge1y = gqz * tx - gqx * tz;
      float ge1z = gqx * ty - gqy * tx;
      // det = e1 . pvec
      ge1x += gdet * px;
      ge1y += gdet * py;
      ge1z += gdet * pz;
      const float gpx = gdet * T.e1x, gpy = gdet * T.e1y, gpz = gdet * T.e1z;
      // pvec = dir x e2 with dir = (dx, 0, dz): d e2 = gp x dir
      ge2x += gpy * dz;
      ge2y += gpz * dx - gpx * dz;
      ge2z += -gpy * dx;
      // tvec = (ox, h, oz) - v0; e1 = v1 - v0; e2 = v2 - v0
      gh = gty;
      g[0] = -gtx - ge1x - ge2x;
      g[1] = -gty - ge1y - ge2y;
      g[2] = -gtz - ge1z - ge2z;
      g[3] = ge1x; g[4] = ge1y; g[5] = ge1z;
      g[6] = ge2x; g[7] = ge2y; g[8] = ge2z;
      return;
    }
    a = c - 3;
    b = a == 2 ? 0 : a + 1;
    // t = (h - y_a) / dy; point = v_a + t (v_b - v_a) in (x, z)
    const float dy = T.y[b] - T.y[a];
    const float t = (h - T.y[a]) / dy;
    const float gt = ga * (T.x[b] - T.x[a]) + gb * (T.z[b] - T.z[a]);
    const float gnum = gt / dy;
    const float gdy = -gt * t / dy;
    g[3 * a + 0] = ga - ga * t;
    g[3 * b + 0] = ga * t;
    g[3 * a + 2] = gb - gb * t;
    g[3 * b + 2] = gb * t;
    g[3 * a + 1] = -gnum - gdy;
    g[3 * b + 1] = gdy;
    gh = gnum;
    return;
  }
  a = detail & 3;
  b = a == 2 ? 0 : a + 1;
  // s = y - h; t = s_a / denom(s_a - s_b); point = v_a + t (v_b - v_a)
  const float sa = T.y[a] - h, sb = T.y[b] - h;
  const float denom = sa - sb;
  const float den = exact_denom(sa, sb);
  const float t = sa / den;
  const float gxz = ga * (T.x[b] - T.x[a]) + gb * (T.z[b] - T.z[a]);
  // y = y_a + t (y_b - y_a), as plane_slice_triangles writes it
  const float gt = gy != 0.f ? gxz + gy * (T.y[b] - T.y[a]) : gxz;
  float gsa = gt / den, gsb = 0.f;
  if (fabsf(denom) > 1e-20f) {
    const float gden = -gt * t / den;
    gsa += gden;
    gsb -= gden;
  }
  g[3 * a + 0] = ga - ga * t;
  g[3 * b + 0] = ga * t;
  g[3 * a + 2] = gb - gb * t;
  g[3 * b + 2] = gb * t;
  g[3 * a + 1] = gy != 0.f ? gsa + (gy - gy * t) : gsa;
  g[3 * b + 1] = gy != 0.f ? gsb + gy * t : gsb;
  gh = -(gsa + gsb);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) measure_cluster_kernel(
    const float* __restrict__ verts, const int* __restrict__ faces,
    const int* __restrict__ plane_faces, const int* __restrict__ anchor_face,
    const float* __restrict__ anchor_bary, const float* __restrict__ hull_cos,
    const float* __restrict__ hull_sin, float2* __restrict__ hits,
    int* __restrict__ codes, float2* __restrict__ staged,
    int* __restrict__ staged_codes, float* __restrict__ stats,
    float* __restrict__ out, float* __restrict__ plane_h, int V, int F,
    Planes planes, Spans spans, int cap, int half_k, float angle_step,
    float density) {
  extern __shared__ __align__(16) unsigned char smem[];
  FwdShared& sh = *reinterpret_cast<FwdShared*>(smem);
  float* gather = reinterpret_cast<float*>(smem + sizeof(FwdShared));
  const unsigned rank = blockIdx.x, ranks = gridDim.x;  // the cluster
  const int p = blockIdx.y;  // 0..2: chest, waist, hips; 3: mass + height
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const float* vb = verts + (size_t)b * V * 3;
  float* st = stats + ((size_t)b * 4 + p) * 4;
  cluster_arrive_relaxed();  // waited for before the first remote store

  if (p == 3) {
    const int lo = min(F, (int)rank * spans.mass);
    const int hi = min(F, lo + spans.mass);
    float acc = 0.f;
    for (int i = lo + tid; i < hi; i += kThreads) {
      const int* f = faces + 3 * i;
      const float* v0 = vb + 3 * f[0];
      const float* v1 = vb + 3 * f[1];
      const float* v2 = vb + 3 * f[2];
      const float x0 = v0[0], y0 = v0[1], z0 = v0[2];
      const float x1 = v1[0], y1 = v1[1], z1 = v1[2];
      const float x2 = v2[0], y2 = v2[1], z2 = v2[2];
      acc += -x2 * y1 * z0 + x1 * y2 * z0 + x2 * y0 * z1 - x0 * y2 * z1 -
             x1 * y0 * z2 + x0 * y1 * z2;
    }
    const float part = block_sum(acc, sh.red);
    cluster_wait();
    if (tid == 0) st_cluster(&sh.peer[rank][0], 0, part);
    cluster_sync();  // every CTA's sum is in rank 0's shared memory
    if (rank == 0 && tid == 0) {
      float total = 0.f;
      for (unsigned r = 0; r < ranks; ++r) total += sh.peer[r][0];
      out[b * 5 + 0] = fabsf(total) / 6.0f * density;
      out[b * 5 + 1] = fabsf(anchor_y(vb, faces, anchor_face, anchor_bary, 0) -
                             anchor_y(vb, faces, anchor_face, anchor_bary, 1));
      st[0] = total;
    }
    return;
  }

  const float h = anchor_y(vb, faces, anchor_face, anchor_bary, 2 + p);
  if (rank == 0 && tid == 0) plane_h[b * 3 + p] = h;
  const int n = planes.n[p];
  const int lo = min(n, (int)rank * spans.plane[p]);
  const int hi = min(n, lo + spans.plane[p]);
  const int* ids = plane_faces ? plane_faces + planes.off[p] : nullptr;
  // This CTA's hits go first to its own run of the row's scratch, 2 slots
  // a walked face.
  const size_t row = ((size_t)b * 3 + p) * cap;
  float2* sp = staged + row + 2 * lo;
  int* sc = staged_codes + row + 2 * lo;
  float cnt = 0.f, sx = 0.f, sz = 0.f;
  int total = 0;  // hits staged so far, the same in every thread
  for (int start = lo; start < hi; start += kThreads) {
    const int i = start + tid;
    float2 p0, p1;
    int k0, k1, k = 0;
    if (i < hi) {
      k = slice_face<kMode>(vb, faces, ids ? ids[i] : i, i, h, p0, p1, k0,
                            k1);
    }
    if (k > 0) {
      cnt += 1.f;
      sx += p0.x;
      sz += p0.y;
    }
    if (k > 1) {
      cnt += 1.f;
      sx += p1.x;
      sz += p1.y;
    }
    int chunk_total;
    const int at = total + block_scan(k, sh.scan, chunk_total);
    if (k > 0) {
      sp[at] = p0;
      sc[at] = k0;
    }
    if (k > 1) {
      sp[at + 1] = p1;
      sc[at + 1] = k1;
    }
    total += chunk_total;
  }
  const float own_n = block_sum(cnt, sh.red);
  const float own_x = block_sum(sx, sh.red);
  const float own_z = block_sum(sz, sh.red);
  cluster_wait();
  if (tid < (int)ranks) {  // this CTA's count and sums, to every rank
    float* to = sh.peer[rank];
    st_cluster(&to[0], tid, __int_as_float(total));
    st_cluster(&to[1], tid, own_n);
    st_cluster(&to[2], tid, own_x);
    st_cluster(&to[3], tid, own_z);
  }
  cluster_sync();  // every rank's count and sums are here
  if (tid == 0) {  // the ranks in order: the same bits in every CTA
    int offset = 0;
    float tn = 0.f, tx = 0.f, tz = 0.f;
    for (unsigned r = 0; r < ranks; ++r) {
      if (r < rank) offset += __float_as_int(sh.peer[r][0]);
      tn += sh.peer[r][1];
      tx += sh.peer[r][2];
      tz += sh.peer[r][3];
    }
    sh.offset = offset;
    sh.count = tn;
    sh.cx = tx / fmaxf(tn, 1.f);
    sh.cz = tz / fmaxf(tn, 1.f);
  }
  __syncthreads();  // also: the staged hits are visible to the block
  const float cx = sh.cx, cz = sh.cz;
  float2* hp = hits + row + sh.offset;
  int* cp = codes + row + sh.offset;
  for (int i = tid; i < total; i += kThreads) {
    hp[i] = sp[i];
    cp[i] = sc[i];
  }

  // This CTA's extremes per direction pair: item w = share * half_k + d
  // takes pair d over the hits share, share + shares, ...; starting at 0
  // clamps, h = max(max proj, 0), h(theta + pi) = max(-min proj, 0).
  const int shares = half_k >= kThreads ? 1 : kThreads / half_k;
  for (int w = tid; w < shares * half_k; w += kThreads) {
    const int share = w / half_k, d = w - share * half_k;
    const float c = hull_cos[d], s = hull_sin[d];
    float mx = 0.f, mn = 0.f;
    for (int i = share; i < total; i += shares) {
      const float2 q = sp[i];
      const float x = q.x - cx, z = q.y - cz;
      const float pr = x * c + z * s;
      mx = fmaxf(mx, pr);
      mn = fminf(mn, pr);
    }
    sh.part_mx[w] = mx;
    sh.part_mn[w] = mn;
  }
  __syncthreads();
  for (int d = tid; d < half_k; d += kThreads) {  // to rank 0's gather
    float mx = sh.part_mx[d], mn = sh.part_mn[d];
    for (int share = 1; share < shares; ++share) {
      mx = fmaxf(mx, sh.part_mx[share * half_k + d]);
      mn = fminf(mn, sh.part_mn[share * half_k + d]);
    }
    st_cluster(&gather[(rank * half_k + d) * 2], 0, mx);
    st_cluster(&gather[(rank * half_k + d) * 2 + 1], 0, mn);
  }
  cluster_sync();  // every rank's extremes are in rank 0's gather
  if (rank != 0) return;
  // Thread t sums pairs t, t + blockDim (then the block, in a fixed tree):
  // max and min over the ranks are exact in any order.
  float hsum = 0.f;
  for (int d = tid; d < half_k; d += kThreads) {
    float mx = 0.f, mn = 0.f;
    for (unsigned r = 0; r < ranks; ++r) {
      mx = fmaxf(mx, gather[(r * half_k + d) * 2]);
      mn = fminf(mn, gather[(r * half_k + d) * 2 + 1]);
    }
    hsum += mx - mn;
  }
  const float perimeter = block_sum(hsum, sh.red) * angle_step;
  if (tid == 0) {
    out[b * 5 + 2 + p] = sh.count >= 2.f ? perimeter : 0.f;
    st[0] = sh.count;
    st[1] = cx;
    st[2] = cz;
  }
}

constexpr int kPlaneThreads = 512;  // the planes pass's CTA
constexpr int kWarps = kPlaneThreads / 32;
constexpr int kGroup = 32;      // hits a warp takes at once, a lane each
constexpr int kRecord = 9;      // floats of a hit's record: its face's VJP
constexpr int kWordSpan = 16;   // walk positions a word of the hit map
constexpr int kUnroll = 3;      // (face, corner) entries loaded at once
constexpr int kMarkedCtas = 8;  // the vertices pass's CTAs a body
constexpr int kProbe = 6;       // entries the vertices pass probes at once

// The planes pass's shared memory: per direction pair (cos, sin, the
// valid max, the valid min) and the share of a hit at the max (x cos, x
// sin) and at the min; the valid hits' extremes per (pair, share of the
// hits); a chunk of staged hits; then (dynamic) the gather of the
// cluster's extremes and this CTA's words of the hit map, a mask and a
// first-hit index each.
struct BwdShared {
  float red[32];
  float4 dir[kMaxHalfK], coef[kMaxHalfK];
  float part_mx[kMaxHalfK], part_mn[kMaxHalfK];
  int part_kx[kMaxHalfK], part_kn[kMaxHalfK];
  float2 pts[kChunk];
};
static_assert(sizeof(BwdShared) % 16 == 0, "the hit map follows BwdShared");

// d perimeter / d (centred point) of one hit: over the direction pairs in
// order, the share of each extreme the hit reaches (adding 0 where it
// reaches none leaves the sum's bits: it is never -0).
__device__ __forceinline__ float2 hull_point_grad(const float4* dir,
                                                  const float4* coef,
                                                  int half_k, float xc,
                                                  float zc) {
  float gx = 0.f, gz = 0.f;
#pragma unroll 4
  for (int d = 0; d < half_k; ++d) {
    const float4 a = dir[d], f = coef[d];
    const float pr = xc * a.x + zc * a.y;
    const bool up = pr == a.z, down = pr == a.w;
    gx += up ? f.x : 0.f;
    gz += up ? f.y : 0.f;
    gx -= down ? f.z : 0.f;
    gz -= down ? f.w : 0.f;
  }
  return make_float2(gx, gz);
}

// A hit as step 3 of the planes pass takes it: the point, its code and
// its face's vertex ids.
struct HitInput {
  float2 q;
  int code;
  int face[3];
};

__device__ __forceinline__ void load_hit(HitInput& in, const int* faces,
                                         const int* ids, const float2* hp,
                                         const int* cp, int j) {
  in.q = hp[j];
  in.code = cp[j];
  const int pos = in.code >> 4;
  const int* f = faces + 3 * (ids ? ids[pos] : pos);
#pragma unroll
  for (int c = 0; c < 3; ++c) in.face[c] = f[c];
}

// Marks vertex u of body b for the vertices pass: sets `bits` in its flags
// (mark_vertex, or mark_set then mark_listed once its old flags are back)
// and, the first time any bit is set, appends u to the body's list (the
// list's order varies, what each listed vertex computes does not).
__device__ __forceinline__ unsigned mark_set(unsigned* flags, int V, int b,
                                             int u, unsigned bits) {
  return atomicOr(&flags[(size_t)b * V + u], bits);
}
__device__ __forceinline__ void mark_listed(unsigned* flags, int* listed,
                                            int V, int b, int u,
                                            unsigned old) {
  if (old == 0u) {
    unsigned* count = flags + (size_t)gridDim.x * V + b;  // after the flags
    listed[(size_t)b * V + atomicAdd(count, 1u)] = u;
  }
}
__device__ __forceinline__ void mark_vertex(unsigned* flags, int* listed,
                                            int V, int b, int u,
                                            unsigned bits) {
  mark_listed(flags, listed, V, b, u, mark_set(flags, V, b, u, bits));
}

// The mass CTAs of the planes launch: a thread per (body, vertex). Mass:
// d|S| / d det = sign(S); d det / d v_c = v_{c+1} x v_{c+2}, the entry's
// other two vertices, kUnroll entries at a time, in the list's order; then
// the height's (d|y_head - y_heel|) at the head-top and heel anchors. A
// vertex of a plane's anchor face is marked (bit 3) for the vertices pass,
// which adds the plane height's term.
__device__ void mass_vertex(
    const float* vb, const int* faces, const int* anchor_face,
    const float* anchor_bary, const float* stats, const float* g_out,
    const int* corner_ptr, const int4* corners, float* grad,
    unsigned* flags, int* listed, int V, int Vm, int b, int v,
    float density) {
  float* gv = grad + ((size_t)b * V + v) * 3;
  if (v >= Vm) {  // not in any face
    gv[0] = gv[1] = gv[2] = 0.f;
    return;
  }
  const float S = stats[((size_t)b * 4 + 3) * 4];
  const float gm = g_out[b * 5] * density / 6.0f *
                   (S > 0.f ? 1.f : (S < 0.f ? -1.f : 0.f));
  float gx = 0.f, gy = 0.f, gz = 0.f;
  const int e1 = corner_ptr[v + 1];
  for (int at = corner_ptr[v]; at < e1; at += kUnroll) {
    float u[kUnroll][3], w[kUnroll][3];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (at + k < e1) {
        const int4 c4 = corners[at + k];
        const float* pu = vb + 3 * c4.y;
        const float* pw = vb + 3 * c4.z;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          u[k][i] = pu[i];
          w[k][i] = pw[i];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (at + k < e1) {
        gx += gm * (u[k][1] * w[k][2] - u[k][2] * w[k][1]);
        gy += gm * (u[k][2] * w[k][0] - u[k][0] * w[k][2]);
        gz += gm * (u[k][0] * w[k][1] - u[k][1] * w[k][0]);
      }
    }
  }
  bool plane_anchor = false;
  for (int a = 0; a < 5; ++a) {
    const int* f = faces + 3 * anchor_face[a];
    for (int k = 0; k < 3; ++k) {
      if (f[k] != v) continue;
      if (a >= 2) {
        plane_anchor = true;
        continue;
      }
      const float dh = anchor_y(vb, faces, anchor_face, anchor_bary, 0) -
                       anchor_y(vb, faces, anchor_face, anchor_bary, 1);
      const float ght =
          g_out[b * 5 + 1] * (dh > 0.f ? 1.f : (dh < 0.f ? -1.f : 0.f));
      gy += (a == 0 ? ght : -ght) * anchor_bary[3 * a + k];
    }
  }
  if (plane_anchor) mark_vertex(flags, listed, V, b, v, 8u);
  gv[0] = gx;
  gv[1] = gy;
  gv[2] = gz;
}

// Backward, part 1: one launch, a cluster of `blocks` CTAs per (body,
// plane) and the mass CTAs (grid (B, 3 blocks + mass CTAs): every body's
// planes first). Two CTAs an SM (at most 64 registers): the mass CTAs
// share the launch and are latency-bound. See the header.
template <int kMode>
__global__ void __launch_bounds__(kPlaneThreads, 2) measure_backward_planes(
    const float* __restrict__ verts, const int* __restrict__ faces,
    const int* __restrict__ plane_faces, const int* __restrict__ anchor_face,
    const float* __restrict__ anchor_bary, const float* __restrict__ hull_cos,
    const float* __restrict__ hull_sin, const float2* __restrict__ hits,
    const int* __restrict__ codes, const float* __restrict__ stats,
    const float* __restrict__ plane_h, const float* __restrict__ g_out,
    const int* __restrict__ corner_ptr, const int4* __restrict__ corners,
    float* __restrict__ grad, float* __restrict__ records,
    int2* __restrict__ words, float* __restrict__ gh_part,
    float* __restrict__ dirs, unsigned* __restrict__ flags,
    int* __restrict__ listed, int V, int Vm, Planes planes, int blocks,
    int cap, int n_records, int n_words, int n_groups, int half_k,
    float angle_step, float density) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* vb = verts + (size_t)b * V * 3;
  if ((int)blockIdx.y >= 3 * blocks) {
    const int v = ((int)blockIdx.y - 3 * blocks) * kPlaneThreads + tid;
    if (v < V) {
      mass_vertex(vb, faces, anchor_face, anchor_bary, stats, g_out,
                  corner_ptr, corners, grad, flags, listed, V, Vm, b, v,
                  density);
    }
    return;
  }
  cluster_arrive_relaxed();  // waited for before the first remote store
  BwdShared& sh = *reinterpret_cast<BwdShared*>(smem);
  // the row's cluster: `blocks` CTAs along y, rank g
  const int p = blockIdx.y / blocks, g = blockIdx.y % blocks;
  const int wpb = (n_words + blocks - 1) / blocks;  // words a CTA
  float* gather = reinterpret_cast<float*>(smem + sizeof(BwdShared));
  unsigned* msk = reinterpret_cast<unsigned*>(gather + blocks * half_k * 4);
  int* first = reinterpret_cast<int*>(msk + wpb);
  const int lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)b * 3 + p;
  const float* st = stats + ((size_t)b * 4 + p) * 4;
  const int n = (int)st[0];
  const float cx = st[1], cz = st[2];
  const int n_walk = planes.n[p];
  const float2* hp = hits + row * cap;
  const int* cp = codes + row * cap;
  // This CTA's words of the hit map: [w0, w1) of the row's.
  const int w_row = (n_walk + kWordSpan - 1) / kWordSpan;
  const int w0 = min(w_row, g * wpb), w1 = min(w_row, w0 + wpb);
  for (int i = tid; i < w1 - w0; i += kPlaneThreads) {
    msk[i] = 0u;
    first[i] = 0x7fffffff;
  }
  // Item w = share * half_k + d takes pair d over the hits share, share +
  // shares, ... of each chunk.
  const int shares = half_k >= kPlaneThreads ? 1 : kPlaneThreads / half_k;
  const int items = shares * half_k;
  for (int w = tid; w < items; w += kPlaneThreads) {
    sh.part_mx[w] = -INFINITY;
    sh.part_mn[w] = INFINITY;
    sh.part_kx[w] = 0;
    sh.part_kn[w] = 0;
  }
  for (int d = tid; d < half_k; d += kPlaneThreads) {  // the pairs, early
    sh.dir[d] = make_float4(hull_cos[d], hull_sin[d], 0.f, 0.f);
  }

  // A lane's hit of its warp's first group of 32 (step 3) and its face,
  // loaded now so that the loads overlap the sweep; the face's vertices
  // marked now.
  const int* ids = plane_faces ? plane_faces + planes.off[p] : nullptr;
  const int groups = (n + kGroup - 1) / kGroup;
  const int k0 = g * kWarps + warp;
  HitInput in;
  unsigned old[3] = {1u, 1u, 1u};  // the face's flags before this mark
  if (k0 < groups && k0 * kGroup + lane < n) {
    load_hit(in, faces, ids, hp, cp, k0 * kGroup + lane);
    for (int c = 0; c < 3; ++c) {
      old[c] = mark_set(flags, V, b, in.face[c], 1u << p);
    }
  }

  // 1. This CTA's words of the hit map, from all the row's codes (2 bits a
  // position: 01 one hit, 11 two; bit operations and a min, exact in any
  // order).
  __syncthreads();  // the words are cleared
  for (int j = tid; j < n; j += kPlaneThreads) {
    const int pos = cp[j] >> 4, w = pos / kWordSpan - w0;
    if (w >= 0 && w < w1 - w0) {
      const bool second = j > 0 && (cp[j - 1] >> 4) == pos;
      atomicOr(&msk[w], 1u << (2 * (pos % kWordSpan) + (second ? 1 : 0)));
      atomicMin(&first[w], j);
    }
  }
  // The valid max and min on every pair of this CTA's run of the hits (CTA
  // r of the row's cluster: [r span, (r + 1) span)) and how many hits
  // reach each.
  const int span = (n + blocks - 1) / blocks;
  const int lo = min(n, g * span), hi = min(n, lo + span);
  for (int start = lo; start < hi; start += kChunk) {
    const int m = min(kChunk, hi - start);
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < m; i += kPlaneThreads) {
      const float2 q = hp[start + i];
      sh.pts[i] = make_float2(q.x - cx, q.y - cz);
    }
    __syncthreads();
    for (int w = tid; w < items; w += kPlaneThreads) {
      const int share = w / half_k, d = w - share * half_k;
      const float c = sh.dir[d].x, s = sh.dir[d].y;
      float mx = sh.part_mx[w], mn = sh.part_mn[w];
      int kx = sh.part_kx[w], kn = sh.part_kn[w];
      int i = share;
      for (; i + (kUnroll - 1) * shares < m; i += kUnroll * shares) {
        float pr[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float2 q = sh.pts[i + u * shares];
          pr[u] = q.x * c + q.y * s;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          kx = pr[u] > mx ? 1 : kx + (pr[u] == mx);
          mx = fmaxf(mx, pr[u]);
          kn = pr[u] < mn ? 1 : kn + (pr[u] == mn);
          mn = fminf(mn, pr[u]);
        }
      }
      for (; i < m; i += shares) {
        const float2 q = sh.pts[i];
        const float pr = q.x * c + q.y * s;
        kx = pr > mx ? 1 : kx + (pr == mx);
        mx = fmaxf(mx, pr);
        kn = pr < mn ? 1 : kn + (pr == mn);
        mn = fminf(mn, pr);
      }
      sh.part_mx[w] = mx;
      sh.part_mn[w] = mn;
      sh.part_kx[w] = kx;
      sh.part_kn[w] = kn;
    }
  }
  __syncthreads();
  int2* wd = words + row * n_words;
  for (int i = tid; i < w1 - w0; i += kPlaneThreads) {
    wd[w0 + i] = make_int2((int)msk[i], first[i]);
  }
  // This CTA's extremes and counts per pair (over its shares) to every
  // rank's gather (stores, so no thread waits on a remote load); after the
  // cluster's barrier every CTA has the row's, exact in any order.
  cluster_wait();  // every CTA of the cluster has started
  for (int d = tid; d < half_k; d += kPlaneThreads) {
    float vx = -INFINITY, vn = INFINITY;
    for (int s = 0; s < shares; ++s) {
      vx = fmaxf(vx, sh.part_mx[s * half_k + d]);
      vn = fminf(vn, sh.part_mn[s * half_k + d]);
    }
    int kx = 0, kn = 0;
    for (int s = 0; s < shares; ++s) {
      if (sh.part_mx[s * half_k + d] == vx) kx += sh.part_kx[s * half_k + d];
      if (sh.part_mn[s * half_k + d] == vn) kn += sh.part_kn[s * half_k + d];
    }
    float* to = gather + (g * half_k + d) * 4;
    for (int r = 0; r < blocks; ++r) {
      st_cluster(to, r, vx);
      st_cluster(to + 1, r, __int_as_float(kx));
      st_cluster(to + 2, r, vn);
      st_cluster(to + 3, r, __int_as_float(kn));
    }
  }
  cluster_sync();  // every rank's extremes are here

  // 2. Per pair: its extremes, the share of each hit that reaches one (the
  // dense formulation's masked points project to 0: with any of them the
  // extreme is max(valid max, 0) (min(valid min, 0)), and at 0 they tie
  // too; the clamp passes where h >= 0), and the sum of the hits' shares.
  const float gp = n >= 2 ? g_out[b * 5 + 2 + p] * angle_step : 0.f;
  const int masked = 2 * n_walk - n;
  float tx = 0.f, tz = 0.f;
  for (int d = tid; d < half_k; d += kPlaneThreads) {
    float vx = -INFINITY, vn = INFINITY;
    for (int r = 0; r < blocks; ++r) {
      vx = fmaxf(vx, gather[(r * half_k + d) * 4]);
      vn = fminf(vn, gather[(r * half_k + d) * 4 + 2]);
    }
    int kx = 0, kn = 0;
    for (int r = 0; r < blocks; ++r) {
      const float* at = gather + (r * half_k + d) * 4;
      if (at[0] == vx) kx += __float_as_int(at[1]);
      if (at[2] == vn) kn += __float_as_int(at[3]);
    }
      const float M = masked > 0 ? fmaxf(vx, 0.f) : vx;
    const int nx = (vx == M ? kx : 0) + (masked > 0 && M == 0.f ? masked : 0);
    const float fx = (vx == M && M >= 0.f && nx > 0) ? gp / (float)nx : 0.f;
    const float mm = masked > 0 ? fminf(vn, 0.f) : vn;
    const int nn = (vn == mm ? kn : 0) + (masked > 0 && mm == 0.f ? masked : 0);
    const float fn = (vn == mm && -mm >= 0.f && nn > 0) ? gp / (float)nn : 0.f;
    const float c = sh.dir[d].x, s = sh.dir[d].y;
    sh.dir[d] = make_float4(c, s, vx, vn);
    sh.coef[d] = make_float4(fx * c, fx * s, fn * c, fn * s);
    const float t = fx * (float)kx - fn * (float)kn;
    tx += t * c;
    tz += t * s;
  }
  // The centroid's share (block_sum's barriers publish the pairs' arrays).
  const float cnt = fmaxf((float)n, 1.f);
  const float cgx = -block_sum(tx, sh.red) / cnt;
  const float cgz = -block_sum(tz, sh.red) / cnt;
  if (g == 0 && n > n_records) {  // for the hits past the records
    float4* dr = reinterpret_cast<float4*>(dirs + row * (8 * half_k + 4));
    for (int d = tid; d < half_k; d += kPlaneThreads) {
      dr[d] = sh.dir[d];
      dr[half_k + d] = sh.coef[d];
    }
    if (tid == 0) dr[2 * half_k] = make_float4(cgx, cgz, 0.f, 0.f);
  }

  // (the first group's marks, issued before the sweep, are back)
  for (int c = 0; c < 3; ++c) {
    mark_listed(flags, listed, V, b, in.face[c], old[c]);
  }

  // 3. A warp a group of 32 hits, a lane a hit: its point cotangent, its
  // chain, its record, its face's vertices marked for plane p, and the
  // group's plane-height cotangent.
  const float h = plane_h[row];
  for (int k = k0; k < groups; k += blocks * kWarps) {
    const int j = k * kGroup + lane;
    float gh = 0.f;
    if (j < n) {
      if (k != k0) {
        load_hit(in, faces, ids, hp, cp, j);
        for (int c = 0; c < 3; ++c) {
          mark_vertex(flags, listed, V, b, in.face[c], 1u << p);
        }
      }
      Tri T;
      load_tri(vb, in.face, T);
      const float2 pg = hull_point_grad(sh.dir, sh.coef, half_k,
                                        in.q.x - cx, in.q.y - cz);
      float g9[kRecord];
      hit_vjp<kMode>(T, h, in.code & 15, pg.x + cgx, pg.y + cgz, g9, gh);
      if (j < n_records) {
        float* r = records + (row * n_records + j) * kRecord;
#pragma unroll
        for (int i = 0; i < kRecord; ++i) r[i] = g9[i];
      }
    }
    for (int o = 16; o > 0; o >>= 1) gh += __shfl_down_sync(0xffffffffu, gh, o);
    if (lane == 0) gh_part[row * n_groups + k] = gh;
  }
}

// The plane height's cotangent of row `row` (B x 3): its hits' groups in
// order, then the output's own.
__device__ float plane_height_grad(const float* gh_part, const float* stats,
                                   const float* g_plane_h, size_t row,
                                   int n_groups) {
  const int n = (int)stats[((row / 3) * 4 + row % 3) * 4];
  const int groups = (n + kGroup - 1) / kGroup;
  const float* gp = gh_part + row * n_groups;
  float s = 0.f;
  for (int k = 0; k < groups; k += 8) {  // 8 loads in flight, added in order
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = k + i < groups ? gp[k + i] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (k + i < groups) s += v[i];
    }
  }
  return s + g_plane_h[row];
}

// A hit past the records, in the vertices pass: its point cotangent and
// chain again with the planes pass's operations (the same bits), its
// vertex-`c` part. Out of line: rare, and it keeps the pass's registers.
template <int kMode>
__device__ __noinline__ float3 hit_again(
    const float* vb, const int* faces, const int* ids, const float2* hits,
    const int* codes, const float* st, const float4* dr, float h, int half_k,
    int j, int c) {
  const float2 q = hits[j];
  const float2 pg = hull_point_grad(dr, dr + half_k, half_k, q.x - st[1],
                                    q.y - st[2]);
  const int code = codes[j], pos = code >> 4;
  const float4 cg = dr[2 * half_k];
  Tri T;
  load_tri(vb, faces + 3 * (ids ? ids[pos] : pos), T);
  float g9[kRecord], gh;
  hit_vjp<kMode>(T, h, code & 15, pg.x + cg.x, pg.y + cg.y, g9, gh);
  return make_float3(g9[3 * c], g9[3 * c + 1], g9[3 * c + 2]);
}

// Backward, part 2: the marked vertices of each body, a thread each. See
// the header.
template <int kMode>
__global__ void __launch_bounds__(kThreads) measure_backward_vertices(
    const float* __restrict__ verts, const int* __restrict__ faces,
    const int* __restrict__ plane_faces, const int* __restrict__ anchor_face,
    const float* __restrict__ anchor_bary, const float2* __restrict__ hits,
    const int* __restrict__ codes, const float* __restrict__ stats,
    const float* __restrict__ plane_h, const float* __restrict__ g_plane_h,
    const float* __restrict__ records, const int2* __restrict__ words,
    const float* __restrict__ gh_part, const float* __restrict__ dirs,
    const int* __restrict__ corner_ptr, const int4* __restrict__ corners,
    const int* __restrict__ plane_ptr, const int* __restrict__ plane_idx,
    const unsigned* __restrict__ flags, const int* __restrict__ listed,
    float* __restrict__ grad, int B, int V, int Vm, Planes planes, int cap,
    int n_records, int n_words, int n_groups, int half_k) {
  const int b = blockIdx.y;
  const float* vb = verts + (size_t)b * V * 3;
  const unsigned* count = flags + (size_t)B * V + b;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < V;
       i += gridDim.x * kThreads) {
    const int v = listed[(size_t)b * V + i];  // loaded beside the count
    if (i >= (int)*count) break;
    const unsigned marks = flags[(size_t)b * V + v];
    // Circumferences: each marked plane's hits in the faces around v, in
    // the entries' order, found through the hit map.
    float hx = 0.f, hy = 0.f, hz = 0.f;
    for (int p = 0; p < 3; ++p) {
      if (!(marks >> p & 1u)) continue;
      const size_t row = (size_t)b * 3 + p;
      const int2* wd = words + row * n_words;
      const float* rec = records + row * n_records * kRecord;
      const int* ptr = plane_ptr ? plane_ptr + (size_t)p * (Vm + 1)
                                 : corner_ptr;
      const int e1 = ptr[v + 1];
      for (int e = ptr[v]; e < e1; e += kProbe) {  // kProbe at once
        int ent[kProbe];
        int2 w[kProbe];
#pragma unroll
        for (int u = 0; u < kProbe; ++u) {
          if (e + u < e1) {
            ent[u] = plane_ptr ? plane_idx[e + u] : corners[e + u].x;
          }
        }
#pragma unroll
        for (int u = 0; u < kProbe; ++u) {
          if (e + u < e1) w[u] = wd[(ent[u] >> 2) / kWordSpan];
        }
#pragma unroll
        for (int u = 0; u < kProbe; ++u) {
          if (e + u >= e1) break;
          const int pos = ent[u] >> 2, c = ent[u] & 3;
          const int shift = 2 * (pos % kWordSpan);
          const unsigned m = (unsigned)w[u].x;
          const int there = __popc((m >> shift) & 3u);
          int j = w[u].y + __popc(m & ((1u << shift) - 1u));
          for (int t = 0; t < there; ++t, ++j) {
            float3 r;
            if (j < n_records) {
              const float* q = rec + (size_t)j * kRecord + 3 * c;
              r = make_float3(q[0], q[1], q[2]);
            } else {
              r = hit_again<kMode>(
                  vb, faces,
                  plane_faces ? plane_faces + planes.off[p] : nullptr,
                  hits + row * cap, codes + row * cap,
                  stats + ((size_t)b * 4 + p) * 4,
                  reinterpret_cast<const float4*>(dirs +
                                                  row * (8 * half_k + 4)),
                  plane_h[row], half_k, j, c);
            }
            hx += r.x;
            hy += r.y;
            hz += r.z;
          }
        }
      }
    }
    float* gv = grad + ((size_t)b * V + v) * 3;
    const float gx = gv[0] + hx, gz = gv[2] + hz;
    float gy = gv[1] + hy;
    // The three plane heights, at their anchors.
    if (marks & 8u) {
      for (int a = 2; a < 5; ++a) {
        const int* f = faces + 3 * anchor_face[a];
        for (int k = 0; k < 3; ++k) {
          if (f[k] != v) continue;
          gy += plane_height_grad(gh_part, stats, g_plane_h,
                                  (size_t)b * 3 + a - 2, n_groups) *
                anchor_bary[3 * a + k];
        }
      }
    }
    gv[0] = gx;
    gv[1] = gy;
    gv[2] = gz;
  }
}

// K1-AoS's slice points (measure_points, measure_points_backward); see the
// header. measure_points is one launch: a block a tile of kPointsTile slots
// of a (body, plane) row (grid (tiles, 3 B): points_plan in
// measure/measurements.py). The backward is a block a tile of kFaceTile
// faces of a body (grid (face tiles, B)), then measure_points_heights.
constexpr int kPointsTile = 2048;  // 24 KB of points staged a block
constexpr int kFaceTile = kThreads;
constexpr int kHeightRows = 4;  // rows of g_h a block of 4 warps sums

// The first index in [lo, hi) whose key is >= key, hi if none, in keys
// sorted ascending; one warp, 32 probes a step (a row of a few hundred
// hits takes two steps). Every lane gets it.
__device__ int warp_lower_bound(const int* __restrict__ keys, int lo, int hi,
                                int key) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const int stride = (hi - lo + 31) >> 5;
    const int i = lo + lane * stride;
    const int c = __popc(__ballot_sync(0xffffffffu, i < hi && keys[i] < key));
    if (c == 0) break;
    const int top = lo + c * stride;
    lo += (c - 1) * stride + 1;
    hi = min(hi, top);
  }
  return lo;
}

// Elements [lo, hi) of src to dst, both aligned to a V at element 0, by the
// whole block: the head and tail one element at a time, the rest as V
// vectors (16 bytes).
template <typename T, typename V>
__device__ __forceinline__ void copy_span(T* __restrict__ dst,
                                          const T* __restrict__ src, int lo,
                                          int hi) {
  constexpr int kVec = sizeof(V) / sizeof(T);
  const int A = min(hi, (lo + kVec - 1) / kVec * kVec);
  const int E = max(A, hi / kVec * kVec);
  for (int k = lo + threadIdx.x; k < A; k += blockDim.x) dst[k] = src[k];
  for (int k = E + threadIdx.x; k < hi; k += blockDim.x) dst[k] = src[k];
  V* dv = reinterpret_cast<V*>(dst);
  const V* sv = reinterpret_cast<const V*>(src);
  for (int j = A / kVec + threadIdx.x; j < E / kVec; j += blockDim.x) {
    dv[j] = sv[j];
  }
}

// The slice points of K1-AoS: block (t, row) writes slots [t kPointsTile,
// ...) of row (body, plane), each slot's 3 floats and its mask byte once.
// The tile is staged in shared memory at the shift its global start has
// from 16 bytes: the fill ((0, h, 0) or 0, repeating every 3 float4s) as
// float4s, then the hits of the tile's faces, found by binary searches of
// the row's codes (face order, strictly increasing: position * 16 +
// detail), overwrite x and z (exact mode: also y, recomputed from the
// crossed edge with the parent scatter's operations); then the tile and
// its mask bytes go out as 16-byte vectors with scalar heads and tails.
template <int kMode>
__global__ void __launch_bounds__(kThreads) measure_points_kernel(
    const float* __restrict__ verts, const float2* __restrict__ hits,
    const int* __restrict__ codes, const float* __restrict__ stats,
    const float* __restrict__ plane_h, float* __restrict__ points,
    unsigned char* __restrict__ valid, int F, int cap) {
  __shared__ __align__(16) float pts[3 * kPointsTile + 4];
  __shared__ __align__(16) unsigned char msk[kPointsTile + 16];
  __shared__ int bounds[4];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int row = blockIdx.y, b = row / 3, p = row - 3 * b;
  const int s0 = blockIdx.x * kPointsTile, s1 = min(2 * F, s0 + kPointsTile);
  // The tile's floats [pa, pa + pn) and mask bytes [ma, ma + mn).
  const long long pa = (long long)row * 6 * F + 3LL * s0;
  const long long ma = kMode == kReference ? (long long)row * 2 * F + s0
                                           : (long long)row * F + s0 / 2;
  const int pn = 3 * (s1 - s0), ps = (int)(pa & 3);
  const int mn = kMode == kReference ? s1 - s0 : (s1 - s0) / 2;
  const int ms = (int)(ma & 15);
  const int n = (int)stats[((size_t)b * 4 + p) * 4];
  const int* cr = codes + (size_t)row * cap;
  // Reference: quad triangle q's hit of face pos sits at slot q F + pos
  // (warps 0-1 search q = 0's positions, 2-3 q = 1's); exact: face pos's
  // first / second point at 2 pos / 2 pos + 1 (warps 0-1).
  if (warp < (kMode == kReference ? 4 : 2)) {
    int lo, hi;
    if (kMode == kReference) {
      const int q = warp >> 1;
      lo = max(s0 - q * F, 0);
      hi = max(lo, min(s1 - q * F, F));
    } else {
      lo = s0 / 2;
      hi = s1 / 2;
    }
    const int j = warp_lower_bound(cr, 0, n, 16 * (warp & 1 ? hi : lo));
    if ((tid & 31) == 0) bounds[warp] = j;
  }
  const float fy = kMode == kReference ? plane_h[row] : 0.f;
  for (int j = tid; j < (ps + pn + 3) / 4; j += kThreads) {
    const int r = (4 * j - ps + 3) % 3;  // the coordinate of its first float
    reinterpret_cast<float4*>(pts)[j] =
        make_float4(r == 1 ? fy : 0.f, r == 0 ? fy : 0.f, r == 2 ? fy : 0.f,
                    r == 1 ? fy : 0.f);
  }
  for (int j = tid; j < (ms + mn + 15) / 16; j += kThreads) {
    reinterpret_cast<uint4*>(msk)[j] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  if (kMode == kReference) {
    const int j0 = bounds[0], c0 = bounds[1] - j0;
    const int j1 = bounds[2], c1 = bounds[3] - j1;
    for (int t = tid; t < c0 + c1; t += kThreads) {
      const int q = t >= c0 ? 1 : 0;
      const int j = q ? j1 + t - c0 : j0 + t;
      const int code = cr[j];
      if (((code >> 3) & 1) != q) continue;  // the other quad triangle's
      const int ls = q * F + (code >> 4) - s0;
      const float2 hit = hits[(size_t)row * cap + j];
      pts[ps + 3 * ls] = hit.x;
      pts[ps + 3 * ls + 2] = hit.y;
      msk[ms + ls] = 1;
    }
  } else {
    const int j0 = bounds[0], c = bounds[1] - j0;
    const float h = plane_h[row];
    const float* vb = verts + (size_t)b * 9 * F;
    for (int t = tid; t < c; t += kThreads) {
      const int j = j0 + t, code = cr[j], pos = code >> 4, detail = code & 15;
      const int a = detail & 3, e = a == 2 ? 0 : a + 1;
      const float ya = vb[9 * pos + 3 * a + 1], ye = vb[9 * pos + 3 * e + 1];
      const float tt = (ya - h) / exact_denom(ya - h, ye - h);
      const int ls = 2 * pos + (detail >> 2) - s0;
      const float2 hit = hits[(size_t)row * cap + j];
      pts[ps + 3 * ls] = hit.x;
      pts[ps + 3 * ls + 1] = ya + tt * (ye - ya);
      pts[ps + 3 * ls + 2] = hit.y;
      msk[ms + pos - s0 / 2] = 1;
    }
  }
  __syncthreads();
  copy_span<float, float4>(points + (pa - ps), pts, ps, ps + pn);
  copy_span<unsigned char, uint4>(valid + (ma - ms), msk, ms, ms + mn);
}

// A 16-byte copy from global to shared memory that the thread does not
// wait for (cp.async), and the wait for all of this thread's.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// The backward of the slice points: block (t, b) takes faces [t kFaceTile,
// ...) of body b, a thread a face. First, all at once: the faces'
// triangles (36 contiguous bytes each: the walk's faces are (3f, 3f + 1,
// 3f + 2)) are copied into shared memory by 16-byte cp.async; each thread
// loads its face's mask bytes of the walked planes (the forward's
// measure_points wrote them from its hits) and, in reference mode, the
// y-cotangents of its slots f and F + f (every slot's y is the plane
// height). Then each thread recomputes its face's hits (the forward's
// operations on the staged triangle, so the same hits with the same
// formulas) only where the masks hold one: in reference mode first_hit of
// each quad triangle whose slot is set, in exact mode slice_tri; it loads
// their slots' cotangents at once and takes each hit's VJP with hit_vjp:
// the face's 9 coordinates get their sum over the planes, in plane order,
// written back through shared memory as 16-byte stores. Per plane, each
// thread's plane-height cotangent (its hits' terms, then in reference mode
// its two y-cotangents) is summed over the block (block_sum's tree) into
// partial (B, 3, tiles); measure_points_heights then sums each row's
// partials in tile order. No atomics.
template <int kMode>
__global__ void __launch_bounds__(kThreads) measure_points_backward_kernel(
    const float* __restrict__ verts, const unsigned char* __restrict__ valid,
    const float* __restrict__ plane_h, const float* __restrict__ g_points,
    float* __restrict__ grad, float* __restrict__ partial, int F,
    Planes planes) {
  __shared__ __align__(16) float tri[9 * kFaceTile + 4];
  __shared__ float red[3][32];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, f0 = blockIdx.x * kFaceTile;
  const int f1 = min(F, f0 + kFaceTile);
  const int f = f0 + tid;
  const long long fa = ((long long)b * F + f0) * 9;  // the tile's floats
  const int fs = (int)(fa & 3), fn = 9 * (f1 - f0);
  {  // the triangles, as copy_span splits them
    const float* src = verts + (fa - fs);
    const int A = min(fs + fn, (fs + 3) & ~3);
    const int E = max(A, (fs + fn) & ~3);
    for (int k = fs + tid; k < A; k += kThreads) tri[k] = src[k];
    for (int k = E + tid; k < fs + fn; k += kThreads) tri[k] = src[k];
    for (int j = A / 4 + tid; j < E / 4; j += kThreads) {
      cp_async16(tri + 4 * j, src + 4 * j);
    }
  }
  // Reference mode: the masks of quad triangle q's slot, bit q; exact
  // mode: the face's mask.
  unsigned hit_here[3] = {0u, 0u, 0u};
  float gy[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
  if (f < F) {
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      if (planes.n[p] == 0) continue;
      const size_t row = (size_t)b * 3 + p;
      if (kMode == kReference) {
        const unsigned char* vr = valid + row * 2 * (size_t)F;
        hit_here[p] = (vr[f] != 0) | (vr[F + f] != 0) << 1;
        const float* gp = g_points + row * 6 * (size_t)F;
        gy[p][0] = gp[3 * (size_t)f + 1];
        gy[p][1] = gp[3 * ((size_t)F + f) + 1];
      } else {
        hit_here[p] = valid[row * F + f] != 0;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  float g9[9], s[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 9; ++k) g9[k] = 0.f;
  float* own = tri + fs + 9 * tid;
  if (f < F) {
    Tri T;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      T.x[k] = own[3 * k];
      T.y[k] = own[3 * k + 1];
      T.z[k] = own[3 * k + 2];
    }
    T.e1x = T.x[1] - T.x[0]; T.e1y = T.y[1] - T.y[0]; T.e1z = T.z[1] - T.z[0];
    T.e2x = T.x[2] - T.x[0]; T.e2y = T.y[2] - T.y[0]; T.e2z = T.z[2] - T.z[0];
    // This face's hits a plane (code order) and their slots' cotangents,
    // loaded at once.
    int nh[3], detail[3][2];
    float h[3], gs[3][2][3];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      nh[p] = 0;
      if (!hit_here[p]) continue;
      const size_t row = (size_t)b * 3 + p;
      h[p] = plane_h[row];
      if (kMode == kReference) {  // only the quad triangles that hit
        float ha, hb;
        if (hit_here[p] & 1u) {
          detail[p][0] = first_hit(T, h[p], 0, ha, hb);
          nh[p] = 1;
        }
        if (hit_here[p] & 2u) {
          const int d = 8 + first_hit(T, h[p], 1, ha, hb);
          if (nh[p]) detail[p][1] = d; else detail[p][0] = d;
          nh[p] += 1;
        }
      } else {
        float2 p0, p1;
        int k0 = 0, k1 = 0;
        nh[p] = slice_tri<kMode>(T, f, f, h[p], p0, p1, k0, k1);
        detail[p][0] = k0 & 15;
        detail[p][1] = k1 & 15;
      }
      const float* gp = g_points + row * 6 * (size_t)F;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (k >= nh[p]) break;
        const int slot = kMode == kReference ? (detail[p][k] >> 3) * F + f
                                             : 2 * f + (detail[p][k] >> 2);
        const float* g3 = gp + 3 * (size_t)slot;
        gs[p][k][0] = g3[0];
        gs[p][k][1] = kMode == kExact ? g3[1] : 0.f;
        gs[p][k][2] = g3[2];
      }
    }
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      if (planes.n[p] == 0) continue;
      float gh = 0.f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (k >= nh[p]) break;
        float gv[9], ghit;
        hit_vjp<kMode>(T, h[p], detail[p][k], gs[p][k][0], gs[p][k][2], gv,
                       ghit, gs[p][k][1]);
#pragma unroll
        for (int c = 0; c < 9; ++c) g9[c] += gv[c];
        gh += ghit;
      }
      s[p] = gh;
      if (kMode == kReference) {
        s[p] += gy[p][0];
        s[p] += gy[p][1];
      }
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) own[k] = g9[k];  // its own staged floats
  }
  __syncthreads();
  copy_span<float, float4>(grad + (fa - fs), tri, fs, fs + fn);
  // block_sum's tree for the three planes at once: each warp's shuffles,
  // then warp 0's over the warps' sums.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int p = 0; p < 3; ++p) s[p] += __shfl_down_sync(0xffffffffu, s[p], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int p = 0; p < 3; ++p) red[p][warp] = s[p];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      float v = lane < kThreads / 32 ? red[p][lane] : 0.f;
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if (lane == 0) {
        partial[((size_t)b * 3 + p) * gridDim.x + blockIdx.x] = v;
      }
    }
  }
}

// g_h (rows,) = each row's `tiles` partials summed in tile order: a warp a
// row, lane l over partials l, l + 32, ..., then a shuffle tree.
__global__ void __launch_bounds__(32 * kHeightRows) measure_points_heights(
    const float* __restrict__ partial, float* __restrict__ g_h, int rows,
    int tiles) {
  const int row = blockIdx.x * kHeightRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp
  const float* pr = partial + (size_t)row * tiles;
  float s = 0.f;
  for (int i = lane; i < tiles; i += 32) s += pr[i];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if (lane == 0) g_h[row] = s;
}

// The forward's dynamic shared memory: FwdShared and rank 0's gather.
size_t forward_smem(int cluster, int half_k) {
  return sizeof(FwdShared) + (size_t)cluster * half_k * 2 * sizeof(float);
}

template <int kMode>
int launch_forward(const void* verts, const void* faces,
                   const void* plane_faces, const void* anchor_face,
                   const void* anchor_bary, const void* hull_cos,
                   const void* hull_sin, void* hits, void* codes,
                   void* staged, void* staged_codes, void* stats, void* out,
                   void* plane_h, int B, int V, int F, Planes planes, int cap,
                   int half_k, float angle_step, float density, int cluster,
                   Spans spans, void* stream) {
  if (half_k < 1 || half_k > kMaxHalfK || cluster < 1 ||
      cluster > kMaxCluster || B > 65535 ||
      (long long)spans.mass * cluster < F) {
    return (int)cudaErrorInvalidValue;
  }
  for (int p = 0; p < 3; ++p) {  // the plan covers every walk position
    if ((long long)spans.plane[p] * cluster < planes.n[p] ||
        2 * planes.n[p] > cap) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const size_t smem = forward_smem(cluster, half_k);
  auto kernel = measure_cluster_kernel<kMode>;
  // Per device: the shared memory raised as far as a launch needed, and
  // clusters above the portable 8 allowed.
  static size_t smem_set[64] = {};
  static bool wide[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = smem;
  }
  if (cluster > 8 && (dev >= 64 || !wide[dev])) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) wide[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 4, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, (const float*)verts, (const int*)faces,
      (const int*)plane_faces, (const int*)anchor_face,
      (const float*)anchor_bary, (const float*)hull_cos,
      (const float*)hull_sin, (float2*)hits, (int*)codes, (float2*)staged,
      (int*)staged_codes, (float*)stats, (float*)out, (float*)plane_h, V, F,
      planes, spans, cap, half_k, angle_step, density);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The planes pass's dynamic shared memory: BwdShared, the gather of the
// cluster's extremes (4 words a (rank, pair)) and a CTA's words of the hit
// map (a mask and an int each).
size_t backward_smem(int n_words, int blocks, int half_k) {
  const int wpb = (n_words + blocks - 1) / blocks;
  return sizeof(BwdShared) + (size_t)blocks * half_k * 4 * sizeof(float) +
         (size_t)wpb * (sizeof(unsigned) + sizeof(int));
}

template <int kMode>
int launch_backward(const void* verts, const void* faces,
                    const void* plane_faces, const void* anchor_face,
                    const void* anchor_bary, const void* hull_cos,
                    const void* hull_sin, const void* hits, const void* codes,
                    const void* stats, const void* plane_h, const void* g_out,
                    const void* g_plane_h, void* records, void* words,
                    void* gh_part, void* dirs, void* flags, void* listed,
                    const void* corner_ptr, const void* corners,
                    const void* plane_ptr, const void* plane_idx, void* grad,
                    int B, int V, int Vm, Planes planes, int cap, int blocks,
                    int n_records, int n_words, int n_groups, int half_k,
                    float angle_step, float density, void* stream) {
  int most = 1;
  for (int p = 0; p < 3; ++p) most = std::max(most, planes.n[p]);
  // the mass CTAs, a whole number of clusters
  const int mass_ctas = ((V + kPlaneThreads - 1) / kPlaneThreads + blocks -
                         1) / blocks * blocks;
  if (half_k < 1 || half_k > kMaxHalfK || blocks < 1 || blocks > 8 ||
      3 * blocks + mass_ctas > 65535 ||
      n_words < (most + kWordSpan - 1) / kWordSpan ||
      n_groups < (2 * most + kGroup - 1) / kGroup || 2 * most > cap ||
      n_records < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  // The marks: B x V flags, then B counts, all 0.
  cudaError_t err =
      cudaMemsetAsync(flags, 0, sizeof(unsigned) * (size_t)B * (V + 1), s);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = backward_smem(n_words, blocks, half_k);
  auto planes_kernel = measure_backward_planes<kMode>;
  static size_t smem_set[64] = {};  // per device, as launch_forward
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && (dev >= 64 || smem > smem_set[dev])) {
    err = cudaFuncSetAttribute(
        planes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, 3 * blocks + mass_ctas);
  cfg.blockDim = dim3(kPlaneThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = blocks;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, planes_kernel,
      (const float*)verts, (const int*)faces, (const int*)plane_faces,
      (const int*)anchor_face, (const float*)anchor_bary,
      (const float*)hull_cos, (const float*)hull_sin, (const float2*)hits,
      (const int*)codes, (const float*)stats, (const float*)plane_h,
      (const float*)g_out, (const int*)corner_ptr, (const int4*)corners,
      (float*)grad, (float*)records, (int2*)words, (float*)gh_part,
      (float*)dirs, (unsigned*)flags, (int*)listed, V, Vm, planes, blocks,
      cap, n_records, n_words, n_groups, half_k, angle_step, density);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  measure_backward_vertices<kMode><<<dim3(kMarkedCtas, B), kThreads, 0, s>>>(
      (const float*)verts,
      (const int*)faces, (const int*)plane_faces, (const int*)anchor_face,
      (const float*)anchor_bary, (const float2*)hits, (const int*)codes,
      (const float*)stats, (const float*)plane_h, (const float*)g_plane_h,
      (const float*)records, (const int2*)words, (const float*)gh_part,
      (const float*)dirs, (const int*)corner_ptr, (const int4*)corners,
      (const int*)plane_ptr, (const int*)plane_idx, (const unsigned*)flags,
      (const int*)listed, (float*)grad, B, V, Vm, planes, cap, n_records,
      n_words, n_groups, half_k);
  return (int)cudaGetLastError();
}

Planes make_planes(int off0, int off1, int off2, int n0, int n1, int n2) {
  Planes planes;
  planes.off[0] = off0; planes.off[1] = off1; planes.off[2] = off2;
  planes.n[0] = n0; planes.n[1] = n1; planes.n[2] = n2;
  return planes;
}

Spans make_spans(int span0, int span1, int span2, int mass) {
  Spans spans;
  spans.plane[0] = span0; spans.plane[1] = span1; spans.plane[2] = span2;
  spans.mass = mass;
  return spans;
}

}  // namespace

// Forward. verts (B, V, 3) f32; faces (F, 3) i32; plane_faces the three
// planes' face-id lists back to back (i32), or NULL to walk all F faces (ids
// = positions); anchor_face (5,) i32 and anchor_bary (5, 3) f32 for head
// top, left heel, chest, waist, hips; hull_cos / hull_sin (half_k,) f32;
// hits (B, 3, cap) float2 and codes (B, 3, cap) i32 with cap >= 2 * max(n),
// staged / staged_codes scratch of their shapes; stats (B, 4, 4) f32 (per
// plane: hits, centroid x, z; row 3: the signed volume sum); out (B, 5) f32
// = mass, height, chest, waist, hips; plane_h (B, 3) f32. The plan
// (measure_plan): a cluster of `cluster` CTAs, each walking span0 / span1
// / span2 positions of a plane or span_mass faces. Returns the launch's
// error, else cudaGetLastError().
#define MEASURE_FORWARD_ARGS                                                  \
  const void *verts, const void *faces, const void *plane_faces,              \
      const void *anchor_face, const void *anchor_bary, const void *hull_cos, \
      const void *hull_sin, void *hits, void *codes, void *staged,            \
      void *staged_codes, void *stats, void *out, void *plane_h, int B,       \
      int V, int F, int off0, int off1, int off2, int n0, int n1, int n2,    \
      int cap, int half_k, float angle_step, float density, int cluster,     \
      int span0, int span1, int span2, int span_mass, void *stream
#define MEASURE_FORWARD_CALL                                                  \
  verts, faces, plane_faces, anchor_face, anchor_bary, hull_cos, hull_sin,    \
      hits, codes, staged, staged_codes, stats, out, plane_h, B, V, F,        \
      make_planes(off0, off1, off2, n0, n1, n2), cap, half_k, angle_step,    \
      density, cluster, make_spans(span0, span1, span2, span_mass), stream

extern "C" int measure_forward(MEASURE_FORWARD_ARGS) {
  return launch_forward<kReference>(MEASURE_FORWARD_CALL);
}

extern "C" int measure_exact_forward(MEASURE_FORWARD_ARGS) {
  return launch_forward<kExact>(MEASURE_FORWARD_CALL);
}

// Backward of the forward above, with its inputs and saved hits, codes,
// stats and plane_h. g_out (B, 5) and g_plane_h (B, 3) f32 are the output
// cotangents. The plan (measure_backward_plan): `blocks` CTAs a (body,
// plane), records of the first n_records hits a row, n_words >= (max(n) +
// 15) / 16 words of the hit map and n_groups >= (2 max(n) + 31) / 32
// groups a row; their scratch: records (B, 3, n_records, 9) f32, words
// (B, 3, n_words, 2) i32, gh_part (B, 3, n_groups) f32, dirs (B, 3,
// 8 half_k + 4) f32, flags (B (V + 1),) i32 (cleared here) and listed
// (B, V) i32. corner_ptr (Vm + 1,) and corners (3F, 4) i32 list each
// vertex's (face * 4 + corner, the face's next vertex, its previous
// vertex, 0) in face order; plane_ptr (3, Vm + 1) and plane_idx i32 list
// (walk position * 4 + corner) for the planes' face lists, or NULL when the
// planes walk all faces; grad (B, V, 3) f32, vertices >= Vm get 0. Returns
// the launches' error, else cudaGetLastError().
#define MEASURE_BACKWARD_ARGS                                                 \
  const void *verts, const void *faces, const void *plane_faces,              \
      const void *anchor_face, const void *anchor_bary, const void *hull_cos, \
      const void *hull_sin, const void *hits, const void *codes,              \
      const void *stats, const void *plane_h, const void *g_out,              \
      const void *g_plane_h, void *records, void *words, void *gh_part,       \
      void *dirs, void *flags, void *listed, const void *corner_ptr,          \
      const void *corners, const void *plane_ptr, const void *plane_idx,      \
      void *grad, int B, int V, int Vm, int off0, int off1, int off2, int n0, \
      int n1, int n2, int cap, int blocks, int n_records, int n_words,        \
      int n_groups, int half_k, float angle_step, float density, void *stream
#define MEASURE_BACKWARD_CALL                                                 \
  verts, faces, plane_faces, anchor_face, anchor_bary, hull_cos, hull_sin,    \
      hits, codes, stats, plane_h, g_out, g_plane_h, records, words, gh_part, \
      dirs, flags, listed, corner_ptr, corners, plane_ptr, plane_idx, grad,   \
      B, V, Vm, make_planes(off0, off1, off2, n0, n1, n2), cap, blocks,       \
      n_records, n_words, n_groups, half_k, angle_step, density, stream

extern "C" int measure_backward(MEASURE_BACKWARD_ARGS) {
  return launch_backward<kReference>(MEASURE_BACKWARD_CALL);
}

extern "C" int measure_exact_backward(MEASURE_BACKWARD_ARGS) {
  return launch_backward<kExact>(MEASURE_BACKWARD_CALL);
}

// K1-AoS slice points, after measure_forward (exact: measure_exact_forward)
// walked all F faces of verts (B, 3F, 3), the triangles with the faces (3f,
// 3f + 1, 3f + 2), with its hits, codes (B, 3, cap), stats and plane_h.
// points (B, 3, 6F) f32 and valid (B, 3, 2F) (exact: (B, 3, F)) bytes,
// both 16-byte aligned, are written whole, each byte once, by one launch of
// `tiles` = ceil(2F / tile) tiles a row (tile = kPointsTile; points_plan).
// Returns cudaErrorInvalidValue for another plan or a misaligned output,
// else cudaGetLastError().
extern "C" int measure_points(const void* verts, const void* hits,
                              const void* codes, const void* stats,
                              const void* plane_h, void* points, void* valid,
                              int B, int F, int cap, int tile, int tiles,
                              int exact, void* stream) {
  if (B < 1 || F < 1 || 3LL * B > 65535 || cap < 2 * F ||
      tile != kPointsTile || tiles != (2 * F + kPointsTile - 1) / kPointsTile ||
      ((uintptr_t)points & 15) || ((uintptr_t)valid & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(tiles, 3 * B);
  const cudaStream_t s = (cudaStream_t)stream;
  if (exact) {
    measure_points_kernel<kExact><<<grid, kThreads, 0, s>>>(
        (const float*)verts, (const float2*)hits, (const int*)codes,
        (const float*)stats, (const float*)plane_h, (float*)points,
        (unsigned char*)valid, F, cap);
  } else {
    measure_points_kernel<kReference><<<grid, kThreads, 0, s>>>(
        (const float*)verts, (const float2*)hits, (const int*)codes,
        (const float*)stats, (const float*)plane_h, (float*)points,
        (unsigned char*)valid, F, cap);
  }
  return (int)cudaGetLastError();
}

// The VJP of measure_points: g_points (B, 3, 6F) f32, the cotangent of its
// points, after the forward of the same mode walked all F faces of verts
// (B, 3F, 3) (16-byte aligned) and measure_points wrote plane_h's points
// and their masks valid (B, 3, 2F) (exact: (B, 3, F)) (n0..n2: F for the
// planes whose points are outputs, else 0). Writes grad (B, 3F, 3)
// (16-byte aligned), the gradient through the crossed edges' endpoints,
// and g_h (B, 3), the plane heights' cotangent (the caller adds it to K1's
// backward, which takes it to the anchor triangles); partial (B, 3, tiles)
// f32 is scratch, tiles = ceil(F / face_tile), face_tile = kFaceTile
// (points_plan). Two launches. Returns cudaErrorInvalidValue for another
// plan or a misaligned array, else the launches' error.
extern "C" int measure_points_backward(
    const void* verts, const void* valid, const void* plane_h,
    const void* g_points, void* grad, void* partial, void* g_h, int B, int F,
    int face_tile, int tiles, int n0, int n1, int n2, int exact,
    void* stream) {
  const int n[3] = {n0, n1, n2};
  for (int p = 0; p < 3; ++p) {
    if (n[p] != 0 && n[p] != F) return (int)cudaErrorInvalidValue;
  }
  if (B < 1 || F < 1 || B > 65535 || face_tile != kFaceTile ||
      tiles != (F + kFaceTile - 1) / kFaceTile ||
      ((uintptr_t)verts & 15) || ((uintptr_t)grad & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const Planes planes = make_planes(0, 0, 0, n0, n1, n2);
  const dim3 grid(tiles, B);
  if (exact) {
    measure_points_backward_kernel<kExact><<<grid, kThreads, 0, s>>>(
        (const float*)verts, (const unsigned char*)valid,
        (const float*)plane_h, (const float*)g_points, (float*)grad,
        (float*)partial, F, planes);
  } else {
    measure_points_backward_kernel<kReference><<<grid, kThreads, 0, s>>>(
        (const float*)verts, (const unsigned char*)valid,
        (const float*)plane_h, (const float*)g_points, (float*)grad,
        (float*)partial, F, planes);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows = 3 * B;
  measure_points_heights<<<(rows + kHeightRows - 1) / kHeightRows,
                           32 * kHeightRows, 0, s>>>(
      (const float*)partial, (float*)g_h, rows, tiles);
  return (int)cudaGetLastError();
}
