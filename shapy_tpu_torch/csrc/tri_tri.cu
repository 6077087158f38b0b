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
// What bounds it on the H100: at a full-width SMPL-X body pair (Q = F =
// 20908, M = 256) the (B, Q * M) ids and (B, Q * M, 2, 3) barycentrics
// are 150 MB a pair, written once (~45 us at 3.35 TB/s), and the AABB
// test of all Q x F = 437 M pairs is ~6 operations each (~40 us at 67
// TFLOP/s); the full test runs only on the pairs whose boxes overlap.
//
// Design: one launch computes the targets' planes and boxes once per body
// into a (B, 10, F) structure of arrays (the JAX code hoists the same out
// of its query loop). The second gives each query triangle one warp; the
// block's 8 warps stage 256 targets' boxes at a time in shared memory and
// each lane tests one target per step, box first, then the full interval
// test for the few that pass. `__ballot_sync` and the population count of
// the lower lanes give each hit its slot, so the ids come out in index
// order, as top_k gives them (atomics would not). A warp stops testing
// once `max_collisions` hits are written and fills the rest of its slots
// with -1 and zero barycentrics. Every dot and cross product is summed x,
// then y, then z, and the build contracts no a * b + c into an FMA, so
// each sign, overlap and box decision rounds as in the plain PyTorch
// version (`ops/tri_tri.py:mesh_mesh_intersection_plain`).
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;   // query triangles per block
constexpr int kTile = 256;  // targets staged per step
constexpr float kEps = 1e-9f;

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

// geom (B, 10, F): the target planes' n (3) and d, then each box's min (3)
// and max (3).
__global__ void target_geom_kernel(const float* __restrict__ target, int B,
                                   int F, float* __restrict__ geom) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (f >= F) return;
  const float* t = target + ((size_t)b * F + f) * 9;
  const V3 p0 = load3(t), p1 = load3(t + 3), p2 = load3(t + 6);
  const V3 n = cross(sub(p1, p0), sub(p2, p0));
  float* g = geom + (size_t)b * 10 * F + f;
  g[0] = n.x;
  g[F] = n.y;
  g[2 * F] = n.z;
  g[3 * F] = -dot(n, p0);
  g[4 * F] = fminf(fminf(p0.x, p1.x), p2.x);
  g[5 * F] = fminf(fminf(p0.y, p1.y), p2.y);
  g[6 * F] = fminf(fminf(p0.z, p1.z), p2.z);
  g[7 * F] = fmaxf(fmaxf(p0.x, p1.x), p2.x);
  g[8 * F] = fmaxf(fmaxf(p0.y, p1.y), p2.y);
  g[9 * F] = fmaxf(fmaxf(p0.z, p1.z), p2.z);
}

__global__ void __launch_bounds__(kWarps * 32)
    tri_tri_kernel(const float* __restrict__ query,
                   const float* __restrict__ target,
                   const float* __restrict__ geom, int Q, int F, int M,
                   int* __restrict__ faces, float* __restrict__ bcs) {
  __shared__ float box[6][kTile];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qi = blockIdx.x * kWarps + warp;
  const bool has_query = qi < Q;
  const float* tb = target + (size_t)b * F * 9;
  const float* gb = geom + (size_t)b * 10 * F;

  V3 qv[3] = {};
  V3 nq = {}, qmin = {}, qmax = {};
  float dq = 0.f;
  if (has_query) {
    const float* qp = query + ((size_t)b * Q + qi) * 9;
    qv[0] = load3(qp);
    qv[1] = load3(qp + 3);
    qv[2] = load3(qp + 6);
    nq = cross(sub(qv[1], qv[0]), sub(qv[2], qv[0]));
    dq = -dot(nq, qv[0]);
    qmin = {fminf(fminf(qv[0].x, qv[1].x), qv[2].x),
            fminf(fminf(qv[0].y, qv[1].y), qv[2].y),
            fminf(fminf(qv[0].z, qv[1].z), qv[2].z)};
    qmax = {fmaxf(fmaxf(qv[0].x, qv[1].x), qv[2].x),
            fmaxf(fmaxf(qv[0].y, qv[1].y), qv[2].y),
            fmaxf(fmaxf(qv[0].z, qv[1].z), qv[2].z)};
  }
  const size_t slot0 = ((size_t)b * Q + qi) * M;
  int count = 0;  // hits so far, the same in every lane of the warp
  for (int base = 0; base < F; base += kTile) {
    const bool done = !has_query || count >= M;
    if (__syncthreads_and(done)) break;
    for (int i = threadIdx.x; i < 6 * kTile; i += kWarps * 32) {
      const int k = i / kTile, f = base + i % kTile;
      box[k][i % kTile] = f < F ? gb[(size_t)(4 + k) * F + f] : 0.f;
    }
    __syncthreads();
    if (done) continue;
    const int end = min(kTile, F - base);
    for (int j0 = 0; j0 < end && count < M; j0 += 32) {
      const int j = j0 + lane;
      const int f = base + j;
      bool hit = false;
      V3 p0 = {}, p1 = {};
      V3 tv[3];
      if (j < end && box[0][j] <= qmax.x && box[1][j] <= qmax.y &&
          box[2][j] <= qmax.z && box[3][j] >= qmin.x &&
          box[4][j] >= qmin.y && box[5][j] >= qmin.z) {
        const float* t = tb + (size_t)f * 9;
        tv[0] = load3(t);
        tv[1] = load3(t + 3);
        tv[2] = load3(t + 6);
        const V3 nt = {gb[f], gb[F + f], gb[2 * F + f]};
        const float dt = gb[3 * F + f];
        float dist_t[3], dist_q[3];
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          dist_t[v] = dot(nq, tv[v]) + dq;
          dist_q[v] = dot(nt, qv[v]) + dt;
        }
        const V3 dir = cross(nq, nt);
        const Segment st = segment_on_line(tv, dist_t, dir);
        const Segment sq = segment_on_line(qv, dist_q, dir);
        const float lo = fmaxf(st.lo, sq.lo), hi = fminf(st.hi, sq.hi);
        hit = st.valid && sq.valid && hi > lo;
        p0 = pick(st.lo >= sq.lo, st.p_lo, sq.p_lo);
        p1 = pick(st.hi <= sq.hi, st.p_hi, sq.p_hi);
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      const int slot = count + __popc(ballot & ((1u << lane) - 1u));
      if (hit && slot < M) {
        faces[slot0 + slot] = f;
        float* o = bcs + (slot0 + slot) * 6;
        barycentric(tv, p0, o);
        barycentric(tv, p1, o + 3);
      }
      count += __popc(ballot);
    }
  }
  if (!has_query) return;
  for (int s = min(count, M) + lane; s < M; s += 32) {
    faces[slot0 + s] = -1;
    float* o = bcs + (slot0 + s) * 6;
#pragma unroll
    for (int k = 0; k < 6; ++k) o[k] = 0.f;
  }
}

}  // namespace

// query (B, Q, 3, 3) and target (B, F, 3, 3) f32; geom (B, 10, max(F, 1))
// f32 scratch; faces (B, Q * M) int32 and bcs (B, Q * M, 2, 3) f32 out.
// All contiguous on the device. Returns cudaGetLastError().
extern "C" int tri_tri_forward(const void* query, const void* target,
                               void* geom, void* faces, void* bcs, int B,
                               int Q, int F, int M, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (F > 0) {
    target_geom_kernel<<<dim3((F + 255) / 256, B), 256, 0, s>>>(
        (const float*)target, B, F, (float*)geom);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  tri_tri_kernel<<<dim3((Q + kWarps - 1) / kWarps, B), kWarps * 32, 0, s>>>(
      (const float*)query, (const float*)target, (const float*)geom, Q, F, M,
      (int*)faces, (float*)bcs);
  return (int)cudaGetLastError();
}
