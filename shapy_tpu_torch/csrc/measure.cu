// K1 measure, reference slice mode, forward only.
//
// Replaces: shapy_tpu/measure/measurements.py:BodyMeasurements
// .forward_from_vertices (lines 313-390) in slice_mode="reference", i.e.
// ops/plane_slice.py:plane_slice_reference_soa (line 74) +
// ops/convex_hull.py:hull_perimeter_support_xz (line 53) for the chest,
// waist and hips planes, plus the signed-volume mass and the anchor height.
// The fused Pallas measurement kernel (ops/measure_pallas.py) that once did
// this on the TPU was deleted; the JAX package runs it as dense XLA ops
// over all 2F candidate points.
//
// What bounds it on the H100: latency and arithmetic per face, not memory.
// The body's vertices (126 KB for SMPL-X) are gathered through L1/L2; a
// plane walks its candidate faces (a few thousand with face subsets, all
// F = 20908 without) at ~100 FLOPs each for the six ordered hit tests; the
// hull is (hits x K/2) multiply-adds, and a slice of a body has only some
// hundreds of hits, against the 2F padded points the dense formulation
// projects.
//
// Design: one block per (body, plane), plus one block per body for mass
// and height (grid = (4, B)).
//   * Each thread walks faces with a stride and runs the first-hit
//     emulation of plane_slice_reference_soa for both quad triangles: 3
//     Moller casts of the quad edges (|det| >= 1e-4), then 3 body-edge
//     crossings with half-plane tests; the first hit wins; face id 0
//     (also the subset padding) is dropped.
//   * Hits are compacted into a global scratch buffer the wrapper
//     allocates (2 per walked face at most: 334 KB at full F would not fit
//     the 227 KB of shared memory) through a shared atomic counter. Their
//     order does not matter: the hull only takes a max and a min.
//   * The masked centroid comes from per-thread sums and a fixed-order
//     block reduction, so it is deterministic.
//   * Hits are then staged, centred, through shared memory in chunks;
//     thread d owns the antipodal direction pair (theta_d, theta_d + pi):
//     h = max(max proj, 0) + max(-min proj, 0). The block sums h over the
//     pairs, times 2 pi / K; the result is 0 with fewer than 2 hits.
//   * Mass: |sum of the 6-term determinants| / 6 * density, in the term
//     order of measurements.py:354-358. Height: |y(head) - y(heel)| at the
//     barycentric anchors.
// Built with --fmad=false so the hit tests round exactly as the plain
// PyTorch version: a contracted a*b+c could flip a boundary hit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;  // hull points staged per pass (16 KB)
constexpr float kEps = 1e-4f;

struct Planes {
  int off[3];  // start of each plane's face list in plane_faces
  int n[3];    // faces each plane walks
};

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

struct Tri {
  float ax0, ay0, az0, ax1, ay1, az1, ax2, ay2, az2;
  float e1x, e1y, e1z, e2x, e2y, e2z;
};

// A quad edge (origin (ox, h, oz), direction (dx, 0, dz)) against the body
// triangle: Moller-Trumbore, in plane_slice.py's operation order.
__device__ __forceinline__ bool quad_edge_hit(const Tri& T, float h, float ox,
                                              float oz, float dx, float dz,
                                              float& ha, float& hb) {
  const float px = -dz * T.e2y;
  const float py = dz * T.e2x - dx * T.e2z;
  const float pz = dx * T.e2y;
  const float det = T.e1x * px + T.e1y * py + T.e1z * pz;
  if (!(fabsf(det) >= kEps)) return false;
  const float inv = 1.0f / det;
  const float tx = ox - T.ax0, ty = h - T.ay0, tz = oz - T.az0;
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

// A body edge a->b crossing the plane y = h inside quad triangle q.
__device__ __forceinline__ bool body_edge_hit(float vax, float vay, float vaz,
                                              float vbx, float vby, float vbz,
                                              float h, int q, float& ha,
                                              float& hb) {
  const float dy = vby - vay;
  if (!(fabsf(4.0f * dy) >= kEps)) return false;
  const float t = (h - vay) / dy;
  if (!(t >= 0.f && t <= 1.f)) return false;
  const float cx = vax + t * (vbx - vax);
  const float cz = vaz + t * (vbz - vaz);
  const bool in = q == 0
      ? (cx >= cz && cx - cz <= 2.f && cz >= -1.f && cx <= 1.f)
      : (cx >= -1.f && cx <= 1.f && cz >= cx && cz <= 1.f);
  if (!in) return false;
  ha = cx;
  hb = cz;
  return true;
}

__device__ __forceinline__ bool first_hit(const Tri& T, float h, int q,
                                          float& ha, float& hb) {
  if (q == 0) {
    if (quad_edge_hit(T, h, -1.f, -1.f, 2.f, 0.f, ha, hb)) return true;
    if (quad_edge_hit(T, h, 1.f, -1.f, 0.f, 2.f, ha, hb)) return true;
    if (quad_edge_hit(T, h, 1.f, 1.f, -2.f, -2.f, ha, hb)) return true;
  } else {
    if (quad_edge_hit(T, h, -1.f, -1.f, 2.f, 2.f, ha, hb)) return true;
    if (quad_edge_hit(T, h, 1.f, 1.f, -2.f, 0.f, ha, hb)) return true;
    if (quad_edge_hit(T, h, -1.f, 1.f, 0.f, -2.f, ha, hb)) return true;
  }
  if (body_edge_hit(T.ax0, T.ay0, T.az0, T.ax1, T.ay1, T.az1, h, q, ha, hb))
    return true;
  if (body_edge_hit(T.ax1, T.ay1, T.az1, T.ax2, T.ay2, T.az2, h, q, ha, hb))
    return true;
  return body_edge_hit(T.ax2, T.ay2, T.az2, T.ax0, T.ay0, T.az0, h, q, ha,
                       hb);
}

__global__ void __launch_bounds__(kThreads) measure_kernel(
    const float* __restrict__ verts, const int* __restrict__ faces,
    const int* __restrict__ plane_faces, const int* __restrict__ anchor_face,
    const float* __restrict__ anchor_bary, const float* __restrict__ hull_cos,
    const float* __restrict__ hull_sin, float2* __restrict__ scratch,
    float* __restrict__ out, float* __restrict__ plane_h, int V, int F,
    Planes planes, int cap, int half_k, float angle_step, float density) {
  __shared__ float red[32];
  __shared__ int counter;
  __shared__ float2 pts[kChunk];
  const int p = blockIdx.x;  // 0..2: chest, waist, hips; 3: mass + height
  const int b = blockIdx.y;
  const float* vb = verts + (size_t)b * V * 3;

  auto anchor_y = [&](int a) {
    const int* f = faces + 3 * anchor_face[a];
    const float* bc = anchor_bary + 3 * a;
    return vb[3 * f[0] + 1] * bc[0] + vb[3 * f[1] + 1] * bc[1] +
           vb[3 * f[2] + 1] * bc[2];
  };

  if (p == 3) {
    float acc = 0.f;
    for (int i = threadIdx.x; i < F; i += blockDim.x) {
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
    const float total = block_sum(acc, red);
    if (threadIdx.x == 0) {
      out[b * 5 + 0] = fabsf(total) / 6.0f * density;
      out[b * 5 + 1] = fabsf(anchor_y(0) - anchor_y(1));
    }
    return;
  }

  const float h = anchor_y(2 + p);
  if (threadIdx.x == 0) {
    plane_h[b * 3 + p] = h;
    counter = 0;
  }
  __syncthreads();

  const int n = planes.n[p];
  const int* ids = plane_faces ? plane_faces + planes.off[p] : nullptr;
  float2* sp = scratch + ((size_t)b * 3 + p) * cap;
  float cnt = 0.f, sx = 0.f, sz = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int id = ids ? ids[i] : i;
    if (id == 0) continue;  // the reference drops face id 0
    const int* f = faces + 3 * id;
    const float* v0 = vb + 3 * f[0];
    const float* v1 = vb + 3 * f[1];
    const float* v2 = vb + 3 * f[2];
    Tri T;
    T.ax0 = v0[0]; T.ay0 = v0[1]; T.az0 = v0[2];
    T.ax1 = v1[0]; T.ay1 = v1[1]; T.az1 = v1[2];
    T.ax2 = v2[0]; T.ay2 = v2[1]; T.az2 = v2[2];
    T.e1x = T.ax1 - T.ax0; T.e1y = T.ay1 - T.ay0; T.e1z = T.az1 - T.az0;
    T.e2x = T.ax2 - T.ax0; T.e2y = T.ay2 - T.ay0; T.e2z = T.az2 - T.az0;
    for (int q = 0; q < 2; ++q) {
      float ha, hb;
      if (first_hit(T, h, q, ha, hb)) {
        sp[atomicAdd(&counter, 1)] = make_float2(ha, hb);
        cnt += 1.f;
        sx += ha;
        sz += hb;
      }
    }
  }
  const float total_n = block_sum(cnt, red);
  const float total_x = block_sum(sx, red);
  const float total_z = block_sum(sz, red);
  const int total = counter;  // block_sum synchronised after the atomics
  const float cx = total_x / fmaxf(total_n, 1.f);
  const float cz = total_z / fmaxf(total_n, 1.f);

  const int d0 = threadIdx.x, d1 = threadIdx.x + blockDim.x;
  const float c0 = d0 < half_k ? hull_cos[d0] : 0.f;
  const float s0 = d0 < half_k ? hull_sin[d0] : 0.f;
  const float c1 = d1 < half_k ? hull_cos[d1] : 0.f;
  const float s1 = d1 < half_k ? hull_sin[d1] : 0.f;
  // Starting at 0 clamps: h = max(max proj, 0), h(theta+pi) = max(-min, 0).
  float mx0 = 0.f, mn0 = 0.f, mx1 = 0.f, mn1 = 0.f;
  for (int start = 0; start < total; start += kChunk) {
    const int m = min(kChunk, total - start);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const float2 q = sp[start + i];
      pts[i] = make_float2(q.x - cx, q.y - cz);
    }
    __syncthreads();
    for (int i = 0; i < m; ++i) {
      const float2 q = pts[i];
      const float pr0 = q.x * c0 + q.y * s0;
      const float pr1 = q.x * c1 + q.y * s1;
      mx0 = fmaxf(mx0, pr0);
      mn0 = fminf(mn0, pr0);
      mx1 = fmaxf(mx1, pr1);
      mn1 = fminf(mn1, pr1);
    }
  }
  float hsum = 0.f;
  if (d0 < half_k) hsum += mx0 - mn0;
  if (d1 < half_k) hsum += mx1 - mn1;
  const float perimeter = block_sum(hsum, red) * angle_step;
  if (threadIdx.x == 0) {
    out[b * 5 + 2 + p] = total_n >= 2.f ? perimeter : 0.f;
  }
}

}  // namespace

// verts (B, V, 3) f32; faces (F, 3) i32; plane_faces the three planes'
// face-id lists back to back (i32), or NULL to walk all F faces (ids =
// positions); anchor_face (5,) i32 and anchor_bary (5, 3) f32 for head top,
// left heel, chest, waist, hips; hull_cos / hull_sin (half_k,) f32; scratch
// (B, 3, cap) float2 with cap >= 2 * max(n); out (B, 5) f32 = mass, height,
// chest, waist, hips; plane_h (B, 3) f32. Returns cudaGetLastError().
extern "C" int measure_forward(
    const void* verts, const void* faces, const void* plane_faces,
    const void* anchor_face, const void* anchor_bary, const void* hull_cos,
    const void* hull_sin, void* scratch, void* out, void* plane_h, int B,
    int V, int F, int off0, int off1, int off2, int n0, int n1, int n2,
    int cap, int half_k, float angle_step, float density, void* stream) {
  if (half_k > 2 * kThreads) return (int)cudaErrorInvalidValue;
  Planes planes;
  planes.off[0] = off0; planes.off[1] = off1; planes.off[2] = off2;
  planes.n[0] = n0; planes.n[1] = n1; planes.n[2] = n2;
  measure_kernel<<<dim3(4, B), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)verts, (const int*)faces, (const int*)plane_faces,
      (const int*)anchor_face, (const float*)anchor_bary,
      (const float*)hull_cos, (const float*)hull_sin, (float2*)scratch,
      (float*)out, (float*)plane_h, V, F, planes, cap, half_k, angle_step,
      density);
  return (int)cudaGetLastError();
}
