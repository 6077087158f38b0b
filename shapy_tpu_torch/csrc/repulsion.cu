// K7 cone-field repulsion loss, forward and backward.
//
// Replaces: shapy_tpu/ops/repulsion.py `repulsion_loss` (:103) with
// `circumcircle` (:21), `repulsion_intensity` (:43) and
// `conical_distance_field` (:64). The JAX package gathers each (receiver,
// intruder) pair's triangles, builds both cones (unit normal axis,
// circumradius, circumcentre) and sums the cone fields both ways, with
// the reference's quirks: the field is ((1 - axis_dist) * intensity)^4
// and is squared once more per pair, epsilon is added to the cone radius
// unconditionally, and a padded pair (an id < 0) adds 0. Its gradient is
// JAX autodiff through those ops.
//
// What bounds it on the H100: launches and latency. A pair reads two
// gathered triangles (72 bytes) and does ~400 FLOPs (two cones, six
// fields), its gradient ~3x that; at a few thousand pairs per body the
// arithmetic is microseconds, and the backward must write the gradient of
// every face (36 bytes each), most of them zeros.
//
// Design. Forward, one launch (`repulsion_forward_kernel`): two threads a
// pair, a cone each, compute its penalty (`pair_loss`'s operations, the
// JAX order, no FMA contraction) and a live byte (some point passed its
// cone's mask); each block of kTile pairs sums its pairs in a fixed tree
// order in f64, and the body's last block (a ticket a body) adds the block
// sums in block order. Backward, two launches: `pair_loss` is a template
// on its scalar type; instantiated on a dual number (a value and kTangents
// tangents) it gives kTangents of a pair's 18 partial derivatives, with
// the same branches (mask, bands, clamps) as the value.
// `repulsion_pair_grad_kernel` runs one such pass a thread, kPasses
// threads a live pair, writes the pair's (2, 3, 3) entries times the
// loss's cotangent and pushes its two entries onto their faces' lists
// (`atomicExch` on a head a face); `repulsion_face_grad_kernel` gives each
// face a thread that adds its entries in ascending entry id, the order of
// the parent's stable sort, and writes every face's gradient. No float
// atomics, no library sort, no memset: two calls give the same bits, and
// the heads and tickets, kept by the wrapper between calls, are left as
// they were found. A padded pair has no entry. An id at or above F stops
// the launches with a device-side assert, as indexing a CUDA tensor out of
// range does, so the wrapper never reads the ids back to the host.
#include <cassert>
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;  // pairs per forward block
constexpr int kTangents = 2;  // tangents a dual pass
constexpr int kPasses = 18 / kTangents;  // tangent passes a pair
constexpr int kPairThreadsMax = 256;  // the pair pass's largest block
constexpr int kFaceBlock = 256;  // faces per block of the face pass
constexpr int kList = 4;  // entry ids a face sorts in registers a walk

struct Params {
  float sigma, c1, c2, c3, linear_max, eps;
  int penalize_outside;
};

// A value and kTangents directional derivatives.
struct Dual {
  float v, d[kTangents];
};

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(const Dual& x) { return x.v; }

__device__ __forceinline__ Dual operator+(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < kTangents; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}
__device__ __forceinline__ Dual operator-(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < kTangents; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}
__device__ __forceinline__ Dual operator-(const Dual& a) {
  Dual r;
  r.v = -a.v;
#pragma unroll
  for (int k = 0; k < kTangents; ++k) r.d[k] = -a.d[k];
  return r;
}
__device__ __forceinline__ Dual operator*(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < kTangents; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}
__device__ __forceinline__ Dual operator/(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v / b.v;
#pragma unroll
  for (int k = 0; k < kTangents; ++k)
    r.d[k] = (a.d[k] - r.v * b.d[k]) / b.v;
  return r;
}
// Constants on either side.
__device__ __forceinline__ Dual operator+(const Dual& a, float c) {
  Dual r = a;
  r.v = a.v + c;
  return r;
}
__device__ __forceinline__ Dual operator-(const Dual& a, float c) {
  Dual r = a;
  r.v = a.v - c;
  return r;
}
__device__ __forceinline__ Dual operator-(float c, const Dual& a) {
  Dual r = -a;
  r.v = c - a.v;
  return r;
}
__device__ __forceinline__ Dual operator*(float c, const Dual& a) {
  Dual r;
  r.v = c * a.v;
#pragma unroll
  for (int k = 0; k < kTangents; ++k) r.d[k] = c * a.d[k];
  return r;
}
__device__ __forceinline__ Dual operator/(const Dual& a, float c) {
  Dual r;
  r.v = a.v / c;
#pragma unroll
  for (int k = 0; k < kTangents; ++k) r.d[k] = a.d[k] / c;
  return r;
}
__device__ __forceinline__ Dual dsqrt(const Dual& a) {
  Dual r;
  r.v = sqrtf(a.v);
#pragma unroll
  for (int k = 0; k < kTangents; ++k) r.d[k] = a.d[k] / (2.f * r.v);
  return r;
}
__device__ __forceinline__ float dsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ Dual zero_like(const Dual&) { return Dual{}; }
__device__ __forceinline__ float zero_like(float) { return 0.f; }
// max(x, c) as torch.clamp(min=c): the gradient passes where x >= c.
template <typename T>
__device__ __forceinline__ T clamp_min(const T& x, float c) {
  if (val(x) >= c) return x;
  T r = zero_like(x);
  r = r + c;
  return r;
}

template <typename T>
struct Vec {
  T x, y, z;
};
template <typename T>
__device__ __forceinline__ Vec<T> operator-(const Vec<T>& a,
                                            const Vec<T>& b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
template <typename T>
__device__ __forceinline__ Vec<T> operator+(const Vec<T>& a,
                                            const Vec<T>& b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
template <typename T>
__device__ __forceinline__ Vec<T> scale(const T& s, const Vec<T>& a) {
  return {s * a.x, s * a.y, s * a.z};
}
template <typename T>
__device__ __forceinline__ Vec<T> divide(const Vec<T>& a, const T& s) {
  return {a.x / s, a.y / s, a.z / s};
}
template <typename T>
__device__ __forceinline__ T dot(const Vec<T>& a, const Vec<T>& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
template <typename T>
__device__ __forceinline__ Vec<T> cross(const Vec<T>& a, const Vec<T>& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
template <typename T>
__device__ __forceinline__ T norm(const Vec<T>& a) {
  return dsqrt(dot(a, a));
}

template <typename T>
struct Cone {
  Vec<T> axis, center;
  T radius;
};

// `_cone` and `circumcircle` of the triangle t.
template <typename T>
__device__ Cone<T> make_cone(const Vec<T> t[3]) {
  Cone<T> c;
  const Vec<T> normal = cross(t[1] - t[0], t[2] - t[0]);
  c.axis = divide(normal, clamp_min(norm(normal), 1e-12f));
  const Vec<T> alpha = t[0] - t[2], beta = t[1] - t[2];
  const Vec<T> cr = cross(alpha, beta);
  c.radius = norm(alpha - beta) / clamp_min(2.f * norm(cr), 1e-12f) *
             norm(alpha) * norm(beta);
  const Vec<T> u = scale(dot(alpha, alpha), beta) -
                   scale(dot(beta, beta), alpha);
  c.center =
      divide(cross(u, cr), clamp_min(2.f * dot(cr, cr), 1e-12f)) + t[2];
  return c;
}

template <typename T>
__device__ T intensity(const T& x, const Params& p) {
  const float xv = val(x);
  if (xv <= -p.sigma && xv > -p.linear_max) return (-x + 1.f) - p.sigma;
  const bool quad = p.penalize_outside ? (xv > -p.sigma && xv < p.sigma)
                                       : (xv > -p.sigma && xv < 0.f);
  if (quad) return (p.c1 * (x * x) - p.c2 * x) + p.c3;
  return zero_like(x);
}

// `conical_distance_field` of one point: ((1 - axis_dist) * I)^4 inside
// the cone, else 0. `inside` says whether the point passed the mask
// (axis_dist < 1); outside it the field and all its tangents are exact 0.
template <typename T>
__device__ T field(const Vec<T>& point, const Cone<T>& c, const Params& p,
                   bool& inside) {
  const Vec<T> rel = point - c.center;
  const T d = dot(rel, c.axis);
  const T numerator = norm(rel - scale(d, c.axis));
  const T denominator = (-c.radius) / p.sigma * d + c.radius;
  const T axis_dist = numerator / (denominator + p.eps);
  inside = val(axis_dist) < 1.f;
  if (!inside) return zero_like(d);
  T f = (1.f - axis_dist) * intensity(d, p);
  f = f * f;
  return f * f;
}

// The penalty of one pair: sum over the three vertices of phi_r^2 +
// phi_i^2 (each a field raised to the 4th power). A pair whose six points
// all fail their masks has the value 0 and, in the dual instantiation,
// tangents that are exact 0.
template <typename T>
__device__ T pair_loss(const Vec<T> recv[3], const Vec<T> intr[3],
                       const Params& p) {
  const Cone<T> cr = make_cone(recv), ci = make_cone(intr);
  T sum = zero_like(recv[0].x);
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    bool inside;
    const T a = field(intr[v], cr, p, inside);
    const T b = field(recv[v], ci, p, inside);
    const T term = a * a + b * b;
    sum = v == 0 ? term : sum + term;
  }
  return sum;
}

__device__ __forceinline__ void load_tri(const float* t, Vec<float> out[3]) {
#pragma unroll
  for (int v = 0; v < 3; ++v) out[v] = {t[3 * v], t[3 * v + 1], t[3 * v + 2]};
}

// Forward, one launch: a block a tile of kTile pairs of a body, two
// threads a pair (lanes 2t and 2t + 1 of a warp): side 0 builds the
// receiver's cone and the intruder's three fields in it, side 1 the
// intruder's cone and the receiver's fields, and side 0 adds them as
// `pair_loss` does (the same operations, so the same bits). Side 0 writes
// the pair's live byte (0 for a padded pair) and, where `per_pair` is
// given, its penalty; the block sums its pairs in a fixed tree order in
// f64 into partials[b][tile]. The body's last block to finish (a ticket a
// body, taken after a fence) adds the body's tile sums in tile order from
// 0.0, writes the f64 total to partials[b][tiles] and the loss, and resets
// the ticket to 0 for the next call.
__global__ void __launch_bounds__(2 * kTile)
    repulsion_forward_kernel(const float* __restrict__ tris,
                             const int* __restrict__ pairs, int F, int C,
                             Params p, double* partials,
                             unsigned* __restrict__ tickets,
                             float* __restrict__ loss,
                             unsigned char* __restrict__ live,
                             float* __restrict__ per_pair) {
  __shared__ double red[kTile];
  __shared__ bool last;
  const int b = blockIdx.y, tiles = gridDim.x;
  const int side = threadIdx.x & 1, t = threadIdx.x >> 1;
  const int c = blockIdx.x * kTile + t;
  const size_t pc = (size_t)b * C + c;
  bool valid = false, in = false;
  float f[3] = {0.f, 0.f, 0.f};
  if (c < C) {
    const int r = pairs[pc * 2], i = pairs[pc * 2 + 1];
    valid = r >= 0 && i >= 0;
    if (valid) {
      assert(r < F && i < F && "repulsion: collision id out of range");
      Vec<float> cone_tri[3], points[3];
      load_tri(tris + ((size_t)b * F + (side ? i : r)) * 9, cone_tri);
      load_tri(tris + ((size_t)b * F + (side ? r : i)) * 9, points);
      const Cone<float> cone = make_cone(cone_tri);
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        bool inside;
        f[v] = field(points[v], cone, p, inside);
        in |= inside;
      }
    }
  }
  float g[3];  // side 1's fields, at side 0
#pragma unroll
  for (int v = 0; v < 3; ++v) g[v] = __shfl_down_sync(0xffffffffu, f[v], 1);
  const bool in_other = __shfl_down_sync(0xffffffffu, (int)in, 1) != 0;
  if (side == 0) {
    double x = 0.0;
    if (c < C) {
      float sum = 0.f;
      if (valid) {
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          const float term = f[v] * f[v] + g[v] * g[v];
          sum = v == 0 ? term : sum + term;
        }
        x = sum;
      }
      live[pc] = in || in_other;
      if (per_pair != nullptr) per_pair[pc] = sum;
    }
    red[t] = x;
  }
  __syncthreads();
  for (int s = kTile / 2; s >= 32; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  // the tree's last five levels in warp 0: lane t adds lane t + s, as
  // red[t] += red[t + s] would
  double tile = threadIdx.x < 32 ? red[threadIdx.x] : 0.0;
  if (threadIdx.x < 32) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      tile += __shfl_down_sync(0xffffffffu, tile, s);
  }
  double* row = partials + (size_t)b * (tiles + 1);
  if (threadIdx.x == 0) {
    row[blockIdx.x] = tile;
    __threadfence();  // the tile sum is visible before the ticket
    last = atomicAdd(tickets + b, 1u) == (unsigned)(tiles - 1);
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    double s = 0.0;
    for (int k = 0; k < tiles; ++k) s += __ldcg(row + k);  // from L2
    row[tiles] = s;
    loss[b] = (float)s;
    tickets[b] = 0u;
  }
}

// Backward, launch 1: a thread per (pair, tangent pass), kPasses a pair.
// Pass k differentiates the pair's penalty along its inputs [k kTangents,
// (k + 1) kTangents) of 18 (receiver then intruder, vertex-major) and
// writes those entries of the pair's (2, 3, 3) gradient times
// grad_loss[b]: the parent kernel's dual arithmetic, one pass a thread (a
// tangent's arithmetic involves no other tangent, so the split keeps its
// bits). A pair that is not live (its six points outside their cones) has
// exact-zero entries, which add nothing to a sum that starts at +0, so it
// is skipped, unless grad_loss[b] is not finite (then its entries are
// NaN, as the plain version's are). The first and the last pass push the
// pair's receiver and intruder entry (entry id e = pair * 2 + role) onto
// their face's list: next[e] takes the list's old head.
__global__ void __launch_bounds__(kPairThreadsMax)
    repulsion_pair_grad_kernel(const float* __restrict__ tris,
                               const int* __restrict__ pairs,
                               const float* __restrict__ grad_loss,
                               int g_stride,
                               const unsigned char* __restrict__ live,
                               int B, int F, int C, Params p,
                               float* __restrict__ entries, int* heads,
                               int* __restrict__ next) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)B * C * kPasses) return;
  const int pass = (int)(k % kPasses);
  const size_t pc = (size_t)(k / kPasses);
  const int b = (int)(pc / C);
  const int r = pairs[pc * 2], i = pairs[pc * 2 + 1];
  if (r < 0 || i < 0) return;
  assert(r < F && i < F && "repulsion: collision id out of range");
  const float g = grad_loss[(size_t)b * g_stride];
  if (!live[pc] && isfinite(g)) return;
  const float* tr = tris + ((size_t)b * F + r) * 9;
  const float* ti = tris + ((size_t)b * F + i) * 9;
  const int first = pass * kTangents;
  Dual x[18];
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    x[j].v = tr[j];
    x[9 + j].v = ti[j];
  }
#pragma unroll
  for (int j = 0; j < 18; ++j) {
#pragma unroll
    for (int t = 0; t < kTangents; ++t) x[j].d[t] = j == first + t ? 1.f : 0.f;
  }
  Vec<Dual> recv[3], intr[3];
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    recv[v] = {x[3 * v], x[3 * v + 1], x[3 * v + 2]};
    intr[v] = {x[9 + 3 * v], x[9 + 3 * v + 1], x[9 + 3 * v + 2]};
  }
  const Dual l = pair_loss(recv, intr, p);
  float* out = entries + pc * 18 + first;
#pragma unroll
  for (int t = 0; t < kTangents; ++t) out[t] = g * l.d[t];
  // one thread pushes each entry: the first pass the receiver's, the last
  // the intruder's
  int* head = heads + (size_t)b * F;
  if (pass == 0) next[pc * 2] = atomicExch(head + r, (int)(pc * 2));
  if (pass == kPasses - 1)
    next[pc * 2 + 1] = atomicExch(head + i, (int)(pc * 2 + 1));
}

// Backward, launch 2: a thread a face of the B * F, kFaceBlock faces a
// block. The face walks its list (taking it: its head goes back to -1 for
// the next call) and adds its entries in ascending entry id, the parent's
// order: each walk keeps the kList smallest ids above the last one added,
// in registers, sorted by a min / max insertion; a list of n entries takes
// ceil(n / kList) walks. The block's gradient goes out through shared
// memory as 16-byte stores, zeros included, so no memset precedes it.
__global__ void __launch_bounds__(kFaceBlock)
    repulsion_face_grad_kernel(const float* __restrict__ entries,
                               const int* __restrict__ next, int* heads,
                               int BF, int n_entries,
                               float* __restrict__ grad) {
  __shared__ float out[kFaceBlock * 9];
  const int f0 = blockIdx.x * kFaceBlock;
  const int bf = f0 + threadIdx.x;
  float acc[9] = {};
  const int head = bf < BF ? heads[bf] : -1;
  if (head >= 0) {
    heads[bf] = -1;
    int last = -1;
    for (;;) {
      int ids[kList];
#pragma unroll
      for (int j = 0; j < kList; ++j) ids[j] = INT_MAX;
      int above = 0, steps = 0;
      for (int e = head; e >= 0; e = next[e]) {
        ++steps;
        assert(steps <= n_entries && "repulsion: a face list has no end");
        if (e <= last) continue;
        ++above;
        int v = e;
#pragma unroll
        for (int j = 0; j < kList; ++j) {
          const int lo = min(ids[j], v);
          v = max(ids[j], v);
          ids[j] = lo;
        }
      }
#pragma unroll
      for (int j = 0; j < kList; ++j) {
        if (ids[j] == INT_MAX) break;
        const float* src = entries + (size_t)(ids[j] >> 1) * 18 +
                           (ids[j] & 1) * 9;
#pragma unroll
        for (int q = 0; q < 9; ++q) acc[q] += src[q];
      }
      if (above <= kList) break;
      last = ids[kList - 1];
    }
  }
#pragma unroll
  for (int q = 0; q < 9; ++q) out[threadIdx.x * 9 + q] = acc[q];
  __syncthreads();
  const int n = min(kFaceBlock, BF - f0) * 9;
  float* dst = grad + (size_t)f0 * 9;
  if (n % 4 == 0 && ((size_t)dst & 15) == 0) {
    const float4* src = reinterpret_cast<const float4*>(out);
    for (int j = threadIdx.x; j < n / 4; j += kFaceBlock)
      reinterpret_cast<float4*>(dst)[j] = src[j];
  } else {
    for (int j = threadIdx.x; j < n; j += kFaceBlock) dst[j] = out[j];
  }
}

}  // namespace

// tris (B, F, 3, 3) f32, pairs (B, C, 2) int32 (ids < F, or < 0 for a
// padded pair; an id >= F asserts), partials (B, ceil(C / kTile) + 1) f64
// scratch (its last column the f64 totals), tickets (>= B,) uint32, 0 on
// entry and left 0, loss (B,) f32 out, live (B, C) uint8 out, per_pair
// (B, C) f32 out or null. C > 0. All contiguous on the device. Returns
// cudaGetLastError().
extern "C" int repulsion_forward(const void* tris, const void* pairs,
                                 void* partials, void* tickets, void* loss,
                                 void* live, void* per_pair, int B, int F,
                                 int C, float sigma, float c1, float c2,
                                 float c3, float linear_max, float eps,
                                 int penalize_outside, void* stream) {
  const Params p{sigma, c1, c2, c3, linear_max, eps, penalize_outside};
  repulsion_forward_kernel<<<dim3((C + kTile - 1) / kTile, B), 2 * kTile,
                             0, (cudaStream_t)stream>>>(
      (const float*)tris, (const int*)pairs, F, C, p, (double*)partials,
      (unsigned*)tickets, (float*)loss, (unsigned char*)live,
      (float*)per_pair);
  return (int)cudaGetLastError();
}

// grad_loss: B f32 at a stride of g_stride elements; live (B, C) uint8 from
// the forward; entries (B, C, 2, 3, 3) f32 and next (B * C * 2,) int32
// scratch; heads (>= B * F,) int32, -1 on entry and left -1; grad (B, F, 3,
// 3) f32 out. pair_threads: the pair pass's block (`repulsion_plan`).
// Returns cudaGetLastError().
extern "C" int repulsion_backward(const void* tris, const void* pairs,
                                  const void* grad_loss, const void* live,
                                  void* entries, void* next, void* heads,
                                  void* grad, int B, int F, int C,
                                  int g_stride, int pair_threads,
                                  float sigma, float c1, float c2, float c3,
                                  float linear_max, float eps,
                                  int penalize_outside, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Params p{sigma, c1, c2, c3, linear_max, eps, penalize_outside};
  const long long work = (long long)B * C * kPasses;
  if (work > 0) {
    repulsion_pair_grad_kernel<<<(int)((work + pair_threads - 1) /
                                       pair_threads),
                                 pair_threads, 0, s>>>(
        (const float*)tris, (const int*)pairs, (const float*)grad_loss,
        g_stride, (const unsigned char*)live, B, F, C, p, (float*)entries,
        (int*)heads, (int*)next);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int BF = B * F;
  repulsion_face_grad_kernel<<<(BF + kFaceBlock - 1) / kFaceBlock,
                               kFaceBlock, 0, s>>>(
      (const float*)entries, (const int*)next, (int*)heads, BF, B * C * 2,
      (float*)grad);
  return (int)cudaGetLastError();
}
