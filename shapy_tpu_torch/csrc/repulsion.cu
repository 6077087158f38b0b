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
// What bounds it on the H100: operations. A pair reads two gathered
// triangles (72 bytes) and does ~400 FLOPs (two cones, six fields); at a
// few thousand pairs per body the whole loss is microseconds of work, so
// the launches and the partial sums' pass cost more than the arithmetic.
//
// Design. Forward: one thread per pair computes its penalty (`pair_loss`,
// the JAX order of operations, no FMA contraction); each block of 256
// pairs sums its pairs in a fixed tree order in f64 and a second launch
// adds each body's block sums in block order. No atomics, so two calls
// give the same bits. Backward: `pair_loss` is a template on its scalar
// type; instantiated on a dual number (value and 3 tangents) it gives the
// pair's 18 partial derivatives in 6 passes of forward-mode
// differentiation, with the same branches (mask, bands, clamps) as the
// value. Pass 1 writes each pair's (2, 3, 3) gradient times the loss's
// cotangent; pass 2 gives each face one thread that adds its entries in
// pair order, read through a face -> entry list that the wrapper builds
// with a stable sort of the pair ids. A padded pair has no entry. An id
// at or above F stops both launches with a device-side assert, as
// indexing a CUDA tensor out of range does, so the wrapper never reads
// the ids back to the host.
#include <cassert>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;  // pairs per block
constexpr int kTangents = 3;

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
// the cone, else 0.
template <typename T>
__device__ T field(const Vec<T>& point, const Cone<T>& c, const Params& p) {
  const Vec<T> rel = point - c.center;
  const T d = dot(rel, c.axis);
  const T numerator = norm(rel - scale(d, c.axis));
  const T denominator = (-c.radius) / p.sigma * d + c.radius;
  const T axis_dist = numerator / (denominator + p.eps);
  if (!(val(axis_dist) < 1.f)) return zero_like(d);
  T f = (1.f - axis_dist) * intensity(d, p);
  f = f * f;
  return f * f;
}

// The penalty of one pair: sum over the three vertices of phi_r^2 +
// phi_i^2 (each a field raised to the 4th power).
template <typename T>
__device__ T pair_loss(const Vec<T> recv[3], const Vec<T> intr[3],
                       const Params& p) {
  const Cone<T> cr = make_cone(recv), ci = make_cone(intr);
  T sum = zero_like(recv[0].x);
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    const T a = field(intr[v], cr, p);
    const T b = field(recv[v], ci, p);
    const T term = a * a + b * b;
    sum = v == 0 ? term : sum + term;
  }
  return sum;
}

__device__ __forceinline__ void load_tri(const float* t, Vec<float> out[3]) {
#pragma unroll
  for (int v = 0; v < 3; ++v) out[v] = {t[3 * v], t[3 * v + 1], t[3 * v + 2]};
}

__global__ void __launch_bounds__(kTile)
    repulsion_forward_kernel(const float* __restrict__ tris,
                             const int* __restrict__ pairs, int F, int C,
                             Params p, double* __restrict__ partials) {
  __shared__ double red[kTile];
  const int b = blockIdx.y;
  const int c = blockIdx.x * kTile + threadIdx.x;
  double x = 0.0;
  if (c < C) {
    const int r = pairs[((size_t)b * C + c) * 2];
    const int i = pairs[((size_t)b * C + c) * 2 + 1];
    if (r >= 0 && i >= 0) {
      assert(r < F && i < F && "repulsion: collision id out of range");
      Vec<float> recv[3], intr[3];
      load_tri(tris + ((size_t)b * F + r) * 9, recv);
      load_tri(tris + ((size_t)b * F + i) * 9, intr);
      x = pair_loss(recv, intr, p);
    }
  }
  red[threadIdx.x] = x;
  __syncthreads();
  for (int s = kTile / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[(size_t)b * gridDim.x + blockIdx.x] = red[0];
}

__global__ void block_sum_kernel(const double* __restrict__ partials, int B,
                                 int blocks, float* __restrict__ loss) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  double s = 0.0;
  for (int k = 0; k < blocks; ++k) s += partials[(size_t)b * blocks + k];
  loss[b] = (float)s;
}

// Pass 1: entries (B, C, 2, 3, 3), d pair_loss / d (receiver, intruder)
// times grad_loss[b]; left unwritten for padded pairs (never read).
__global__ void __launch_bounds__(kTile)
    repulsion_pair_grad_kernel(const float* __restrict__ tris,
                               const int* __restrict__ pairs,
                               const float* __restrict__ grad_loss, int F,
                               int C, Params p,
                               float* __restrict__ entries) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * kTile + threadIdx.x;
  if (c >= C) return;
  const int r = pairs[((size_t)b * C + c) * 2];
  const int i = pairs[((size_t)b * C + c) * 2 + 1];
  if (r < 0 || i < 0) return;
  assert(r < F && i < F && "repulsion: collision id out of range");
  float in[18];
  const float* tr = tris + ((size_t)b * F + r) * 9;
  const float* ti = tris + ((size_t)b * F + i) * 9;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    in[k] = tr[k];
    in[9 + k] = ti[k];
  }
  const float g = grad_loss[b];
  float* out = entries + ((size_t)b * C + c) * 18;
  for (int first = 0; first < 18; first += kTangents) {
    Dual x[18];
#pragma unroll
    for (int k = 0; k < 18; ++k) {
      x[k].v = in[k];
#pragma unroll
      for (int t = 0; t < kTangents; ++t)
        x[k].d[t] = k == first + t ? 1.f : 0.f;
    }
    Vec<Dual> recv[3], intr[3];
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      recv[v] = {x[3 * v], x[3 * v + 1], x[3 * v + 2]};
      intr[v] = {x[9 + 3 * v], x[9 + 3 * v + 1], x[9 + 3 * v + 2]};
    }
    const Dual l = pair_loss(recv, intr, p);
#pragma unroll
    for (int t = 0; t < kTangents; ++t) out[first + t] = g * l.d[t];
  }
}

// Pass 2: grad (B, F, 3, 3); face (b, f) adds entries order[starts[bf]
// .. starts[bf + 1]) in pair order (order holds entry ids (b * C + c) * 2
// + role, sorted stably by face).
__global__ void face_grad_kernel(const float* __restrict__ entries,
                                 const int* __restrict__ order,
                                 const int* __restrict__ starts, int BF,
                                 float* __restrict__ grad) {
  const int bf = blockIdx.x * blockDim.x + threadIdx.x;
  if (bf >= BF) return;
  float acc[9] = {};
  for (int j = starts[bf]; j < starts[bf + 1]; ++j) {
    const int e = order[j];
    const float* src = entries + (size_t)(e >> 1) * 18 + (e & 1) * 9;
#pragma unroll
    for (int k = 0; k < 9; ++k) acc[k] += src[k];
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) grad[(size_t)bf * 9 + k] = acc[k];
}

}  // namespace

// tris (B, F, 3, 3) f32, pairs (B, C, 2) int32 (ids < F, or < 0 for a
// padded pair; an id >= F asserts), partials (B, ceil(C / 256)) f64
// scratch, loss (B,) f32 out. All contiguous on the device. Returns
// cudaGetLastError().
extern "C" int repulsion_forward(const void* tris, const void* pairs,
                                 void* partials, void* loss, int B, int F,
                                 int C, float sigma, float c1, float c2,
                                 float c3, float linear_max, float eps,
                                 int penalize_outside, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Params p{sigma, c1, c2, c3, linear_max, eps, penalize_outside};
  const int blocks = (C + kTile - 1) / kTile;
  repulsion_forward_kernel<<<dim3(blocks, B), kTile, 0, s>>>(
      (const float*)tris, (const int*)pairs, F, C, p, (double*)partials);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  block_sum_kernel<<<(B + 127) / 128, 128, 0, s>>>((const double*)partials,
                                                   B, blocks, (float*)loss);
  return (int)cudaGetLastError();
}

// grad_loss (B,) f32; entries (B, C, 2, 3, 3) f32 scratch; order (B * C *
// 2,) int32 and starts (B * F + 1,) int32 the face -> entry list; grad
// (B, F, 3, 3) f32 out. Returns cudaGetLastError().
extern "C" int repulsion_backward(const void* tris, const void* pairs,
                                  const void* grad_loss, void* entries,
                                  const void* order, const void* starts,
                                  void* grad, int B, int F, int C,
                                  float sigma, float c1, float c2, float c3,
                                  float linear_max, float eps,
                                  int penalize_outside, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Params p{sigma, c1, c2, c3, linear_max, eps, penalize_outside};
  repulsion_pair_grad_kernel<<<dim3((C + kTile - 1) / kTile, B), kTile, 0,
                               s>>>((const float*)tris, (const int*)pairs,
                                    (const float*)grad_loss, F, C, p,
                                    (float*)entries);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int BF = B * F;
  face_grad_kernel<<<(BF + 255) / 256, 256, 0, s>>>(
      (const float*)entries, (const int*)order, (const int*)starts, BF,
      (float*)grad);
  return (int)cudaGetLastError();
}
