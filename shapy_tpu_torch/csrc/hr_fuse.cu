// K5-fuse: HRNet's multi-resolution fusion for one target branch, in one
// pass over NHWC activations in float32 or bfloat16:
//
//   y = relu(x + t_0 + t_1 + ...),  t read at (h >> s_t, w >> s_t)
//
// Replaces: shapy_tpu/models/backbones/hrnet.py:_fuse (line 141: the sum of
// every source branch's contribution and the ReLU) and
// shapy_tpu/models/backbones/layers.py:nearest_upsample (line 344): a
// coarser branch's 1x1-conv output u is read at the target pixel's nearest
// source pixel, so no upsampled tensor is made. The terms are the
// contributions in the order HighResolutionModule.forward adds them (the
// upsampled j = i+1 .. n-1, then the stride-2 chains j = 0 .. i-1), made by
// K5-conv beforehand.
//
// What bounds it on the H100: bytes. Per output element it reads x and up to
// three terms (the upsampled ones once per 4, 16 or 64 outputs, through L2)
// and writes y; a few adds each.
//
// Design: one thread per 16 bytes (8 bf16 or 4 f32 channels of one pixel),
// 16-byte loads and stores. The sum is rounded to the dtype after every add,
// as the plain version's eager adds round, so the two agree to the bit.
//
// The backward (hr_fuse_backward), the VJP that JAX autodiff takes of _fuse
// and nearest_upsample: g = dy (y > 0) is x's gradient and that of every
// term read at its own resolution (shift 0); a term read with shift s > 0
// gets the 2^s x 2^s box sum of g, the adjoint of the nearest upsample. One
// thread per 16 bytes of a fine pixel writes g (to dx and the shift-0
// terms), and one thread per 16 bytes of a coarse pixel gathers its box,
// rows then columns, in f32, and rounds once: no scatter, no atomics. Bound
// by bytes: dy and y are read once by the fine threads and once more by the
// coarse ones (through L2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTerms = 3;

struct Terms {
  const void* ptr[kMaxTerms];
  int shift[kMaxTerms];
  int n;
};

// The backward's outputs: each term's gradient and, for the terms with a
// shift, the first work item of its coarse threads.
struct TermGrads {
  void* ptr[kMaxTerms];
  int shift[kMaxTerms];
  long long start[kMaxTerms];
  int n;
};

__device__ __forceinline__ void unpack(const uint4& u, float* v, float) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* v,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ uint4 pack(const float* v, float) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack(const float* v, __nv_bfloat16) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
  return u;
}

__device__ __forceinline__ float rnd(float v, float) { return v; }
__device__ __forceinline__ float rnd(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) hr_fuse_kernel(
    const T* __restrict__ x, T* __restrict__ y, Terms terms, long long nvec,
    int H, int W, int C) {
  constexpr int kV = 16 / sizeof(T);  // elements per 16-byte vector
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < nvec; e += step) {
    const long long off = e * kV;
    const long long p = off / C;  // pixel (n, h, w)
    const int c = (int)(off - p * C);
    const int w = (int)(p % W);
    const long long q = p / W;
    const int h = (int)(q % H);
    const long long n = q / H;
    float v[kV], t[kV];
    unpack(*reinterpret_cast<const uint4*>(x + off), v, T());
#pragma unroll
    for (int j = 0; j < kMaxTerms; ++j) {
      if (j >= terms.n) break;
      const int sh = terms.shift[j];
      const int Hs = H >> sh, Ws = W >> sh;
      const long long src = ((n * Hs + (h >> sh)) * Ws + (w >> sh)) * C + c;
      unpack(*reinterpret_cast<const uint4*>(
                 reinterpret_cast<const T*>(terms.ptr[j]) + src),
             t, T());
#pragma unroll
      for (int i = 0; i < kV; ++i) v[i] = rnd(v[i] + t[i], T());
    }
#pragma unroll
    for (int i = 0; i < kV; ++i) v[i] = v[i] < 0.f ? 0.f : v[i];
    *reinterpret_cast<uint4*>(y + off) = pack(v, T());
  }
}

template <typename T>
__device__ __forceinline__ void masked(const T* dy, const T* y, long long off,
                                       float* g) {
  constexpr int kV = 16 / sizeof(T);
  float m[kV];
  unpack(*reinterpret_cast<const uint4*>(dy + off), g, T());
  unpack(*reinterpret_cast<const uint4*>(y + off), m, T());
#pragma unroll
  for (int i = 0; i < kV; ++i) g[i] = m[i] > 0.f ? g[i] : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) hr_fuse_backward_kernel(
    const T* __restrict__ dy, const T* __restrict__ y, T* __restrict__ dx,
    TermGrads grads, long long nfine, long long total, int H, int W, int C) {
  constexpr int kV = 16 / sizeof(T);
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += step) {
    float v[kV];
    if (e < nfine) {  // g at a fine pixel: dx and the shift-0 terms
      const long long off = e * kV;
      masked(dy, y, off, v);
      const uint4 u = pack(v, T());
      *reinterpret_cast<uint4*>(dx + off) = u;
#pragma unroll
      for (int j = 0; j < kMaxTerms; ++j) {
        if (j < grads.n && grads.shift[j] == 0) {
          *reinterpret_cast<uint4*>(reinterpret_cast<T*>(grads.ptr[j]) +
                                    off) = u;
        }
      }
      continue;
    }
    int j = 0;  // the last shifted term whose coarse items start at <= e
#pragma unroll
    for (int t = 0; t < kMaxTerms; ++t) {
      if (t < grads.n && grads.shift[t] > 0 && e >= grads.start[t]) j = t;
    }
    const int sh = grads.shift[j], f = 1 << sh;
    const int Hs = H >> sh, Ws = W >> sh;
    const long long off = (e - grads.start[j]) * kV;
    const long long pc = off / C;  // coarse pixel (n, hc, wc)
    const int c = (int)(off - pc * C);
    const int wc = (int)(pc % Ws);
    const long long q = pc / Ws;
    const int hc = (int)(q % Hs);
    const long long n = q / Hs;
#pragma unroll
    for (int i = 0; i < kV; ++i) v[i] = 0.f;
    for (int dh = 0; dh < f; ++dh) {
      for (int dw = 0; dw < f; ++dw) {
        const long long fo =
            ((n * H + ((long long)hc << sh) + dh) * W + ((wc << sh) + dw)) *
                C + c;
        float g[kV];
        masked(dy, y, fo, g);
#pragma unroll
        for (int i = 0; i < kV; ++i) v[i] += g[i];
      }
    }
    *reinterpret_cast<uint4*>(reinterpret_cast<T*>(grads.ptr[j]) + off) =
        pack(v, T());
  }
}

}  // namespace

// x and y (N, H, W, C); term j (N, H >> shift_j, W >> shift_j, C), NHWC, all
// of dtype 0 = float32 or 1 = bfloat16, 16-byte aligned, C a multiple of 8;
// n_terms <= 3 (NULL pointers beyond). Returns cudaGetLastError().
extern "C" int hr_fuse_forward(const void* x, const void* t0, const void* t1,
                               const void* t2, void* y, int s0, int s1,
                               int s2, int n_terms, int N, int H, int W,
                               int C, int dtype, void* stream) {
  if (n_terms < 0 || n_terms > kMaxTerms || C % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Terms terms;
  terms.ptr[0] = t0; terms.ptr[1] = t1; terms.ptr[2] = t2;
  terms.shift[0] = s0; terms.shift[1] = s1; terms.shift[2] = s2;
  terms.n = n_terms;
  const long long elems = (long long)N * H * W * C;
  const long long nvec = elems / (dtype == 0 ? 4 : 8);
  if (nvec == 0) return (int)cudaSuccess;
  const long long want = (nvec + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 65535 * 8 ? want : 65535 * 8);
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    hr_fuse_kernel<float><<<blocks, kThreads, 0, s>>>(
        (const float*)x, (float*)y, terms, nvec, H, W, C);
  } else {
    hr_fuse_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)y, terms, nvec, H, W, C);
  }
  return (int)cudaGetLastError();
}

// The VJP of hr_fuse_forward: dy and y (the forward's output) (N, H, W, C),
// dx like them, dt_j (N, H >> s_j, W >> s_j, C): dx = dy (y > 0), dt_j the
// 2^s_j box sums of dx (dx itself for s_j = 0), summed in f32 and rounded
// once. Same dtypes, alignment and limits as the forward. Returns
// cudaGetLastError().
extern "C" int hr_fuse_backward(const void* dy, const void* y, void* dx,
                                void* dt0, void* dt1, void* dt2, int s0,
                                int s1, int s2, int n_terms, int N, int H,
                                int W, int C, int dtype, void* stream) {
  if (n_terms < 0 || n_terms > kMaxTerms || C % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  TermGrads g;
  g.ptr[0] = dt0; g.ptr[1] = dt1; g.ptr[2] = dt2;
  g.shift[0] = s0; g.shift[1] = s1; g.shift[2] = s2;
  g.n = n_terms;
  const int kv = dtype == 0 ? 4 : 8;
  const long long nfine = (long long)N * H * W * C / kv;
  long long total = nfine;
  for (int j = 0; j < kMaxTerms; ++j) {
    g.start[j] = total;
    if (j < n_terms && g.shift[j] > 0) {
      if (g.shift[j] > 3 || (H >> g.shift[j] << g.shift[j]) != H ||
          (W >> g.shift[j] << g.shift[j]) != W) {
        return (int)cudaErrorInvalidValue;
      }
      total += (long long)N * (H >> g.shift[j]) * (W >> g.shift[j]) * C / kv;
    }
  }
  if (total == 0) return (int)cudaSuccess;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 65535 * 8 ? want : 65535 * 8);
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    hr_fuse_backward_kernel<float><<<blocks, kThreads, 0, s>>>(
        (const float*)dy, (const float*)y, (float*)dx, g, nfine, total, H, W,
        C);
  } else {
    hr_fuse_backward_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        (const __nv_bfloat16*)dy, (const __nv_bfloat16*)y,
        (__nv_bfloat16*)dx, g, nfine, total, H, W, C);
  }
  return (int)cudaGetLastError();
}
