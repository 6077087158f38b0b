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
