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
// gets the 2^s x 2^s box sum of g, the adjoint of the nearest upsample.
// Bound by bytes: dy and y read once, dx and every term's gradient
// written once (the shift-0 ones are copies of dx).
//
// Design: the work is split in tiles of the target aligned to the box of
// its largest shift S (hr_fuse_backward_plan in models/backbones/hrnet.py,
// from the shape alone). A block owns 2^S rows x a run of columns x a
// slice of channel vectors; a thread owns a 2 x 2 micro box (1 x 1 for S =
// 0) of one 16-byte channel vector. It reads each vector of dy and y once,
// forms g, writes it to dx and the shift-0 terms from the same registers,
// and sums its micro box in f32. The boxes are summed in a fixed tree:
// 2x2 = (g00 + g01) + (g10 + g11), then 4x4 from four 2x2 sums and 8x8
// from four 4x4 sums in the same order, through shared memory; each
// term's gradient is rounded to the dtype once, when it is stored. No
// atomics, no second read, and the indices come from the tile.
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

// The backward's outputs: each term's gradient and its shift.
struct TermGrads {
  void* ptr[kMaxTerms];
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

// Stores v, rounded to T, to every term of shift `level` at element offset
// `off` of its tensor.
template <typename T>
__device__ __forceinline__ void store_level(const TermGrads& grads, int level,
                                            long long off, const float* v) {
  const uint4 u = pack(v, T());
#pragma unroll
  for (int j = 0; j < kMaxTerms; ++j) {
    if (j < grads.n && grads.shift[j] == level) {
      *reinterpret_cast<uint4*>(reinterpret_cast<T*>(grads.ptr[j]) + off) = u;
    }
  }
}

// The tile of a block (hr_fuse_backward_plan): `cs` channel vectors of
// 16 bytes, `tw` micro-box columns, 2^S / m micro-box rows; thread t takes
// channel vector t % cs of micro box (t / cs / tw, t / cs % tw).
// blockIdx.x = (image, row of tiles) * col_tiles + column of tiles,
// blockIdx.y = the channel slice.
struct Tile {
  int cs, tw, col_tiles;
};

template <typename T, int kS>
__global__ void __launch_bounds__(kThreads) hr_fuse_backward_kernel(
    const T* __restrict__ dy, const T* __restrict__ y, T* __restrict__ dx,
    TermGrads grads, Tile tile, int H, int W, int C) {
  constexpr int kV = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int kM = kS > 0 ? 2 : 1;  // a micro box's side in pixels
  // the micro boxes' sums (2x2, then 4x4 in place), one row a thread
  __shared__ float4 box[kS >= 2 ? kThreads * kV / 4 : 1];
  const int t = threadIdx.x;
  const int cv = t % tile.cs;
  const int col = t / tile.cs % tile.tw;
  const int row = t / tile.cs / tile.tw;
  const int rt = blockIdx.x / tile.col_tiles;  // image * (H >> kS) + tile row
  const int ct = blockIdx.x - rt * tile.col_tiles;
  const int Hs = H >> kS;
  const int n = rt / Hs;
  const int h0 = ((rt - n * Hs) << kS) + row * kM;
  const int w0 = (ct * tile.tw + col) * kM;
  const int c = (blockIdx.y * tile.cs + cv) * kV;

  // g at the micro box's pixels: dx and the shift-0 terms.
  float g[kM][kM][kV];
#pragma unroll
  for (int dh = 0; dh < kM; ++dh) {
#pragma unroll
    for (int dw = 0; dw < kM; ++dw) {
      const long long off =
          (((long long)n * H + h0 + dh) * W + w0 + dw) * C + c;
      masked(dy, y, off, g[dh][dw]);
      const uint4 u = pack(g[dh][dw], T());
      *reinterpret_cast<uint4*>(dx + off) = u;
#pragma unroll
      for (int j = 0; j < kMaxTerms; ++j) {
        if (j < grads.n && grads.shift[j] == 0) {
          *reinterpret_cast<uint4*>(reinterpret_cast<T*>(grads.ptr[j]) +
                                    off) = u;
        }
      }
    }
  }
  if (kS == 0) return;
  // 2x2: (g00 + g01) + (g10 + g11).
  constexpr int kL = kM - 1;  // 1 here
  float s[kV];
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    s[i] = (g[0][0][i] + g[0][kL][i]) + (g[kL][0][i] + g[kL][kL][i]);
  }
  const int H1 = H >> 1, W1 = W >> 1;
  store_level<T>(grads, 1, (((long long)n * H1 + (h0 >> 1)) * W1 + (w0 >> 1)) *
                               C + c, s);
  if (kS == 1) return;
  // 4x4 from the four 2x2 sums of micro boxes (row, col) .. (row + 1, col
  // + 1), in the same order; 8x8 from four 4x4 sums two micro boxes apart.
  float4* mine = box + t * (kV / 4);
#pragma unroll
  for (int i = 0; i < kV / 4; ++i) {
    mine[i] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
  }
  __syncthreads();
#pragma unroll
  for (int level = 2; level <= kS; ++level) {
    const int step = 1 << (level - 2);  // micro boxes between the quarters
    if (level > 2) __syncthreads();  // the 4x4 sums are in place
    if ((row & (2 * step - 1)) == 0 && (col & (2 * step - 1)) == 0) {
      const float4* q00 = mine;
      const float4* q01 = mine + step * tile.cs * (kV / 4);
      const float4* q10 = mine + step * tile.tw * tile.cs * (kV / 4);
      const float4* q11 = q10 + step * tile.cs * (kV / 4);
      float v[kV];
#pragma unroll
      for (int i = 0; i < kV / 4; ++i) {
        const float4 a = q00[i], b = q01[i], d = q10[i], e = q11[i];
        v[4 * i] = (a.x + b.x) + (d.x + e.x);
        v[4 * i + 1] = (a.y + b.y) + (d.y + e.y);
        v[4 * i + 2] = (a.z + b.z) + (d.z + e.z);
        v[4 * i + 3] = (a.w + b.w) + (d.w + e.w);
      }
      const int Hl = H >> level, Wl = W >> level;
      store_level<T>(grads, level,
                     (((long long)n * Hl + (h0 >> level)) * Wl +
                      (w0 >> level)) * C + c, v);
      // Only this thread reads its own slot at this level: the sum goes
      // in place for the next.
#pragma unroll
      for (int i = 0; i < kV / 4; ++i) {
        mine[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                              v[4 * i + 3]);
      }
    }
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
// 2^s_j box sums of dx (dx itself for s_j = 0), summed in f32 in the fixed
// tree above and rounded once. Same dtypes, alignment and limits as the
// forward. The tile is hr_fuse_backward_plan's: cs channel vectors (a
// divisor of C / (16 / element size)), tw micro-box columns (a multiple of
// 2^S / m whose m tw pixels divide W), at most 256 threads. Returns
// cudaGetLastError().
extern "C" int hr_fuse_backward(const void* dy, const void* y, void* dx,
                                void* dt0, void* dt1, void* dt2, int s0,
                                int s1, int s2, int n_terms, int N, int H,
                                int W, int C, int dtype, int cs, int tw,
                                void* stream) {
  if (n_terms < 0 || n_terms > kMaxTerms || C % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  TermGrads g;
  g.ptr[0] = dt0; g.ptr[1] = dt1; g.ptr[2] = dt2;
  g.shift[0] = s0; g.shift[1] = s1; g.shift[2] = s2;
  g.n = n_terms;
  int S = 0;
  for (int j = 0; j < n_terms; ++j) {
    if (g.shift[j] < 0 || g.shift[j] > 3) return (int)cudaErrorInvalidValue;
    S = g.shift[j] > S ? g.shift[j] : S;
  }
  const int m = S > 0 ? 2 : 1, rows = (1 << S) / m;
  const int cv = C / (dtype == 0 ? 4 : 8);
  if ((H >> S << S) != H || (W >> S << S) != W || cs <= 0 || cv % cs != 0 ||
      tw <= 0 || tw % rows != 0 || (W / m) % tw != 0 ||
      rows * tw * cs > kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)N * H * W == 0) return (int)cudaSuccess;
  Tile tile;
  tile.cs = cs;
  tile.tw = tw;
  tile.col_tiles = W / m / tw;
  const long long blocks = (long long)N * (H >> S) * tile.col_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, cv / cs);
  const int threads = rows * tw * cs;
  const cudaStream_t st = (cudaStream_t)stream;
#define HR_FUSE_BWD(T, kS)                                                  \
  hr_fuse_backward_kernel<T, kS><<<grid, threads, 0, st>>>(                 \
      (const T*)dy, (const T*)y, (T*)dx, g, tile, H, W, C)
#define HR_FUSE_BWD_S(T)    \
  switch (S) {              \
    case 0: HR_FUSE_BWD(T, 0); break; \
    case 1: HR_FUSE_BWD(T, 1); break; \
    case 2: HR_FUSE_BWD(T, 2); break; \
    default: HR_FUSE_BWD(T, 3); break; \
  }
  if (dtype == 0) {
    HR_FUSE_BWD_S(float)
  } else {
    HR_FUSE_BWD_S(__nv_bfloat16)
  }
#undef HR_FUSE_BWD_S
#undef HR_FUSE_BWD
  return (int)cudaGetLastError();
}
