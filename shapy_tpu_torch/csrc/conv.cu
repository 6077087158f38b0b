// K5-conv: the backbone's convolution with a fused epilogue, on NHWC
// activations in bfloat16 (tensor cores) or float32 (CUDA cores).
//
//   y = relu?( conv(x, w, stride, pad = k / 2) + bias [+ residual] )
//
// Replaces: shapy_tpu/models/backbones/layers.py:conv2d (line 91, with
// fold_bn: the BN affine folded into w and bias), the chunks of
// shapy_tpu/models/backbones/hrnet.py:_merged_conv (line 101, one conv per
// chunk here), and the add and ReLU that follow a conv in basic_block,
// bottleneck_block and conv_bn_relu. On the TPU XLA ran these convs on the
// MXU (the 2-pixel packed Pallas conv, ops/conv_pack.py, was rejected and
// deleted); the port ran cuDNN and then one eager pass each for the bias,
// the residual and the ReLU.
//
// What bounds it on the H100: the HRNet-W48 forward at batch 32 does 48.2
// GFLOP per image over 331 convs of 33 shapes. The big 3x3 convs (48..384
// channels at 64^2..8^2) do 2 * 9 * Cin FLOP per output element against a
// few bytes, far above the 295 FLOP/byte ridge in bf16: tensor-core bound.
// The 1x1 convs with few channels and the stem (Cin = 3) are bound by bytes.
//
// Design: an implicit GEMM. Output pixels are the rows (M = N Ho Wo),
// output channels the columns (Cout), and K = (kh, kw, Cin) in the OHWI
// weight's order, so a weight row is a contiguous K-vector and an input
// pixel's channels are contiguous. The A tile is the im2col view of x, zero
// for the padding, the ragged M and K edges and Cout beyond the tile.
//   * bf16, Cin % 8 == 0 (every conv but the stem's first): conv_wgmma_kernel,
//     the Hopper kernel that K5-dgrad also runs (implicit_gemm below): TMA
//     boxes of x (a stride-1 window per tap, or every second pixel for
//     stride 2) and of the weight where it lies, a 3-4 stage mbarrier ring,
//     wgmma m64nNk16 from 128-byte-swizzled tiles, a persistent grid, and K
//     partitions from the shape alone summed in order by conv_reduce_kernel
//     (which then runs the epilogue). See "K5-conv (bf16)" below.
//   * bf16, the stem (Cin = 3): a block of 4 warps computes BM x 64 outputs
//     (BM 128, or 64 where 128-row tiles would leave SMs idle) with
//     mma.sync.m16n8k16 (bf16 x bf16 -> f32) on ldmatrix fragments, K walked
//     in steps of 32 through a four-stage cp.async ring filled by scalar
//     loads. The f32 sums are fixed per output: no split-K, no atomics.
//   * f32: a block of 256 threads computes 64 x 64 outputs, 4 x 4 each,
//     with CUDA-core multiply-adds in K order (no TF32; --fmad=false keeps
//     each product rounded).
// Epilogue, per element, as the plain version's eager ops round: the f32
// sum is rounded to the output dtype, then the bias is added (in f32, then
// rounded), then the residual (rounded), then the ReLU. With equal sums the
// kernel and the plain version agree to the bit. In bf16 the rounded sums
// are staged in shared memory and the rest runs on 16-byte chunks
// (epilogue8).
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef __nv_bfloat16 bf16;

// The implicit GEMM of K5-conv: output row (n, ho, wo) at tap (r, c) reads
// source pixel (t_h / istride, t_w / istride) with t_h = ho stride - pad +
// r, or zero if t is negative, not a multiple of istride or beyond (H, W).
// The forward has istride 1; the f32 data gradient runs the same loop with
// stride 1 and istride the conv's stride (a gather per dx pixel).
struct ConvShape {
  int N, H, W, Cin, Ho, Wo, Cout, k, stride, pad, M, K, istride;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The epilogue of one output element at idx (row * Cout + co).
template <typename T>
__device__ __forceinline__ float epilogue(float acc,
                                          const T* __restrict__ bias,
                                          const T* __restrict__ res,
                                          size_t idx, int co, int relu) {
  float v = rnd<T>(acc);
  if (bias) v = rnd<T>(v + to_f(bias[co]));
  if (res) v = rnd<T>(v + to_f(res[idx]));
  if (relu) v = v < 0.f ? 0.f : v;
  return v;
}

// ---- bf16: mma.sync tensor cores -------------------------------------------

constexpr int kThreadsMma = 128;
constexpr int kBK = 32;
constexpr int kStages = 4;
constexpr int kLds = kBK + 8;  // halves per shared row: 80 bytes, no conflicts

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Four 8x8 b16 matrices, each transposed: for fragments whose K index runs
// along the shared-memory rows (K5-wgrad's A and B tiles).
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r,
                                                  const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BM>
constexpr int smem_bytes() {
  return kStages * (BM + 64) * kLds * (int)sizeof(bf16);
}

// 8 bf16 of a 16-byte chunk as floats.
__device__ __forceinline__ void unpack8(uint4 u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// The bf16 epilogue of output channels co .. co + 7 of y element idx: v
// holds the conv sums already rounded to bf16. Adds the bias (rounded),
// the residual (rounded) and applies the ReLU; returns the 16-byte chunk.
__device__ __forceinline__ uint4 epilogue8(float (&v)[8],
                                           const bf16* __restrict__ bias,
                                           const bf16* __restrict__ res,
                                           size_t idx, int co, int relu) {
  if (bias) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = rnd<bf16>(v[i] + to_f(bias[co + i]));
  }
  if (res) {
    float r[8];
    unpack8(*reinterpret_cast<const uint4*>(res + idx), r);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = rnd<bf16>(v[i] + r[i]);
  }
  uint4 out;
  __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = relu && v[2 * i] < 0.f ? 0.f : v[2 * i];
    const float b = relu && v[2 * i + 1] < 0.f ? 0.f : v[2 * i + 1];
    oh[i] = __floats2bfloat162_rn(a, b);
  }
  return out;
}

// The stem's kernel (Cin = 3; any Cin): a block of 4 warps, 2 along M and
// 2 along N, computes BM x 64 outputs, each warp a (BM / 2) x 32 part. A
// thread fills one K column of the A tile per step from a per-block table
// of its rows' pixels; the B tile is read element by element.
template <int BM>
__global__ void __launch_bounds__(kThreadsMma) conv_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    const bf16* __restrict__ bias, const bf16* __restrict__ res,
    bf16* __restrict__ y, ConvShape s, int relu) {
  constexpr int NT = 4, WN = 2;
  constexpr int BN = 8 * NT * WN;
  constexpr int WM = BM * WN / 4;   // rows of a warp's part
  constexpr int MT = WM / 16;       // its m16 tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  typedef bf16 Row[kLds];
  Row* As = reinterpret_cast<Row*>(smem_raw);          // [kStages * BM]
  Row* Bs = As + kStages * BM;                         // [kStages * BN]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int HoWo = s.Ho * s.Wo;

  // Each row's (n H, ho stride - pad, wo stride - pad), once per block.
  __shared__ int row_pix[BM][3];
  for (int i = tid; i < BM; i += kThreadsMma) {
    const int m = m0 + i;
    int n = 0, ho = -(1 << 20), wo = 0;  // -2^20: never inside the image
    if (m < s.M) {
      n = m / HoWo;
      const int rem = m - n * HoWo;
      ho = rem / s.Wo;
      wo = rem - ho * s.Wo;
      ho = ho * s.stride - s.pad;
      wo = wo * s.stride - s.pad;
    }
    row_pix[i][0] = n * s.H;
    row_pix[i][1] = ho;
    row_pix[i][2] = wo;
  }
  __syncthreads();

  // Thread tid fills column tid % 32 of the tile: one tap and channel per
  // K step, the rows' pixels from the block's table.
  auto load_tile = [&](int st, int k0) {
    Row* A = As + st * BM;
    Row* Bt = Bs + st * BN;
    const bf16 zero = __float2bfloat16_rn(0.f);
    const int kc = tid % kBK, kg = k0 + kc;
    const bool kin = kg < s.K;
    int r = 0, c = 0, ci = 0;
    if (kin) {
      const int rc = kg / s.Cin;
      ci = kg - rc * s.Cin;
      r = rc / s.k;
      c = rc - r * s.k;
    }
    for (int row = tid / kBK; row < BM; row += kThreadsMma / kBK) {
      const int hi = row_pix[row][1] + r, wi = row_pix[row][2] + c;
      A[row][kc] = kin && hi >= 0 && hi < s.H && wi >= 0 && wi < s.W
                       ? x[((size_t)(row_pix[row][0] + hi) * s.W + wi) *
                               s.Cin + ci]
                       : zero;
    }
    for (int e = tid; e < BN * kBK; e += kThreadsMma) {
      const int row = e / kBK, kc = e - row * kBK;
      const int co = n0 + row, kg = k0 + kc;
      Bt[row][kc] =
          co < s.Cout && kg < s.K ? w[(size_t)co * s.K + kg] : zero;
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  // A kStages-deep ring: tile kt + kStages - 1 is loaded while tile kt is
  // multiplied. One barrier per K step: it also frees the stage that the
  // step's prefetch refills (the one consumed a step before).
  const int KT = (s.K + kBK - 1) / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < KT) load_tile(st, st * kBK);
  }
  for (int kt = 0; kt < KT; ++kt) {
    __syncthreads();
    const Row* A = As + (kt % kStages) * BM;
    const Row* Bt = Bs + (kt % kStages) * BN;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      unsigned af[MT][4], bfr[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = wm * WM + mt * 16 + (lane & 15);
        ldmatrix_x4(af[mt], &A[row][ks + (lane >> 4) * 8]);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {  // two n8 tiles per ldmatrix
        const int col = wn * (8 * NT) + np * 16 + (lane >> 4) * 8 +
                        (lane & 7);
        unsigned r[4];
        ldmatrix_x4(r, &Bt[col][ks + ((lane >> 3) & 1) * 8]);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af[mt], bfr[nt]);
    }
    const int nk = kt + kStages - 1;
    if (nk < KT) load_tile(nk % kStages, nk * kBK);
  }

  // Epilogue: the sums, rounded to bf16 (its first step), go through the
  // freed ring so that the bias, residual and ReLU pass reads and writes
  // 16 bytes a thread, neighbouring threads on neighbouring addresses.
  __syncthreads();
  constexpr int kCs = BN + 8;  // halves per staged row (16-byte multiple)
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = wm * WM + mt * 16 + g + 8 * half;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = wn * (8 * NT) + nt * 8 + 2 * tq;
        *reinterpret_cast<__nv_bfloat162*>(Cs + row * kCs + col) =
            __floats2bfloat162_rn(acc[mt][nt][2 * half],
                                  acc[mt][nt][2 * half + 1]);
      }
    }
  }
  __syncthreads();
  constexpr int kChunks = BN / 8;  // 8 channels per chunk; Cout % 8 == 0
  for (int e = tid; e < BM * kChunks; e += kThreadsMma) {
    const int r = e / kChunks, cc = (e - r * kChunks) * 8;
    const int row = m0 + r, co = n0 + cc;
    if (row >= s.M || co >= s.Cout) continue;
    const size_t idx = (size_t)row * s.Cout + co;
    float v[8];
    unpack8(*reinterpret_cast<const uint4*>(Cs + r * kCs + cc), v);
    *reinterpret_cast<uint4*>(y + idx) = epilogue8(v, bias, res, idx, co,
                                                   relu);
  }
}

// ---- f32: CUDA cores -------------------------------------------------------

constexpr int kThreadsF32 = 256;
constexpr int kTile = 64;   // outputs per block: 64 rows x 64 channels
constexpr int kBKf = 16;

__global__ void __launch_bounds__(kThreadsF32) conv_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ res,
    float* __restrict__ y, ConvShape s, int relu) {
  __shared__ float As[kBKf][kTile + 4];
  __shared__ float Bs[kBKf][kTile + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int HoWo = s.Ho * s.Wo;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < s.K; k0 += kBKf) {
    // 16 neighbouring threads read 16 neighbouring K entries of one row.
#pragma unroll
    for (int j = 0; j < kTile * kBKf / kThreadsF32; ++j) {
      const int e = tid + j * kThreadsF32;
      const int row = e / kBKf, kc = e - row * kBKf;
      const int m = m0 + row, kg = k0 + kc;
      float v = 0.f;
      if (m < s.M && kg < s.K) {
        const int n = m / HoWo, rem = m - n * HoWo;
        const int ho = rem / s.Wo, wo = rem - ho * s.Wo;
        const int rc = kg / s.Cin, ci = kg - rc * s.Cin;
        const int r = rc / s.k, c = rc - r * s.k;
        const int th = ho * s.stride - s.pad + r;
        const int tw = wo * s.stride - s.pad + c;
        if (th >= 0 && tw >= 0 && th % s.istride == 0 &&
            tw % s.istride == 0) {
          const int hi = th / s.istride, wi = tw / s.istride;
          if (hi < s.H && wi < s.W) {
            v = x[((size_t)(n * s.H + hi) * s.W + wi) * s.Cin + ci];
          }
        }
      }
      As[kc][row] = v;
      const int co = n0 + row;
      Bs[kc][row] = co < s.Cout && kg < s.K ? w[(size_t)co * s.K + kg] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < kBKf; ++kc) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kc][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kc][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= s.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tx + 16 * j;
      if (co >= s.Cout) continue;
      const size_t idx = (size_t)row * s.Cout + co;
      y[idx] = epilogue<float>(acc[i][j], bias, res, idx, co, relu);
    }
  }
}

constexpr int kMaxDevices = 64;

template <int BM>
cudaError_t launch_stem(const ConvShape& s, const void* x, const void* w,
                        const void* bias, const void* res, void* y, int relu,
                        cudaStream_t stream) {
  constexpr int bytes = smem_bytes<BM>();
  // The shared-memory attribute belongs to a device: it is set at each
  // kernel's first launch on each device (on every launch past the 64th).
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(conv_bf16_kernel<BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) configured[dev] = true;
  }
  const dim3 grid((s.M + BM - 1) / BM, (s.Cout + 63) / 64);
  conv_bf16_kernel<BM><<<grid, kThreadsMma, bytes, stream>>>(
      (const bf16*)x, (const bf16*)w, (const bf16*)bias, (const bf16*)res,
      (bf16*)y, s, relu);
  return cudaGetLastError();
}

// An H100's SMs: the stem's tile is 128 rows where that still gives every
// SM a block, else 64 (a constant; the tile changes no sum).
constexpr int kSms = 132;

// K10's 7x7 / stride-2 stem in bf16 at 64 output channels (the ResNet's):
// its K = 7 x 7 x 3 = 147 laid out as 7 tap rows of 24 (21 (column,
// channel) pairs, padded with zero weights), so that output pixel m's K
// slice of tap row r is the input patch's elements 6m .. 6m + 23 of that
// row; runs of up to 128 output pixels of one row for the weight
// gradient (stem7_wgrad_kernel below), of 32 for the forward (stem7_kernel,
// with the Hopper helpers further down).
constexpr int kStemRows = 7, kStemJ = 24;  // tap rows, taps a row padded
constexpr int kStemRun = 128;              // output pixels a wgrad run

cudaError_t launch_stem_any(const ConvShape& s, const void* x, const void* w,
                            const void* bias, const void* res, void* y,
                            int relu, cudaStream_t st) {
  const long long blocks =
      (long long)((s.M + 127) / 128) * ((s.Cout + 63) / 64);
  if (blocks >= kSms) return launch_stem<128>(s, x, w, bias, res, y, relu, st);
  return launch_stem<64>(s, x, w, bias, res, y, relu, st);
}

// ---- K5-wgrad: dw = sum over rows (n, ho, wo) of dy (x) im2col(x) -------
//
// A GEMM of Cout x K (kh, kw, ci in the OHWI weight's order) over R = N Ho
// Wo rows, which is long (196,608 rows for the 48-channel 3x3s at 64^2 and
// batch 48) where Cout x K is small (48 x 432). The rows are cut into
// `parts` fixed partitions of `rows_per_part` (a function of the shape
// alone, chosen by the wrapper): block (tile, partition) sums its rows in
// row order into an f32 partial; the second pass adds the partials in
// partition order and rounds once. No atomics: the same bits on any card.
// Blocks of the first K tile also sum dy's columns (dbias) and, with a ReLU
// mask (y > 0 on the saved output), write the masked dy once (dym), which
// the data gradient and the residual's gradient then read. The bf16
// kernel for Cin % 8 == 0 is the wgmma kernel below (wgrad_wgmma_kernel),
// the ResNet's 7x7 stem's is stem7_wgrad_kernel (K10, below); this one
// takes the other stems (Cin = 3: HRNet's 3x3, one conv a train step, at
// cuDNN's time), 64 x 64 tiles of mma.sync on scalar loads.
constexpr int kWT = 64;        // output channels and K columns per block
constexpr int kWR = 32;        // rows per step (bf16)
constexpr int kWLd = kWT + 8;  // halves per shared row: 144 bytes, no conflicts

__device__ __forceinline__ uint4 relu_mask8(uint4 v, uint4 m) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&m);
  unsigned* out = reinterpret_cast<unsigned*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    const unsigned keep = (f.x > 0.f ? 0x0000ffffu : 0u) |
                          (f.y > 0.f ? 0xffff0000u : 0u);
    out[i] &= keep;
  }
  return v;
}

__global__ void __launch_bounds__(kThreadsMma) wgrad_bf16_scalar_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dy,
    const bf16* __restrict__ ymask, bf16* __restrict__ dym,
    float* __restrict__ part, float* __restrict__ pbias, ConvShape s,
    int rows_per_part) {
  __shared__ __align__(16) bf16 As[2][kWR][kWLd];  // dy rows: [row][co]
  __shared__ __align__(16) bf16 Bs[2][kWR][kWLd];  // im2col x: [row][kk]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // 2 x 2 warps of 32 x 32
  const int co0 = blockIdx.x * kWT, kk0 = blockIdx.y * kWT;
  const int p = blockIdx.z;
  const bool first = blockIdx.y == 0;
  const int r_begin = p * rows_per_part;
  const int r_end = min(s.M, r_begin + rows_per_part);
  const int steps = (r_end - r_begin + kWR - 1) / kWR;
  const int HoWo = s.Ho * s.Wo;

  // dy: 16-byte chunk (tid & 7) of rows (tid >> 3) and (tid >> 3) + 16.
  const int dc = (tid & 7) * 8;
  const bool co_in = co0 + dc < s.Cout;  // Cout % 8 == 0
  // x: column tid & 63 of rows (tid >> 6) + 2 j; its tap, decoded once.
  const int xc = tid & 63;
  const int kk = kk0 + xc;
  const bool k_in = kk < s.K;
  int tap_r = 0, tap_c = 0, tap_ci = 0;
  if (k_in) {
    const int rc = kk / s.Cin;
    tap_ci = kk - rc * s.Cin;
    tap_r = rc / s.k;
    tap_c = rc - tap_r * s.k;
  }

  uint4 ra[2];
  bf16 rs[16];
  const bf16 zero = __float2bfloat16_rn(0.f);
  auto load = [&](int step) {
    const int base = r_begin + step * kWR;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int g = base + (tid >> 3) + 16 * j;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (g < r_end && co_in) {
        const size_t idx = (size_t)g * s.Cout + co0 + dc;
        v = *reinterpret_cast<const uint4*>(dy + idx);
        if (ymask) {
          v = relu_mask8(v, *reinterpret_cast<const uint4*>(ymask + idx));
          if (first && dym) *reinterpret_cast<uint4*>(dym + idx) = v;
        }
      }
      ra[j] = v;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int g = base + (tid >> 6) + 2 * j;
      bf16 v = zero;
      if (g < r_end && k_in) {
        const int n = g / HoWo, rem = g - n * HoWo;
        const int ho = rem / s.Wo, wo = rem - ho * s.Wo;
        const int hi = ho * s.stride - s.pad + tap_r;
        const int wi = wo * s.stride - s.pad + tap_c;
        if (hi >= 0 && hi < s.H && wi >= 0 && wi < s.W) {
          v = x[((size_t)(n * s.H + hi) * s.W + wi) * s.Cin + tap_ci];
        }
      }
      rs[j] = v;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      *reinterpret_cast<uint4*>(&As[buf][(tid >> 3) + 16 * j][dc]) = ra[j];
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) Bs[buf][(tid >> 6) + 2 * j][xc] = rs[j];
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  float bacc = 0.f;  // dbias of channel co0 + tid (tid < 64, first K tile)

  if (steps > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int st = 0; st < steps; ++st) {
    const int buf = st & 1;
    if (st + 1 < steps) load(st + 1);  // in flight while this step computes
#pragma unroll
    for (int ks = 0; ks < kWR; ks += 16) {
      unsigned af[2][4], bfr[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        ldmatrix_x4_trans(af[mt],
                          &As[buf][ks + (lane & 7) + ((lane >> 4) << 3)]
                             [wm * 32 + mt * 16 + ((lane >> 3) & 1) * 8]);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned q[4];
        ldmatrix_x4_trans(q, &Bs[buf][ks + (lane & 7) + ((lane >> 3) & 1) * 8]
                                [wn * 32 + np * 16 + (lane >> 4) * 8]);
        bfr[2 * np][0] = q[0];
        bfr[2 * np][1] = q[1];
        bfr[2 * np + 1][0] = q[2];
        bfr[2 * np + 1][1] = q[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af[mt], bfr[nt]);
    }
    if (pbias && first && tid < kWT) {
      for (int r = 0; r < kWR; ++r) bacc += __bfloat162float(As[buf][r][tid]);
    }
    if (st + 1 < steps) store(buf ^ 1);
    __syncthreads();
  }

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int co = co0 + wm * 32 + mt * 16 + g + 8 * (q >> 1);
        const int kc = kk0 + wn * 32 + nt * 8 + 2 * t4 + (q & 1);
        if (co < s.Cout && kc < s.K) {
          part[((size_t)p * s.Cout + co) * s.K + kc] = acc[mt][nt][q];
        }
      }
  if (pbias && first && tid < kWT && co0 + tid < s.Cout) {
    pbias[(size_t)p * s.Cout + co0 + tid] = bacc;
  }
}

// f32: 256 threads, 4 x 4 outputs each, 16 rows per step, multiply-adds in
// row order on the CUDA cores (no TF32).
constexpr int kWRf = 16;

__global__ void __launch_bounds__(kThreadsF32) wgrad_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ dy,
    const float* __restrict__ ymask, float* __restrict__ dym,
    float* __restrict__ part, float* __restrict__ pbias, ConvShape s,
    int rows_per_part) {
  __shared__ float As[kWRf][kWT + 4];
  __shared__ float Bs[kWRf][kWT + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int co0 = blockIdx.x * kWT, kk0 = blockIdx.y * kWT;
  const int p = blockIdx.z;
  const bool first = blockIdx.y == 0;
  const int r_begin = p * rows_per_part;
  const int r_end = min(s.M, r_begin + rows_per_part);
  const int HoWo = s.Ho * s.Wo;
  // Column tid & 63 of rows (tid >> 6) + 4 j, for dy and for x.
  const int col = tid & 63;
  const int co = co0 + col, kk = kk0 + col;
  const bool co_in = co < s.Cout, k_in = kk < s.K;
  int tap_r = 0, tap_c = 0, tap_ci = 0;
  if (k_in) {
    const int rc = kk / s.Cin;
    tap_ci = kk - rc * s.Cin;
    tap_r = rc / s.k;
    tap_c = rc - tap_r * s.k;
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float bacc = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += kWRf) {
#pragma unroll
    for (int j = 0; j < kWRf * kWT / kThreadsF32; ++j) {
      const int row = (tid >> 6) + 4 * j, g = r0 + row;
      float a = 0.f, b = 0.f;
      if (g < r_end) {
        if (co_in) {
          const size_t idx = (size_t)g * s.Cout + co;
          a = dy[idx];
          if (ymask) {
            a = ymask[idx] > 0.f ? a : 0.f;
            if (first && dym) dym[idx] = a;
          }
        }
        if (k_in) {
          const int n = g / HoWo, rem = g - n * HoWo;
          const int ho = rem / s.Wo, wo = rem - ho * s.Wo;
          const int hi = ho * s.stride - s.pad + tap_r;
          const int wi = wo * s.stride - s.pad + tap_c;
          if (hi >= 0 && hi < s.H && wi >= 0 && wi < s.W) {
            b = x[((size_t)(n * s.H + hi) * s.W + wi) * s.Cin + tap_ci];
          }
        }
      }
      As[row][col] = a;
      Bs[row][col] = b;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kWRf; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[r][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[r][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    if (pbias && first && tid < kWT) {
      for (int r = 0; r < kWRf; ++r) bacc += As[r][tid];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = co0 + ty + 16 * i;
    if (c >= s.Cout) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kc = kk0 + tx + 16 * j;
      if (kc < s.K) part[((size_t)p * s.Cout + c) * s.K + kc] = acc[i][j];
    }
  }
  if (pbias && first && tid < kWT && co0 + tid < s.Cout) {
    pbias[(size_t)p * s.Cout + co0 + tid] = bacc;
  }
}

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The second pass: dw (and dbias) = the partials summed in partition order,
// rounded once to the output dtype.
template <typename T>
__global__ void wgrad_reduce_kernel(const float* __restrict__ part,
                                    const float* __restrict__ pbias,
                                    T* __restrict__ dw, T* __restrict__ db,
                                    int parts, int CK, int Cout) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < CK) {
    float v = 0.f;
    for (int p = 0; p < parts; ++p) v += part[(size_t)p * CK + idx];
    store_as(dw + idx, v);
  } else if (pbias && idx < CK + Cout) {
    const int c = idx - CK;
    float v = 0.f;
    for (int p = 0; p < parts; ++p) v += pbias[(size_t)p * Cout + c];
    store_as(db + c, v);
  }
}

// The ReLU's VJP alone, for a conv whose weight and bias take no
// gradient: dym = dy where y > 0, else 0 (the sign of dy kept).
template <typename T>
__global__ void relu_mask_kernel(const T* __restrict__ dy,
                                 const T* __restrict__ y, T* __restrict__ dym,
                                 long long n) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    dym[i] = to_f(y[i]) > 0.f ? dy[i] : T(0.f);
  }
}

// ---- K10's weight gradient: the 7x7 / stride-2 stem, bf16, 64 channels ---
//
// dw[co][k] = sum over output pixels of dy[pixel][co] im2col[pixel][k], K =
// 147 (7 tap rows x 21 (column, channel) pairs, the OHWI weight's order).
// The scalar kernel above gathers its im2col columns with a 2-byte load
// and its own index divisions per element and reads dy once per 64-wide K
// tile. Here a block takes runs of up to 128 output
// pixels of one output row: for each run it copies the 7 input rows the
// run reads (pad 3 as zeros) and the run's dy tile (128 x 64) into shared
// memory once, with 16-byte cp.async, the next run's copies in flight while
// this run's products run. The products are mma.sync m16n8k16 with the
// pixels as the reduction: A = dy^T by ldmatrix.trans from the staged tile
// (all 64 channels in each warp), B = im2col, each warp 40 K columns (5 n8
// tiles; 4 warps cover 160 = K + 13). Pixel m's element of column (r, j)
// is the patch's element 6m + j of row r, so a B register (two neighbouring
// pixels of one column) is two 2-byte shared loads. Column 147 reads a
// constant 1: its sums are dbias. Fixed partitions of runs (the caller's,
// from the shape alone) sum their runs in order, each run's eight 16-pixel
// steps in order, into f32 partials that wgrad_reduce_kernel adds in
// partition order. Input rows start on a 16-byte boundary when W % 8 == 0
// (the ResNet's 256); else a row's copy starts at the boundary below it
// (its shift, 0-7 elements, is added to every read) and the chunks that
// straddle the row's ends are copied element by element. It runs at about
// a third of its byte bound: a run costs ~1370 shared-memory wavefronts,
// 640 of them the 2-byte gathers (the stride-2, 3-channel patch has no
// 16-byte view that is contiguous in pixels), beside 640 mma.sync.
constexpr int kSwRow = 800;                       // halves a patch row
constexpr int kSwChunks = kSwRow / 8;             // 16-byte chunks a row
constexpr int kSwDyLd = 72;                       // halves a staged dy row
constexpr int kSwWarps = 4;                       // warps a block
constexpr int kSwThreads = 32 * kSwWarps;
constexpr int kSwNt = 160 / (8 * kSwWarps);       // n8 tiles a warp
constexpr int kSwPatch = kStemRows * kSwRow + 8;  // + the constants 1, 0
constexpr int kSwStage = kSwPatch + kStemRun * kSwDyLd;  // halves a stage
constexpr int kSwBytes = 2 * kSwStage * (int)sizeof(bf16);

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned pack2(bf16 lo, bf16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo) |
         ((unsigned)__bfloat16_as_ushort(hi) << 16);
}

__global__ void __launch_bounds__(kSwThreads, 3) stem7_wgrad_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dy,
    const bf16* __restrict__ ymask, bf16* __restrict__ dym,
    float* __restrict__ part, float* __restrict__ pbias, ConvShape s,
    int runs, int runs_per_part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const stages = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int p = blockIdx.x;
  const int r_begin = p * runs_per_part;
  const int count = max(0, min(runs, r_begin + runs_per_part) - r_begin);
  const int wruns = (s.Wo + kStemRun - 1) / kStemRun;
  const long long row_len = 3LL * s.W;  // halves of an input row
  const bf16 zero = __float2bfloat16_rn(0.f);
  if (tid < 4) {  // the constant columns' values, in both stages
    stages[(tid >> 1) * kSwStage + kStemRows * kSwRow + (tid & 1)] =
        __float2bfloat16_rn(tid & 1 ? 0.f : 1.f);
  }
  // This thread's K columns n = 8 (kSwNt warp + nt) + g: tap row r, element
  // 7 + j of the shifted patch row, 6 elements a pixel; column 147 the
  // constant 1, past it 0 (no step).
  int col_row[kSwNt], col_off[kSwNt], col_step[kSwNt];
#pragma unroll
  for (int nt = 0; nt < kSwNt; ++nt) {
    const int n = (warp * kSwNt + nt) * 8 + g;
    const int r = n / 21;
    col_row[nt] = n < 147 ? r : -1;
    col_off[nt] = n < 147 ? r * kSwRow + 7 + (n - 21 * r)
                          : kStemRows * kSwRow + (n == 147 ? 0 : 1);
    col_step[nt] = n < 147 ? 6 : 0;
  }
  // Where run `run` lies, and input row hi's offset in x (halves).
  auto locate = [&](int run, int* n, int* ho, int* wo0) {
    *wo0 = run % wruns * kStemRun;
    *ho = run / wruns % s.Ho;
    *n = run / wruns / s.Ho;
  };
  auto row_base = [&](int n, int hi) { return (n * s.H + hi) * row_len; };

  // Copies of run `run` into stage st: patch row r holds x's halves from
  // the 16-byte boundary at or below the run's first (pad included).
  auto copy_run = [&](int run, int st) {
    bf16* P = stages + st * kSwStage;
    bf16* D = P + kSwPatch;
    int n, ho, wo0;
    locate(run, &n, &ho, &wo0);
    for (int e = tid; e < kStemRows * kSwChunks; e += kSwThreads) {
      const int r = e / kSwChunks, q = e - r * kSwChunks;
      bf16* dst = P + r * kSwRow + 8 * q;
      const int hi = 2 * ho - 3 + r;
      const long long lo = hi >= 0 && hi < s.H ? row_base(n, hi) : 0;
      const long long end = hi >= 0 && hi < s.H ? lo + row_len : 0;
      const long long g0 = lo - (lo & 7) + 6LL * wo0 - 16 + 8 * q;
      if (g0 >= lo && g0 + 8 <= end) {
        cp_async16(dst, x + g0, true);
      } else if (g0 + 8 <= lo || g0 >= end) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          dst[i] = g0 + i >= lo && g0 + i < end ? x[g0 + i] : zero;
        }
      }
    }
    const size_t row0 = ((size_t)n * s.Ho + ho) * s.Wo + wo0;
    for (int e = tid; e < kStemRun * 8; e += kSwThreads) {
      const int m = e >> 3, c = (e & 7) * 8;
      bf16* dst = D + m * kSwDyLd + c;
      const bool in = wo0 + m < s.Wo;
      const size_t idx = (row0 + m) * 64 + c;
      if (ymask == nullptr) {
        cp_async16(dst, in ? dy + idx : dy, in);
      } else {  // the ReLU mask, and the masked dy written once
        uint4 v = make_uint4(0, 0, 0, 0);
        if (in) {
          v = relu_mask8(*reinterpret_cast<const uint4*>(dy + idx),
                         *reinterpret_cast<const uint4*>(ymask + idx));
          *reinterpret_cast<uint4*>(dym + idx) = v;
        }
        *reinterpret_cast<uint4*>(dst) = v;
      }
    }
    cp_async_commit();
  };

  float acc[4][kSwNt][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kSwNt; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  if (count > 0) copy_run(r_begin, 0);
  for (int i = 0; i < count; ++i) {
    const int st = i & 1;
    if (i + 1 < count) {
      copy_run(r_begin + i + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* P = stages + st * kSwStage;
    const bf16* D = P + kSwPatch;
    int n, ho, wo0;
    locate(r_begin + i, &n, &ho, &wo0);
    int off[kSwNt];
#pragma unroll
    for (int nt = 0; nt < kSwNt; ++nt) {
      const int hi = 2 * ho - 3 + col_row[nt];
      off[nt] = col_off[nt] + (col_row[nt] >= 0 && hi >= 0 && hi < s.H
                                   ? (int)(row_base(n, hi) & 7)
                                   : 0);
    }
#pragma unroll
    for (int ks = 0; ks < kStemRun; ks += 16) {
      unsigned a[4][4], b[kSwNt][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        ldmatrix_x4_trans(a[mt], D + (ks + (lane & 7) + ((lane >> 4) << 3)) *
                                         kSwDyLd +
                                     mt * 16 + ((lane >> 3) & 1) * 8);
      }
#pragma unroll
      for (int nt = 0; nt < kSwNt; ++nt) {
        const int d = col_step[nt];
        const bf16* q = P + off[nt] + d * (ks + 2 * t);
        b[nt][0] = pack2(q[0], q[d]);
        b[nt][1] = pack2(q[8 * d], q[9 * d]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < kSwNt; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();  // this stage is refilled by the next iteration's copy
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < kSwNt; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int co = mt * 16 + g + 8 * (q >> 1);
        const int kc = (warp * kSwNt + nt) * 8 + 2 * t + (q & 1);
        if (kc < 147) {
          part[((size_t)p * 64 + co) * 147 + kc] = acc[mt][nt][q];
        } else if (kc == 147 && pbias) {
          pbias[(size_t)p * 64 + co] = acc[mt][nt][q];
        }
      }
}

// ---- Hopper: mbarrier ring, cp.async / TMA, wgmma --------------------------
//
// K5-dgrad and K5-wgrad in bf16 (Cin % 8 == 0). Both are implicit GEMMs
// run by one block of three warpgroups: warpgroups 0 and 1 consume (each
// a 64-row m64nNk16 wgmma strip of a 128-row tile, f32 sums in registers),
// warpgroup 2 produces, filling a ring of 3 or 4 stages in dynamic shared memory
// with 16-byte cp.async gathers (zero-fill) and TMA boxes, each stage
// completed on its `full` mbarrier and handed back on its `empty` one.
// Every operand tile is stored in the 128-byte swizzle that TMA writes and
// the wgmma descriptor names: rows of 128 bytes, 8-row atoms of 1024 bytes
// (1024-byte aligned), the 16-byte chunk c of row r at c ^ (r % 8).
constexpr int kRing = 4;
constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kHopperThreads = kConsumers + 128;
constexpr int kTileRows = 128;  // the M side of a block: two m64 strips
constexpr int kStageA = kTileRows * 128;  // bytes of the 128 x 64 A tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ bool mbar_try(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// Waits until the phase of parity `parity` has completed. A wait of more
// than 2^34 clocks (~9 s) is a lost arrival, a fault of the kernel: it
// traps, so that the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity)) {
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}
// One arrival on `bar` once this thread's earlier cp.async copies land.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Makes generic-proxy writes to shared memory (cp.async, st.shared)
// visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1
// (SWIZZLE_128B). K-major: SBO = 1024 (8-row atoms), LBO unused. MN-major:
// LBO = the stride of 64-element MN blocks, SBO = 1024 (8-deep K groups).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator accesses across the
// asynchronous wgmma that writes them.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma.mma_async m64nNk16, bf16 x bf16 -> f32, A and B from shared memory
// through descriptors; TA / TB: 0 K-major, 1 MN-major. The accumulators
// (N / 2 a thread) are added to (scale-d 1): callers zero them first.
template <int N, int TA, int TB>
struct Wgmma;

template <int TA, int TB>
struct Wgmma<48, TA, TB> {
  static __device__ __forceinline__ void mma(float (&d)[24], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1, %27, %28;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<64, TA, TB> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<96, TA, TB> {
  static __device__ __forceinline__ void mma(float (&d)[48], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, %51, %52;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<128, TA, TB> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<192, TA, TB> {
  static __device__ __forceinline__ void mma(float (&d)[96], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<256, TA, TB> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

// The byte offset of 16-byte chunk `chunk` of row `row` in a swizzled tile.
__device__ __forceinline__ int sw128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// x / d for 0 <= x < 2^31 by a multiply and a shift (d > 0; fast_div sets
// the constants on the host).
struct FastDiv {
  uint32_t mul, shift;
};
__device__ __forceinline__ int fdiv(int x, const FastDiv& f) {
  return (int)((__umulhi((uint32_t)x, f.mul) + (uint32_t)x) >> f.shift);
}

// ---- K5-dgrad (bf16): dx = the data gradient of the conv, on wgmma --------
//
// Replaces: the data gradient of shapy_tpu/models/backbones/layers.py:91
// conv2d (JAX autodiff of lax.conv_general_dilated; XLA's conv on the
// MXU). Bound on the H100: a train step's 330 calls at batch 48 do 2.313
// TFLOP against 7.46 GB of inputs and outputs, 2.338 ms at 989 TFLOP/s
// (2.23 ms at 3.35 TB/s): the tensor cores in sum, but each call's K walk
// re-reads dy k^2 times and the weight once per M tile through L2, which
// caps the small-channel convs below that. The design: wgmma at full
// width from swizzled tiles, no MMA on the taps a stride skips, the
// weight's boxes straight from where it lies, a ring that keeps 3-4
// stages of loads in flight, and a persistent grid that fills all SMs.
// dx(n, h, w, ci) = sum over taps (r, c) and co of dy(n, ho, wo, co) w(co,
// r, c, ci), ho = (h + pad - r) / stride where that is a whole number in
// [0, Ho) (wo alike). For stride 2 a dx pixel of parity (ph, pw) meets a dy
// pixel only at the taps with r = ph + pad and c = pw + pad (mod 2): 1, 2,
// 2 or 4 of a 3x3's 9, none at the odd pixels of a 1x1. So dx is cut into
// its stride^2 parity classes, each a dense implicit GEMM over its own
// taps: M = its pixels (i, j), dx pixel (ph + stride i, pw + stride j), N
// = Cin, K = its taps x Cout; for stride 1 one class with all k^2 taps.
// Tap (r, c) of a class reads dy at (i + dh, j + dw), dh = (ph + pad - r)
// / stride: a stride-1 window of dy, zero outside it. One launch runs every
// class, heaviest first (the tile index picks class, M tile, N tile and K
// partition); a class with no tap writes zeros without an MMA.
//   * A (an M tile of pixels x bk channels of one tap, K-major): a TMA box
//     of dy viewed as (N, Ho, Wo, Cout), {64 channels, bw, bh, bn} pixels
//     (bw bh bn <= 128: whole class rows of one or more images, or a run of
//     columns of one row), at (co0, j0 + dw, i0 + dh, n0). The hardware
//     fills what lies outside dy (the padding, the ragged edges) with
//     zeros; rows of the tile beyond the class are computed and dropped.
//   * B (bk x BN, MN-major): the weight where it lies. w(co, r, c, ci) viewed
//     as (Cout, k^2, Cin) is a TMA box of bk rows (co) by 64 ci per 64-wide
//     N block at (ci0, r k + c, co0): no flipped copy of the weight.
//   * bk (64, 48, 32 or 16) divides Cout where it can, so a K step never
//     straddles two taps and the 48-, 96- and 192-channel convs waste no
//     column; BN divides Cin where it can.
//   * K partitions: where the tiles are fewer than the SMs (the 8^2 and 16^2
//     maps), partition p of P takes steps [p S / P, (p + 1) S / P) of the
//     class's S K steps and writes f32 partials; wgrad_reduce_kernel adds
//     them in partition order and rounds once. P comes from the shape alone
//     (the wrapper's plan), so two calls give the same bits on any card.
// One producer thread issues every load (an A box and BN / 64 B boxes a
// step). Epilogue: the f32 sums rounded once to bf16 (P = 1), staged in
// shared memory, then 16-byte chunks of channels_last dx rows.
//
// ---- K5-conv (bf16, Cin % 8 == 0): the forward on the same core ----------
//
// Replaces: shapy_tpu/models/backbones/layers.py:91 conv2d and
// hrnet.py:101 _merged_conv, as K5-conv's stem kernel above (the epilogue
// and its rounding are the same). Bound on the H100: a served forward's
// 331 convs at batch 32 do 1.544 TFLOP against 6.15 GB, 1.84 ms at 989
// TFLOP/s: the tensor cores, but at the 8^2 and 16^2 maps a call has fewer
// 128-row tiles than SMs. The stride-1 forward is K5-dgrad's stride-1 class
// with the taps unflipped, so it runs the same kernel body (implicit_gemm,
// kFwd): M = the N Ho Wo output pixels, N = Cout, K = (tap, Cin) in steps of
// bk channels of one tap.
//   * A: a TMA box of x viewed as (N, H, W, Cin), {64 channels, bw, bh, bn}
//     output pixels at (ci0, stride j0 + c - pad, stride i0 + r - pad, n0);
//     for stride 2 the box map steps 2 pixels in H and W (TMA's element
//     strides), so a tap reads every second pixel of a 2bw x 2bh window
//     and no gather runs on the SM. The hardware zero-fills the padding
//     and the ragged edges.
//   * B (BN x bk, K-major): the OHWI weight where it lies, viewed as (Cout,
//     k^2, Cin): one box of 64 ci x 1 tap x BN co at (ci0, r k + c, co0).
//   * bk (64, 48 or 16) divides Cin where it can; a 64-wide box whose
//     channels run past Cin is zero-filled, and only bk of them are
//     multiplied.
//   * K partitions from the shape alone (the wrapper's plan): P > 1 writes
//     f32 partials, and conv_reduce_kernel adds them in partition order,
//     rounds once and runs the epilogue; P = 1 runs it in the kernel.
// Epilogue: epilogue8 on the sums rounded to bf16 and staged in shared
// memory, 16-byte chunks of y and of the residual.
struct GemmClass {
  int ph, pw, Hc, Wc, ntaps, begin, hblocks, wblocks;
  int tap[9];  // r k + c | (dh + 1) << 8 | (dw + 1) << 12
};
// H, W and nch are the output's (dx for K5-dgrad, y for K5-conv): class
// pixel (i, j) is output pixel (ph + stride i, pw + stride j), and its tap
// reads A at (astride i + dh, astride j + dw).
struct GemmParams {
  int N, H, W, nch, stride, astride;
  int cchunks, ntiles, parts, nclass, tiles;
  int box_n, box_h, box_w;  // the A box's images, rows and columns
  GemmClass cls[4];
};

// Tile t of a launch: its class, first image, row and column, first
// output channel, K partition and K steps.
struct GemmTile {
  int c, n0, i0, j0, ci0, p, s0, s1;
};
__device__ __forceinline__ GemmTile gemm_tile(const GemmParams& P, int t,
                                              int bn) {
  GemmTile d;
  d.c = 0;
  while (d.c + 1 < P.nclass && t >= P.cls[d.c + 1].begin) ++d.c;
  const GemmClass& C = P.cls[d.c];
  const int mtiles =
      (P.N + P.box_n - 1) / P.box_n * C.hblocks * C.wblocks;
  const int local = t - C.begin;
  const int nt = local % P.ntiles, rest = local / P.ntiles;
  const int mt = rest % mtiles;
  d.j0 = mt % C.wblocks * P.box_w;
  d.i0 = mt / C.wblocks % C.hblocks * P.box_h;
  d.n0 = mt / (C.wblocks * C.hblocks) * P.box_n;
  d.ci0 = nt * bn;
  d.p = rest / mtiles;
  const int steps = C.ntaps * P.cchunks;
  d.s0 = (int)((long long)d.p * steps / P.parts);
  d.s1 = (int)((long long)(d.p + 1) * steps / P.parts);
  return d;
}

// The shared memory of an implicit_gemm<BN, BK, fwd> block with `stages`
// ring stages: 1024 bytes of alignment, the stages (the 128 x 64 A tile +
// the B tile: BN / 64 boxes of BK rows for K5-dgrad, BN rows of 64 for
// K5-conv), the epilogue's staged 128 x BN bf16 tile and the mbarriers.
// Two blocks share an SM where three stages fit in half of it (N tiles <=
// 64); the ring is four stages deep where they fit, else three.
__host__ __device__ constexpr int gemm_stage_b(int bn, int bk, bool fwd) {
  return fwd ? bn * 128 : (bn + 63) / 64 * bk * 128;
}
__host__ __device__ constexpr int gemm_bytes(int bn, int bk, bool fwd,
                                             int stages) {
  return 1024 + stages * (kStageA + gemm_stage_b(bn, bk, fwd)) +
         kTileRows * (bn + 8) * 2 + 2 * stages * 8;
}
constexpr int kHalfSm = 115712, kWholeBlock = 232448;
__host__ __device__ constexpr bool gemm_pair(int bn, int bk, bool fwd) {
  return bn <= 64 && gemm_bytes(bn, bk, fwd, 3) <= kHalfSm;
}
__host__ __device__ constexpr int gemm_stages(int bn, int bk, bool fwd) {
  return gemm_bytes(bn, bk, fwd, 4) <=
                 (gemm_pair(bn, bk, fwd) ? kHalfSm : kWholeBlock)
             ? 4
             : 3;
}

// The body of both kernels. A persistent grid: block b takes tiles b, b +
// gridDim.x, ...; the ring's stage and phase run on across tiles, so that
// the producer fills the next tile's stages while the consumers write the
// last one's outputs. Which block takes a tile changes nothing in its sums.
// kFwd (K5-conv): B is K-major, and the epilogue adds bias and residual and
// applies the ReLU; else (K5-dgrad) B is MN-major and there is no epilogue.
template <int BN, int BK, bool kFwd>
__device__ __forceinline__ void implicit_gemm(
    const CUtensorMap& amap, const CUtensorMap& wmap, bf16* __restrict__ out,
    float* __restrict__ part, const bf16* __restrict__ bias,
    const bf16* __restrict__ res, int relu, const GemmParams& P) {
  constexpr int kBoxes = (BN + 63) / 64;
  constexpr int kStageB = gemm_stage_b(BN, BK, kFwd);
  constexpr int kStages = gemm_stages(BN, BK, kFwd);
  constexpr int kCs = BN + 8;  // halves per staged output row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* As = smem;
  unsigned char* Bs = smem + kStages * kStageA;
  bf16* Cs = reinterpret_cast<bf16*>(Bs + kStages * kStageB);
  uint64_t* full = reinterpret_cast<uint64_t*>(Cs + kTileRows * kCs);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);  // the producer's expect_tx; then the bytes
      mbar_init(&empty[i], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    if (tid != kConsumers) return;  // one thread issues the loads
    const uint32_t tx =
        (uint32_t)(64 * P.box_w * P.box_h * P.box_n * 2 + kStageB);
    int it = 0;  // steps produced by this block, over all its tiles
    for (int t = blockIdx.x; t < P.tiles; t += gridDim.x) {
      const GemmTile d = gemm_tile(P, t, BN);
      const GemmClass& C = P.cls[d.c];
      for (int s = d.s0; s < d.s1; ++s, ++it) {
        const int st = it % kStages;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        const int tp = s / P.cchunks, k0 = (s - tp * P.cchunks) * BK;
        const int tap = C.tap[tp];
        const int rc = tap & 255, dh = ((tap >> 8) & 15) - 1,
                  dw = ((tap >> 12) & 15) - 1;
        unsigned char* b = Bs + st * kStageB;
        mbar_expect_tx(&full[st], tx);
        tma_load_4d(As + st * kStageA, &amap, &full[st], k0,
                    P.astride * d.j0 + dw, P.astride * d.i0 + dh, d.n0);
        if (kFwd) {
          tma_load_3d(b, &wmap, &full[st], k0, rc, d.ci0);
        } else {
#pragma unroll
          for (int j = 0; j < kBoxes; ++j) {
            tma_load_3d(b + j * BK * 128, &wmap, &full[st], d.ci0 + 64 * j,
                        rc, k0);
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup wg multiplies rows 64 wg .. 64 wg + 63.
    const int wg = tid >> 7, lane = tid & 31;
    const int rbase = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
    const int cbase = 2 * (lane & 3);
    const size_t plane = (size_t)P.N * P.H * P.W;
    const int box_rows = P.box_w * P.box_h;
    int it = 0;  // steps consumed by this block, over all its tiles
    for (int t = blockIdx.x; t < P.tiles; t += gridDim.x) {
      const GemmTile d = gemm_tile(P, t, BN);
      const GemmClass& C = P.cls[d.c];
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int s = d.s0; s < d.s1; ++s, ++it) {
        const int st = it % kStages;
        mbar_wait(&full[st], (it / kStages) & 1);
        const unsigned char* a = As + st * kStageA + wg * 64 * 128;
        const unsigned char* b = Bs + st * kStageB;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          if (kFwd) {
            Wgmma<BN, 0, 0>::mma(acc, sw128_desc(a + kk * 32, 16, 1024),
                                 sw128_desc(b + kk * 32, 16, 1024));
          } else {
            Wgmma<BN, 0, 1>::mma(acc, sw128_desc(a + kk * 32, 16, 1024),
                                 sw128_desc(b + kk * 2048, BK * 128, 1024));
          }
        }
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();
        fence_acc(acc);
        if (s > d.s0) {  // the previous step's wgmma has read its stage
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (d.s1 > d.s0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }

      // Tile row r is box pixel (n0 + r / (box_w box_h), i0 + r / box_w %
      // box_h, j0 + r % box_w) of the class: its output pixel, or -1 where
      // the row lies beyond the class or the box.
      auto pixel = [&](int r) -> long long {
        const int n = d.n0 + r / box_rows;
        const int i = d.i0 + r / P.box_w % P.box_h, j = d.j0 + r % P.box_w;
        if (r >= box_rows * P.box_n || n >= P.N || i >= C.Hc ||
            j >= C.Wc) {
          return -1;
        }
        return ((long long)n * P.H + i * P.stride + C.ph) * P.W +
               j * P.stride + C.pw;
      };
      // Row of accumulator pair (acc[4 q + 2 h], acc[4 q + 2 h + 1]): 64
      // wg + 16 (warp % 4) + lane / 4 + 8 h; its columns 8 q + 2 (lane %
      // 4), + 1.
      if (P.parts > 1) {  // f32 partials, 32 bytes of a row per 4 lanes
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long px = pixel(rbase + 8 * h);
          if (px < 0) continue;
          float* dst = part + ((size_t)d.p * plane + px) * P.nch + d.ci0;
#pragma unroll
          for (int q = 0; q < BN / 8; ++q) {
            const int col = 8 * q + cbase;
            if (d.ci0 + col < P.nch) {
              *reinterpret_cast<float2*>(dst + col) =
                  make_float2(acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
            }
          }
        }
        continue;
      }
      // Rounded once to bf16 and staged, then 16-byte chunks of output
      // rows (through the epilogue for K5-conv); the first barrier waits
      // for the last tile's chunks to be read.
      named_sync(1, kConsumers);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int q = 0; q < BN / 8; ++q) {
          *reinterpret_cast<__nv_bfloat162*>(
              Cs + (rbase + 8 * h) * kCs + 8 * q + cbase) =
              __floats2bfloat162_rn(acc[4 * q + 2 * h],
                                    acc[4 * q + 2 * h + 1]);
        }
      }
      named_sync(1, kConsumers);
      constexpr int kChunks = BN / 8;
      for (int e = tid; e < kTileRows * kChunks; e += kConsumers) {
        const int r = e / kChunks, cc = (e - r * kChunks) * 8;
        const long long px = pixel(r);
        if (px < 0 || d.ci0 + cc >= P.nch) continue;
        const size_t idx = (size_t)px * P.nch + d.ci0 + cc;
        const uint4 u = *reinterpret_cast<const uint4*>(Cs + r * kCs + cc);
        if (kFwd) {
          float v[8];
          unpack8(u, v);
          *reinterpret_cast<uint4*>(out + idx) =
              epilogue8(v, bias, res, idx, d.ci0 + cc, relu);
        } else {
          *reinterpret_cast<uint4*>(out + idx) = u;
        }
      }
    }
  }
}

template <int BN, int BK>
__global__ void __launch_bounds__(kHopperThreads,
                                  gemm_pair(BN, BK, false) ? 2 : 1)
    dgrad_wgmma_kernel(const __grid_constant__ CUtensorMap dymap,
                       const __grid_constant__ CUtensorMap wmap,
                       bf16* __restrict__ dx, float* __restrict__ part,
                       const GemmParams P) {
  implicit_gemm<BN, BK, false>(dymap, wmap, dx, part, nullptr, nullptr, 0,
                               P);
}

template <int BN, int BK>
__global__ void __launch_bounds__(kHopperThreads,
                                  gemm_pair(BN, BK, true) ? 2 : 1)
    conv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      bf16* __restrict__ y, float* __restrict__ part,
                      const bf16* __restrict__ bias,
                      const bf16* __restrict__ res, int relu,
                      const GemmParams P) {
  implicit_gemm<BN, BK, true>(xmap, wmap, y, part, bias, res, relu, P);
}

// K5-conv's second pass where P > 1: y = the epilogue of the f32 partials
// (parts, M, Cout) summed in partition order and rounded once to bf16; a
// thread per 16-byte chunk of y.
__global__ void conv_reduce_kernel(const float* __restrict__ part,
                                   const bf16* __restrict__ bias,
                                   const bf16* __restrict__ res,
                                   bf16* __restrict__ y, int parts,
                                   long long n, int Cout, int relu) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t idx = (size_t)e * 8;
  if (e >= n / 8) return;
  float v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = 0.f;
  for (int p = 0; p < parts; ++p) {
    const float4* src =
        reinterpret_cast<const float4*>(part + (size_t)p * n + idx);
    const float4 a = src[0], b = src[1];
    v[0] += a.x; v[1] += a.y; v[2] += a.z; v[3] += a.w;
    v[4] += b.x; v[5] += b.y; v[6] += b.z; v[7] += b.w;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = rnd<bf16>(v[i]);
  *reinterpret_cast<uint4*>(y + idx) =
      epilogue8(v, bias, res, idx, (int)(idx % (size_t)Cout), relu);
}

// ---- K5-wgrad (bf16, Cin % 8 == 0): dw and dbias on wgmma ----------------
//
// Replaces: the weight and bias gradients of
// shapy_tpu/models/backbones/layers.py:91 conv2d (JAX autodiff). Bound on
// the H100: a train step's 331 calls at batch 48 do 2.315 TFLOP against
// 7.58 GB, 2.341 ms at 989 TFLOP/s: the tensor cores in sum; a call's K
// tiles each re-read its dy rows and its N tiles its im2col columns
// through L2. The design: a block's N tile holds all of Cout up to 256, so
// dy is read once per 128 K columns; 64-row stages on a 4-deep ring; row
// partitions that keep a persistent grid's tiles near two per SM.
// dw(co, kk) = sum over rows g of dy(g, co) x(g, kk), kk = (r, c, ci) the
// im2col column. wgmma's M side is kk (two 64-wide strips: a 128-column K
// tile), its N side BN output channels (all of Cout <= 256, else the
// largest dividing part), its depth 64 rows a stage: so dy is read once per
// K tile, and the 48-, 96- and 192-channel convs waste no column. Both
// operands are MN-major (the rows are the reduction):
//   * B, dy (64 rows x BN): TMA boxes of dy viewed as (N Ho Wo, Cout), 64
//     channels wide; with a ReLU mask (kMask) the producers load dy and the
//     saved output instead, zero dy where y <= 0, store it swizzled and, in
//     the blocks of the first K tile, write the masked dy once (dym);
//   * A, im2col(x) (64 rows x 128 kk): a cp.async gather (zero-fill), or
//     for a 1x1 stride-1 conv (kXTma) TMA boxes of x viewed as (N H W, Cin).
// Rows: the wrapper's fixed partitions (multiples of 64 rows); block (K
// tile, N tile, partition) writes an f32 partial and wgrad_reduce_kernel
// adds them in partition order, rounding once. dbias: with `pbias`, the
// consumer threads of the first K tile sum one channel each over the
// stage's dy rows, in row order within the partition.
struct WgradParams {
  int N, H, W, Cin, Ho, Wo, Cout, k, stride, pad, M, K;
  int rows_per_part, ktiles, ntiles, tiles;
  FastDiv howo, wo, cin;
};
constexpr int kWRows = 64;  // rows per stage: the wgmma depth of 4 k16 steps

constexpr int wgrad_smem_bytes(int bn) {
  return 1024 + kRing * (kStageA + ((bn + 63) / 64) * kWRows * 128) +
         2 * kRing * 8;
}

template <int BN, bool kMask, bool kXTma>
__global__ void __launch_bounds__(kHopperThreads, 1) wgrad_wgmma_kernel(
    const __grid_constant__ CUtensorMap dymap,
    const __grid_constant__ CUtensorMap xmap, const bf16* __restrict__ x,
    const bf16* __restrict__ dy, const bf16* __restrict__ ymask,
    bf16* __restrict__ dym, float* __restrict__ part,
    float* __restrict__ pbias, const WgradParams P) {
  static_assert(!(kMask && kXTma), "the masked route gathers x");
  constexpr int kBoxes = (BN + 63) / 64;
  constexpr int kBox = kWRows * 128;  // bytes of a 64 x 64 box
  constexpr int kStageB = kBoxes * kBox;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* As = smem;
  unsigned char* Bs = smem + kRing * kStageA;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + kRing * kStageB);
  uint64_t* empty = full + kRing;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(&full[i], 128 + 1);
      mbar_init(&empty[i], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile t: K tile t % ktiles (fastest: the tiles that share dy rows run
  // together), N tile (t / ktiles) % ntiles, row partition t / (ktiles
  // ntiles). A persistent grid, as K5-dgrad's.
  auto rows_of = [&](int t, int& r_begin, int& r_end) {
    const int p = t / (P.ktiles * P.ntiles);
    r_begin = p * P.rows_per_part;
    r_end = min(P.M, r_begin + P.rows_per_part);
    return p;
  };

  if (tid >= kConsumers) {
    // Producer: thread pt gathers kk chunk pt % 16 (8 columns of one tap)
    // of rows pt / 16 + 8 i.
    const int pt = tid - kConsumers, chunk = pt & 15;
    const int a_off = (chunk >> 3) * kBox;
    const uint32_t tx =
        (uint32_t)((kMask ? 0 : kStageB) + (kXTma ? kStageA : 0));
    int it = 0;
    for (int t = blockIdx.x; t < P.tiles; t += gridDim.x) {
      const int kk0 = (t % P.ktiles) * kTileRows;
      const int co0 = (t / P.ktiles % P.ntiles) * BN;
      int r_begin, r_end;
      rows_of(t, r_begin, r_end);
      const bool first = kk0 == 0;
      const int kk = kk0 + chunk * 8;
      const bool k_in = kk < P.K;
      int tap_r = 0, tap_c = 0, tap_ci = 0;
      if (k_in) {
        const int rc = fdiv(kk, P.cin);
        tap_ci = kk - rc * P.Cin;
        tap_r = rc / P.k;
        tap_c = rc - tap_r * P.k;
      }
      for (int g0 = r_begin; g0 < r_end; g0 += kWRows, ++it) {
        const int st = it % kRing;
        mbar_wait(&empty[st], ((it / kRing) & 1) ^ 1);
        unsigned char* a = As + st * kStageA;
        unsigned char* b = Bs + st * kStageB;
        if (pt == 0) {
          mbar_expect_tx(&full[st], tx);
          if (!kMask) {
#pragma unroll
            for (int j = 0; j < kBoxes; ++j) {
              tma_load_2d(b + j * kBox, &dymap, &full[st], co0 + 64 * j, g0);
            }
          }
          if (kXTma) {
            tma_load_2d(a, &xmap, &full[st], kk0, g0);
            tma_load_2d(a + kBox, &xmap, &full[st], kk0 + 64, g0);
          }
        }
        if (!kXTma) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int row = (pt >> 4) + 8 * i, g = g0 + row;
            bool ok = k_in && g < r_end;
            size_t src = 0;
            if (ok) {
              const int n = fdiv(g, P.howo), rem = g - n * P.Ho * P.Wo;
              const int ho = fdiv(rem, P.wo), wo = rem - ho * P.Wo;
              const int hi = ho * P.stride - P.pad + tap_r;
              const int wi = wo * P.stride - P.pad + tap_c;
              ok = hi >= 0 && hi < P.H && wi >= 0 && wi < P.W;
              src = ((size_t)(n * P.H + hi) * P.W + wi) * P.Cin + tap_ci;
            }
            cp_async16(a + a_off + sw128(row, chunk & 7), x + (ok ? src : 0),
                       ok);
          }
        }
        if (kMask) {
          // dy masked by y > 0 through registers, stored swizzled; the
          // copies above are waited for so that one plain arrival covers
          // all.
          constexpr int kChunks = BN / 8;
          for (int e = pt; e < kWRows * kChunks; e += 128) {
            const int row = e / kChunks, cc = e - row * kChunks;
            const int g = g0 + row, co = co0 + cc * 8;
            uint4 v = make_uint4(0, 0, 0, 0);
            if (g < r_end && co < P.Cout) {
              const size_t idx = (size_t)g * P.Cout + co;
              v = relu_mask8(*reinterpret_cast<const uint4*>(dy + idx),
                             *reinterpret_cast<const uint4*>(ymask + idx));
              if (first && dym) *reinterpret_cast<uint4*>(dym + idx) = v;
            }
            *reinterpret_cast<uint4*>(b + (cc >> 3) * kBox +
                                      sw128(row, cc & 7)) = v;
          }
          asm volatile("cp.async.wait_all;\n" ::: "memory");
          fence_async_shared();
          mbar_arrive(&full[st]);
        } else {
          cp_async_arrive(&full[st]);
        }
      }
    }
  } else {
    // Consumers: warpgroup wg multiplies kk rows 64 wg .. 64 wg + 63.
    const int wg = tid >> 7, lane = tid & 31;
    const int bcol = tid & 63, bbox = (tid >> 6) * kBox;
    int it = 0;
    for (int t = blockIdx.x; t < P.tiles; t += gridDim.x) {
      const int kk0 = (t % P.ktiles) * kTileRows;
      const int co0 = (t / P.ktiles % P.ntiles) * BN;
      int r_begin, r_end;
      const int p = rows_of(t, r_begin, r_end);
      const bool dbias = pbias && kk0 == 0 && tid < BN;
      float bsum = 0.f;
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int g0 = r_begin; g0 < r_end; g0 += kWRows, ++it) {
        const int st = it % kRing;
        mbar_wait(&full[st], (it / kRing) & 1);
        fence_async_shared();
        const unsigned char* a = As + st * kStageA + wg * kBox;
        const unsigned char* b = Bs + st * kStageB;
        if (dbias) {
          for (int r = 0; r < kWRows; ++r) {
            bsum += __bfloat162float(*reinterpret_cast<const bf16*>(
                b + bbox + sw128(r, bcol >> 3) + (bcol & 7) * 2));
          }
        }
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWRows / 16; ++kk) {
          Wgmma<BN, 1, 1>::mma(acc, sw128_desc(a + kk * 2048, kBox, 1024),
                               sw128_desc(b + kk * 2048, kBox, 1024));
        }
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();
        fence_acc(acc);
        if (g0 > r_begin) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[(it - 1) % kRing]);
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (r_end > r_begin) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % kRing]);
      }

      // acc[4 j + 2 h + e]: kk row 64 wg + 16 (warp % 4) + lane / 4 + 8 h,
      // channel 8 j + 2 (lane % 4) + e; partials are (parts, Cout, K).
      const int kr = kk0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
      const int cbase = co0 + 2 * (lane & 3);
      float* dst = part + (size_t)p * P.Cout * P.K;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kr_h = kr + 8 * h;
        if (kr_h >= P.K) continue;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int co = cbase + 8 * j;
          if (co < P.Cout) {
            dst[(size_t)co * P.K + kr_h] = acc[4 * j + 2 * h];
            dst[(size_t)(co + 1) * P.K + kr_h] = acc[4 * j + 2 * h + 1];
          }
        }
      }
      if (dbias && co0 + tid < P.Cout) {
        pbias[(size_t)p * P.Cout + co0 + tid] = bsum;
      }
    }
  }
}

ConvShape conv_shape(int N, int H, int W, int Cin, int Cout, int k,
                     int stride) {
  ConvShape s;
  s.N = N; s.H = H; s.W = W; s.Cin = Cin; s.Cout = Cout; s.k = k;
  s.stride = stride;
  s.pad = k / 2;
  s.Ho = (H + 2 * s.pad - k) / stride + 1;
  s.Wo = (W + 2 * s.pad - k) / stride + 1;
  s.M = N * s.Ho * s.Wo;
  s.K = k * k * Cin;
  s.istride = 1;
  return s;
}

// The second pass of K5-wgrad and K10's weight gradient: dw (Cout x CK /
// Cout) and dbias (with db) from the partials in partition order.
cudaError_t wgrad_reduce(const void* part, const void* pbias, void* dw,
                         void* db, int parts, int CK, int Cout, int dtype,
                         cudaStream_t st) {
  const int n = CK + (db ? Cout : 0);
  const int blocks = (n + 255) / 256;
  if (dtype == 0) {
    wgrad_reduce_kernel<float><<<blocks, 256, 0, st>>>(
        (const float*)part, (const float*)pbias, (float*)dw, (float*)db,
        parts, CK, Cout);
  } else {
    wgrad_reduce_kernel<bf16><<<blocks, 256, 0, st>>>(
        (const float*)part, (const float*)pbias, (bf16*)dw, (bf16*)db,
        parts, CK, Cout);
  }
  return cudaGetLastError();
}

// ---- Host side of the Hopper kernels ----------------------------------------

FastDiv fast_div(uint32_t d) {
  FastDiv f;
  f.shift = 0;
  while ((1ull << f.shift) < d) ++f.shift;
  f.mul = (uint32_t)(((1ull << 32) * ((1ull << f.shift) - d)) / d + 1);
  return f;
}

// cuTensorMapEncodeTiled, looked up at run time (no -lcuda). `steps`: the
// box's element strides (every steps[i]-th element along dimension i; the
// box then spans box[i] elements and loads box[i] / steps[i]), or NULL;
// `swizzle`: the 128-byte swizzle that wgmma's tiles take (a box row at
// most 128 bytes), or none (K10's patch rows).
cudaError_t encode_map(CUtensorMap* map, int rank, const void* base,
                       const cuuint64_t* dims, const cuuint64_t* strides,
                       const cuuint32_t* box,
                       const cuuint32_t* steps = nullptr,
                       CUtensorMapSwizzle swizzle =
                           CU_TENSOR_MAP_SWIZZLE_128B) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return cudaErrorNotSupported;
    }
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  // The encoding needs the device's context current on this host thread,
  // which the runtime binds only at its first call that needs one: an
  // autograd worker thread whose first call into CUDA is a backward's map
  // found none, and the map was refused. Bound once per thread
  // (cudaSetDevice makes the primary context current).
  thread_local bool bound = false;
  if (!bound) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaSetDevice(dev);
    if (err != cudaSuccess) return err;
    bound = true;
  }
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
      const_cast<void*>(base), dims, strides, box, steps ? steps : ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 2-D bf16 map of a row-major (rows, cols) matrix, boxes of 64 columns x
// `box_rows` rows.
cudaError_t encode_rows(CUtensorMap* map, const void* base, int rows, int cols,
                        int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return encode_map(map, 2, base, dims, strides, box);
}

// Sets a kernel's dynamic shared memory above 48 KB and finds how many of
// its blocks the device holds at once (SMs x blocks per SM), once per
// device: the size of its persistent grid.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int bytes, int* slots) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (slots[dev] > 0) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kHopperThreads, bytes);
  }
  if (err != cudaSuccess) return err;
  slots[dev] = sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

int device_index() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev;
}

template <int BN, int BK>
cudaError_t launch_dgrad(const CUtensorMap& dymap, const CUtensorMap& wmap,
                         const GemmParams& P, void* dx, float* part,
                         cudaStream_t st) {
  static int slots[kMaxDevices] = {};
  constexpr int bytes = gemm_bytes(BN, BK, false, gemm_stages(BN, BK, false));
  const cudaError_t err = prepare(dgrad_wgmma_kernel<BN, BK>, bytes, slots);
  if (err != cudaSuccess) return err;
  const int grid = P.tiles < slots[device_index()] ? P.tiles
                                                   : slots[device_index()];
  dgrad_wgmma_kernel<BN, BK><<<grid, kHopperThreads, bytes, st>>>(
      dymap, wmap, (bf16*)dx, part, P);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_dgrad_bk(int bk, const CUtensorMap& dymap,
                            const CUtensorMap& wmap, const GemmParams& P,
                            void* dx, float* part, cudaStream_t st) {
  switch (bk) {
    case 64: return launch_dgrad<BN, 64>(dymap, wmap, P, dx, part, st);
    case 48: return launch_dgrad<BN, 48>(dymap, wmap, P, dx, part, st);
    case 32: return launch_dgrad<BN, 32>(dymap, wmap, P, dx, part, st);
    default: return launch_dgrad<BN, 16>(dymap, wmap, P, dx, part, st);
  }
}

// The arguments of a K5-conv launch besides its maps and plan.
struct ConvArgs {
  const void *bias, *res;
  void *y;
  float* part;
  int relu;
};

template <int BN, int BK>
cudaError_t launch_conv(const CUtensorMap& xmap, const CUtensorMap& wmap,
                        const GemmParams& P, const ConvArgs& a,
                        cudaStream_t st) {
  static int slots[kMaxDevices] = {};
  constexpr int bytes = gemm_bytes(BN, BK, true, gemm_stages(BN, BK, true));
  const cudaError_t err = prepare(conv_wgmma_kernel<BN, BK>, bytes, slots);
  if (err != cudaSuccess) return err;
  const int grid = P.tiles < slots[device_index()] ? P.tiles
                                                   : slots[device_index()];
  conv_wgmma_kernel<BN, BK><<<grid, kHopperThreads, bytes, st>>>(
      xmap, wmap, (bf16*)a.y, a.part, (const bf16*)a.bias,
      (const bf16*)a.res, a.relu, P);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_conv_bk(int bk, const CUtensorMap& xmap,
                           const CUtensorMap& wmap, const GemmParams& P,
                           const ConvArgs& a, cudaStream_t st) {
  switch (bk) {
    case 64: return launch_conv<BN, 64>(xmap, wmap, P, a, st);
    case 48: return launch_conv<BN, 48>(xmap, wmap, P, a, st);
    default: return launch_conv<BN, 16>(xmap, wmap, P, a, st);
  }
}

// K5-conv on the wgmma core (bf16, Cin % 8 == 0): the maps, the plan's
// one class of k^2 unflipped taps, the launch and, for parts > 1, the
// reduce with the epilogue.
cudaError_t conv_wgmma(const ConvShape& s, const void* x, const void* w,
                       const ConvArgs& a, int bn, int bk, int box_n,
                       int box_h, int box_w, int parts, cudaStream_t st) {
  GemmParams P;
  P.N = s.N; P.H = s.Ho; P.W = s.Wo; P.nch = s.Cout;
  P.stride = 1;
  P.astride = s.stride;
  P.cchunks = (s.Cin + bk - 1) / bk;
  P.ntiles = (s.Cout + bn - 1) / bn;
  P.parts = parts;
  P.box_n = box_n; P.box_h = box_h; P.box_w = box_w;
  P.nclass = 1;
  GemmClass& c = P.cls[0];
  c.ph = 0; c.pw = 0; c.Hc = s.Ho; c.Wc = s.Wo; c.begin = 0;
  c.hblocks = (s.Ho + box_h - 1) / box_h;
  c.wblocks = (s.Wo + box_w - 1) / box_w;
  c.ntaps = s.k * s.k;
  for (int r = 0; r < s.k; ++r) {
    for (int cc = 0; cc < s.k; ++cc) {
      c.tap[r * s.k + cc] = (r * s.k + cc) | ((r - s.pad + 1) << 8) |
                            ((cc - s.pad + 1) << 12);
    }
  }
  const long long tiles = (long long)((s.N + box_n - 1) / box_n) *
                          c.hblocks * c.wblocks * P.ntiles * parts;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  P.tiles = (int)tiles;
  // x as (N, H, W, Cin): boxes of 64 ci x box_w x box_h x box_n output
  // pixels, every stride-th input pixel; the weight as (Cout, k^2, Cin):
  // boxes of 64 ci x 1 tap x bn co.
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[4] = {(cuuint64_t)s.Cin, (cuuint64_t)s.W,
                               (cuuint64_t)s.H, (cuuint64_t)s.N};
  const cuuint64_t xstrides[3] = {
      (cuuint64_t)s.Cin * sizeof(bf16),
      (cuuint64_t)s.W * s.Cin * sizeof(bf16),
      (cuuint64_t)s.H * s.W * s.Cin * sizeof(bf16)};
  const cuuint32_t xbox[4] = {64, (cuuint32_t)(box_w * s.stride),
                              (cuuint32_t)(box_h * s.stride),
                              (cuuint32_t)box_n};
  const cuuint32_t xsteps[4] = {1, (cuuint32_t)s.stride,
                                (cuuint32_t)s.stride, 1};
  cudaError_t err = encode_map(&xmap, 4, x, xdims, xstrides, xbox, xsteps);
  if (err != cudaSuccess) return err;
  const cuuint64_t wdims[3] = {(cuuint64_t)s.Cin, (cuuint64_t)(s.k * s.k),
                               (cuuint64_t)s.Cout};
  const cuuint64_t wstrides[2] = {(cuuint64_t)s.Cin * sizeof(bf16),
                                  (cuuint64_t)s.K * sizeof(bf16)};
  const cuuint32_t wbox[3] = {64, 1, (cuuint32_t)bn};
  err = encode_map(&wmap, 3, w, wdims, wstrides, wbox);
  if (err != cudaSuccess) return err;
  ConvArgs b = a;
  if (parts == 1) b.part = nullptr;
#define K5_CONV(BN) launch_conv_bk<BN>(bk, xmap, wmap, P, b, st)
  switch (bn) {
    case 48: err = K5_CONV(48); break;
    case 64: err = K5_CONV(64); break;
    case 96: err = K5_CONV(96); break;
    case 128: err = K5_CONV(128); break;
    case 192: err = K5_CONV(192); break;
    default: err = K5_CONV(256); break;
  }
#undef K5_CONV
  if (err != cudaSuccess || parts == 1) return err;
  const long long n = (long long)s.M * s.Cout;
  const long long chunks = n / 8;
  conv_reduce_kernel<<<(int)((chunks + 255) / 256), 256, 0, st>>>(
      a.part, (const bf16*)a.bias, (const bf16*)a.res, (bf16*)a.y, parts, n,
      s.Cout, a.relu);
  return cudaGetLastError();
}

template <int BN, bool kMask, bool kXTma>
cudaError_t launch_wgrad(const CUtensorMap& dymap, const CUtensorMap& xmap,
                         const WgradParams& P, const void* x, const void* dy,
                         const void* y, void* dym, float* part, float* pbias,
                         cudaStream_t st) {
  static int slots[kMaxDevices] = {};
  constexpr int bytes = wgrad_smem_bytes(BN);
  const cudaError_t err =
      prepare(wgrad_wgmma_kernel<BN, kMask, kXTma>, bytes, slots);
  if (err != cudaSuccess) return err;
  const int grid = P.tiles < slots[device_index()] ? P.tiles
                                                   : slots[device_index()];
  wgrad_wgmma_kernel<BN, kMask, kXTma><<<grid, kHopperThreads, bytes, st>>>(
      dymap, xmap, (const bf16*)x, (const bf16*)dy, (const bf16*)y,
      (bf16*)dym, part, pbias, P);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_wgrad_any(const CUtensorMap& dymap,
                             const CUtensorMap& xmap, const WgradParams& P,
                             bool xtma, const void* x, const void* dy,
                             const void* y, void* dym, float* part,
                             float* pbias, cudaStream_t st) {
  if (y != nullptr) {
    return launch_wgrad<BN, true, false>(dymap, xmap, P, x, dy, y, dym, part,
                                         pbias, st);
  }
  if (xtma) {
    return launch_wgrad<BN, false, true>(dymap, xmap, P, x, dy, y, dym, part,
                                         pbias, st);
  }
  return launch_wgrad<BN, false, false>(dymap, xmap, P, x, dy, y, dym, part,
                                        pbias, st);
}

// ---- K10's forward: the ResNet's 7x7 / stride-2 stem, bf16, 64 channels --
//
// A warp takes a group of 32 output pixels of one output row at a time,
// from a persistent grid (the plan's; a group (n, ho, wo0) is number (n Ho
// + ho) ceil(Wo / 32) + wo0 / 32). The group's patch is the 7 input rows
// 2 ho - 3 .. 2 ho + 3 at the halves 6 wo0 - 9 .. 6 wo0 + 206 of a row (3 W
// halves, NHWC with 3 channels), which pixel m reads at 6m + j of row r
// for K element (r, j). Staged regime (rows of 6 W bytes, a multiple of
// 16): the group's 7 x 224 box comes by one TMA copy of a 3-D map over (3
// W halves, H, N) whose zero fill out of bounds is the pad-3 zeros, per
// image, into a ring of kStemStages boxes a warp, each completed on its
// own mbarrier, so that the next group's rows land while this group's
// products run. A TMA box starts on a 16-byte boundary (an odd start
// traps), so it starts at 6 wo0 - 16, 7 halves before the patch; the warp
// moves the landed box 7 halves down in place (two 16-byte loads, four
// byte permutes and a store a chunk), so that every K pair (j, j + 1) of
// the mma's A fragment is one aligned 32-bit load. Direct regime (other
// rows, which TMA cannot map): the warp copies its patch a 2-byte load an
// element. The weight, 64 x 168 in that K order (zero past each row's
// 21), is staged once a block from 16-byte loads and read by ldmatrix.
// The products are mma.sync m16n8k16 in eleven K steps in order, f32
// sums, then the epilogue (the folded BN's bias and the ReLU, or none) in
// bf16 pairs into a 32-pixel x 128-byte tile in the 128-byte swizzle
// (chunk c of pixel m at c ^ (m % 8): no bank conflicts), which one TMA
// store writes out (the pixels past Wo clipped).
constexpr int kStemSteps = (kStemRows * kStemJ + 15) / 16;  // 11 k16 steps
constexpr int kStemWLd = kStemSteps * 16 + 8;   // halves a weight row
constexpr int kStemGroup = 32;                  // output pixels a warp's group
constexpr int kStemShift = 7;                   // the patch's first half
constexpr int kStemBox = 6 * kStemGroup + 32;   // halves a box row (224)
constexpr int kStemBoxBytes = 3200;             // 7 x 224 halves, to 128 B
constexpr int kStemStages = 2;                  // boxes a warp's ring
constexpr int kStemWarps = 4;                   // warps a block
constexpr int kStemOutBytes = kStemGroup * 128;  // the swizzled output tile
constexpr int kStemWBytes = 24 * 1024;          // 64 x 184 halves, to 1 KB
// A warp's part: its output tile (1024-byte aligned, as the swizzle
// wants), its boxes, its mbarriers.
constexpr int kStemWarpBytes = 11 * 1024;
constexpr int kStemBytes = 1024 + kStemWBytes + kStemWarps * kStemWarpBytes;
static_assert(kStemRows * kStemBox * 2 <= kStemBoxBytes, "box");
static_assert(kStemShift == 7 && kStemBox % 8 == 0,
              "the move takes a chunk's last half and the next one's first 7");
static_assert(64 * kStemWLd * 2 <= kStemWBytes, "weight");
static_assert(kStemOutBytes + kStemStages * kStemBoxBytes + 8 * kStemStages <=
                  kStemWarpBytes,
              "warp");

// max(v, 0) of two bf16 values as v < 0 ? 0 : v: -0 and NaN kept.
__device__ __forceinline__ __nv_bfloat162 relu2(__nv_bfloat162 v) {
  const unsigned m = __hlt2_mask(v, __float2bfloat162_rn(0.f));
  unsigned u = *reinterpret_cast<const unsigned*>(&v) & ~m;
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_read_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

template <bool kTma>
__global__ void __launch_bounds__(32 * kStemWarps) stem7_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap ymap, const bf16* __restrict__ x,
    const bf16* __restrict__ w, const bf16* __restrict__ bias, ConvShape s,
    int relu, int groups) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* const Ws = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* const out = smem + kStemWBytes + warp * kStemWarpBytes;
  unsigned char* const boxes = out + kStemOutBytes;
  uint64_t* const full =
      reinterpret_cast<uint64_t*>(boxes + kStemStages * kStemBoxBytes);
  const bf16 zero = __float2bfloat16_rn(0.f);
  const int gw = blockIdx.x * kStemWarps + warp;
  const int nw = gridDim.x * kStemWarps;
  const int count = gw < groups ? (groups - gw + nw - 1) / nw : 0;
  const int wgroups = (s.Wo + kStemGroup - 1) / kStemGroup;
  auto locate = [&](int k, int* n, int* ho, int* wo0) {
    const int grp = gw + k * nw;
    *wo0 = grp % wgroups * kStemGroup;
    *ho = grp / wgroups % s.Ho;
    *n = grp / wgroups / s.Ho;
  };
  // Lane 0: the box of this warp's k-th group into its stage.
  auto issue = [&](int k) {
    int n, ho, wo0;
    locate(k, &n, &ho, &wo0);
    uint64_t* const bar = &full[k % kStemStages];
    mbar_expect_tx(bar, kStemRows * kStemBox * 2);
    tma_load_3d(boxes + (k % kStemStages) * kStemBoxBytes, &xmap, bar,
                6 * wo0 - 9 - kStemShift, 2 * ho - 3, n);
  };
  if constexpr (kTma) {
    if (lane == 0) {
      for (int i = 0; i < kStemStages; ++i) mbar_init(&full[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int k = 0; k < kStemStages - 1 && k < count; ++k) issue(k);
    }
  }
  // The weight (OHWI: 64 rows of 147) as Ws[n][24 r + j]: the pads zeroed,
  // then 16-byte loads, all in flight at once, scattered.
  for (int e = tid; e < 64 * kStemWLd; e += 32 * kStemWarps) {
    const int k = e % kStemWLd;
    if (k >= kStemRows * kStemJ || k % kStemJ >= 21) Ws[e] = zero;
  }
  {
    constexpr int kChunks = 64 * 147 / 8;
    constexpr int kPer = (kChunks + 32 * kStemWarps - 1) / (32 * kStemWarps);
    uint4 v[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = tid + i * 32 * kStemWarps;
      if (c < kChunks) v[i] = reinterpret_cast<const uint4*>(w)[c];
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = tid + i * 32 * kStemWarps;
      if (c >= kChunks) continue;
      const bf16* h = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = 8 * c + u, n = e / 147, q = e - 147 * n;
        const int r = q / 21;
        Ws[n * kStemWLd + r * kStemJ + q - 21 * r] = h[u];
      }
    }
  }
  __nv_bfloat162 bb[8];  // this lane's channels' bias, in pairs
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    bb[nt] = bias ? *reinterpret_cast<const __nv_bfloat162*>(
                        bias + nt * 8 + 2 * t)
                  : __float2bfloat162_rn(0.f);
  }
  __syncthreads();

  for (int k = 0; k < count; ++k) {
    int n, ho, wo0;
    locate(k, &n, &ho, &wo0);
    bf16* const P =
        reinterpret_cast<bf16*>(boxes + (k % kStemStages) * kStemBoxBytes);
    if constexpr (kTma) {
      // The stage of group k - 1, whose reads ended at its last
      // __syncwarp, takes group k + kStemStages - 1.
      if (lane == 0 && k + kStemStages - 1 < count) {
        issue(k + kStemStages - 1);
      }
      mbar_wait(&full[k % kStemStages], (k / kStemStages) & 1);
      // The box moved kStemShift halves down, in place: chunk c of each
      // row from halves 8c + 7 .. 8c + 14 (all loads before any store).
      constexpr int kRowChunks = kStemBox / 8, kOut = kRowChunks - 1;
      constexpr int kPer = (kStemRows * kOut + 31) / 32;
      uint4 moved[kPer];
      uint4* const P4 = reinterpret_cast<uint4*>(P);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = lane + 32 * i;
        if (e >= kStemRows * kOut) continue;
        const int r = e / kOut, c = e - r * kOut;
        const uint4 lo = P4[r * kRowChunks + c];
        const uint4 hi = P4[r * kRowChunks + c + 1];
        moved[i] = make_uint4(__byte_perm(lo.w, hi.x, 0x5432),
                              __byte_perm(hi.x, hi.y, 0x5432),
                              __byte_perm(hi.y, hi.z, 0x5432),
                              __byte_perm(hi.z, hi.w, 0x5432));
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = lane + 32 * i;
        if (e >= kStemRows * kOut) continue;
        const int r = e / kOut;
        P4[r * kRowChunks + e - r * kOut] = moved[i];
      }
      __syncwarp();
    } else {
      const long long row = 3LL * s.W;
      for (int e = lane; e < kStemRows * kStemBox; e += 32) {
        const int r = e / kStemBox, q = e - r * kStemBox;
        const int hi = 2 * ho - 3 + r;
        const long long c = 6LL * wo0 - 9 + q;
        P[e] = hi >= 0 && hi < s.H && c >= 0 && c < row
                   ? x[((long long)n * s.H + hi) * row + c]
                   : zero;
      }
      __syncwarp();
    }
    float acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
#pragma unroll
    for (int step = 0; step < kStemSteps; ++step) {
      // This lane's K pairs k and k + 8; past K (row 7) the weight is
      // zero, so the box is read at row 6 instead of past its end.
      const int k0 = 16 * step + 2 * t, k1 = k0 + 8;
      const int o0 = min(k0 / kStemJ, kStemRows - 1) * kStemBox + k0 % kStemJ;
      const int o1 = min(k1 / kStemJ, kStemRows - 1) * kStemBox + k1 % kStemJ;
      unsigned a[2][4], b[8][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int m = mt * 16 + g;
        a[mt][0] = *reinterpret_cast<const unsigned*>(&P[o0 + 6 * m]);
        a[mt][1] = *reinterpret_cast<const unsigned*>(&P[o0 + 6 * m + 48]);
        a[mt][2] = *reinterpret_cast<const unsigned*>(&P[o1 + 6 * m]);
        a[mt][3] = *reinterpret_cast<const unsigned*>(&P[o1 + 6 * m + 48]);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned r[4];
        ldmatrix_x4(r, &Ws[((2 * np + (lane >> 4)) * 8 + (lane & 7)) *
                               kStemWLd +
                           16 * step + ((lane >> 3) & 1) * 8]);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
    // The last group's store has read the tile (long since: a group's
    // products ran in between).
    if (lane == 0) bulk_read_wait();
    __syncwarp();
    // The epilogue into the tile, two channels at once in bf16: the sums
    // rounded, the bias added and rounded once (as epilogue<bf16>'s f32
    // add and rounding: the f32 sum of two bf16 values rounds to the same
    // bf16), the ReLU (-0 kept, as v < 0 ? 0 : v keeps it).
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = mt * 16 + g + 8 * half;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
          if (bias) v = __hadd2(v, bb[nt]);
          if (relu) v = relu2(v);
          *reinterpret_cast<__nv_bfloat162*>(
              out + m * 128 + ((nt ^ (m & 7)) << 4) + 4 * t) = v;
        }
      }
    }
    fence_async_shared();  // the tile's writes, seen by the bulk store
    __syncwarp();          // the box's reads done too: it may be refilled
    if (lane == 0) tma_store_3d(&ymap, out, 0, wo0, n * s.Ho + ho);
  }
  if (lane == 0) bulk_read_wait();
}

// K10's forward on the plan's regime and persistent grid.
cudaError_t launch_stem7(const ConvShape& s, const void* x, const void* w,
                         const void* bias, void* y, int relu, bool staged,
                         int grid, cudaStream_t st) {
  static bool configured[2][kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !configured[staged][dev]) {
    err = cudaFuncSetAttribute(
        staged ? stem7_kernel<true> : stem7_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kStemBytes);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) configured[staged][dev] = true;
  }
  CUtensorMap xmap, ymap;
  memset(&xmap, 0, sizeof(xmap));
  if (staged) {
    // (3 W halves, H rows, N images); one box: 224 halves x 7 rows.
    const cuuint64_t dims[3] = {(cuuint64_t)3 * s.W, (cuuint64_t)s.H,
                                (cuuint64_t)s.N};
    const cuuint64_t strides[2] = {(cuuint64_t)6 * s.W,
                                   (cuuint64_t)6 * s.W * s.H};
    const cuuint32_t box[3] = {kStemBox, kStemRows, 1};
    err = encode_map(&xmap, 3, x, dims, strides, box, nullptr,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return err;
  }
  {
    // y as (64 channels, Wo pixels, Ho N rows); one box: a group's 32
    // pixels of a row, in the 128-byte swizzle.
    const cuuint64_t dims[3] = {64, (cuuint64_t)s.Wo,
                                (cuuint64_t)s.Ho * s.N};
    const cuuint64_t strides[2] = {128, (cuuint64_t)128 * s.Wo};
    const cuuint32_t box[3] = {64, kStemGroup, 1};
    err = encode_map(&ymap, 3, y, dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  const int groups = s.N * s.Ho * ((s.Wo + kStemGroup - 1) / kStemGroup);
  if (staged) {
    stem7_kernel<true><<<grid, 32 * kStemWarps, kStemBytes, st>>>(
        xmap, ymap, (const bf16*)x, (const bf16*)w, (const bf16*)bias, s,
        relu, groups);
  } else {
    stem7_kernel<false><<<grid, 32 * kStemWarps, kStemBytes, st>>>(
        xmap, ymap, (const bf16*)x, (const bf16*)w, (const bf16*)bias, s,
        relu, groups);
  }
  return cudaGetLastError();
}

// The wgmma widths the kernels are built for.
bool wgmma_n(int bn) {
  return bn == 48 || bn == 64 || bn == 96 || bn == 128 || bn == 192 ||
         bn == 256;
}

}  // namespace

// x (N, H, W, Cin) and y (N, Ho, Wo, Cout) NHWC, w (Cout, k, k, Cin) OHWI,
// bias (Cout,) or NULL, residual like y or NULL; dtype 0 = float32, 1 =
// bfloat16 for all of them. k in {1, 3} with padding k / 2, stride >= 1;
// Cout % 8 == 0; y and residual 16-byte aligned.
//   * bf16 with bn > 0: the wgmma kernel (Cin % 8 == 0, stride 1 or 2, x
//     and w 16-byte aligned) with N tile bn (a wgmma width), K step bk
//     (64, 48 or 16 channels of Cin; the boxes zero-fill past Cin), the M
//     tile's box of output pixels (box_n, box_h, box_w; at most 128) and
//     parts K partitions, all from the caller's plan; with parts > 1, part is parts x N Ho Wo Cout f32 scratch
//     and a second pass sums it in partition order and runs the epilogue.
//   * bf16 with bn == 0: the stem's mma.sync kernel (any Cin).
//   * f32: the CUDA-core kernel; bn, bk, the box and parts are not read.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for what it does
// not take or a tensor map that cuTensorMapEncodeTiled refuses.
extern "C" int conv2d_act_forward(const void* x, const void* w,
                                  const void* bias, const void* residual,
                                  void* y, void* part, int N, int H, int W,
                                  int Cin, int Cout, int k, int stride,
                                  int relu, int dtype, int bn, int bk,
                                  int box_n, int box_h, int box_w, int parts,
                                  void* stream) {
  const ConvShape s = conv_shape(N, H, W, Cin, Cout, k, stride);
  if (s.M == 0 || Cout == 0) return (int)cudaSuccess;
  if (Cout % 8 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    const dim3 grid((s.M + kTile - 1) / kTile, (Cout + kTile - 1) / kTile);
    conv_f32_kernel<<<grid, kThreadsF32, 0, st>>>(
        (const float*)x, (const float*)w, (const float*)bias,
        (const float*)residual, (float*)y, s, relu);
    return (int)cudaGetLastError();
  }
  if (bn == 0) {
    return (int)launch_stem_any(s, x, w, bias, residual, y, relu, st);
  }
  if (Cin % 8 != 0 || (stride != 1 && stride != 2) || (k != 1 && k != 3) ||
      !wgmma_n(bn) || (bk != 64 && bk != 48 && bk != 16) || parts < 1 ||
      (parts > 1 && part == nullptr) ||
      box_n < 1 || box_h < 1 || box_w < 1 ||
      box_n * box_h * box_w > kTileRows) {
    return (int)cudaErrorInvalidValue;
  }
  ConvArgs a;
  a.bias = bias;
  a.res = residual;
  a.y = y;
  a.part = (float*)part;
  a.relu = relu;
  return (int)conv_wgmma(s, x, w, a, bn, bk, box_n, box_h, box_w, parts,
                         st);
}

// K5-dgrad: dx (N, H, W, Cin) = the data gradient of the conv above from dy
// (N, Ho, Wo, Cout), NHWC, all 16-byte aligned, Cin % 8 == 0 and Cout % 8
// == 0, stride 1 or 2.
//   * bf16 (dtype 1): w is the conv's weight (Cout, k, k, Cin), read in
//     place by the parity-class wgmma kernel above; bn its N tile (a wgmma
//     width), bk its K step (64, 48, 32 or 16 channels of Cout), (box_n,
//     box_h, box_w) its M tile's box of a class's pixels (at most 128),
//     parts its K partitions, all from the caller's plan; with parts > 1,
//     part is parts x N H W Cin f32 scratch and a second pass adds the
//     partials in partition order.
//   * f32 (dtype 0): w is the weight flipped in (kh, kw) and transposed,
//     (Cin, k, k, Cout); the f32 forward kernel runs on dy with stride 1,
//     padding k - 1 - k / 2 and input stride `stride` (a gather per dx
//     pixel); bn, bk and parts are not read.
// f32 sums, rounded once; no epilogue. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for what it does not take or a tensor map that
// cuTensorMapEncodeTiled refuses.
extern "C" int conv2d_dgrad(const void* dy, const void* w, void* dx,
                            void* part, int N, int H, int W, int Cin,
                            int Cout, int k, int stride, int dtype, int bn,
                            int bk, int box_n, int box_h, int box_w,
                            int parts, void* stream) {
  const ConvShape f = conv_shape(N, H, W, Cin, Cout, k, stride);
  if ((long long)N * H * W == 0 || Cin == 0) return (int)cudaSuccess;
  if (Cin % 8 != 0 || Cout % 8 != 0 || (stride != 1 && stride != 2) ||
      (k != 1 && k != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    ConvShape s;
    s.N = N; s.H = f.Ho; s.W = f.Wo; s.Cin = Cout;
    s.Ho = H; s.Wo = W; s.Cout = Cin; s.k = k;
    s.stride = 1;
    s.pad = k - 1 - f.pad;
    s.istride = stride;
    s.M = N * H * W;
    s.K = k * k * Cout;
    const dim3 grid((s.M + kTile - 1) / kTile, (Cin + kTile - 1) / kTile);
    conv_f32_kernel<<<grid, kThreadsF32, 0, st>>>(
        (const float*)dy, (const float*)w, nullptr, nullptr, (float*)dx, s,
        0);
    return (int)cudaGetLastError();
  }
  if (!wgmma_n(bn) || (bk != 64 && bk != 48 && bk != 32 && bk != 16) ||
      parts < 1 || (parts > 1 && part == nullptr) || box_n < 1 ||
      box_h < 1 || box_w < 1 || box_n * box_h * box_w > kTileRows) {
    return (int)cudaErrorInvalidValue;
  }
  GemmParams P;
  P.N = N; P.H = H; P.W = W; P.nch = Cin;
  P.stride = stride;
  P.astride = 1;
  P.cchunks = (Cout + bk - 1) / bk;
  P.ntiles = (Cin + bn - 1) / bn;
  P.parts = parts;
  P.box_n = box_n;
  P.box_h = box_h;
  P.box_w = box_w;
  // The parity classes, most taps first (stable), empty ones dropped.
  P.nclass = 0;
  for (int want = k * k; want >= 0; --want) {
    for (int ph = 0; ph < stride; ++ph) {
      for (int pw = 0; pw < stride; ++pw) {
        GemmClass c;
        c.ph = ph; c.pw = pw;
        c.Hc = (H - ph + stride - 1) / stride;
        c.Wc = (W - pw + stride - 1) / stride;
        c.hblocks = (c.Hc + box_h - 1) / box_h;
        c.wblocks = (c.Wc + box_w - 1) / box_w;
        c.ntaps = 0;
        for (int r = 0; r < k; ++r) {
          for (int cc = 0; cc < k; ++cc) {
            const int th = ph + f.pad - r, tw = pw + f.pad - cc;
            if (((th % stride) + stride) % stride != 0 ||
                ((tw % stride) + stride) % stride != 0) {
              continue;
            }
            c.tap[c.ntaps++] = (r * k + cc) | ((th / stride + 1) << 8) |
                               ((tw / stride + 1) << 12);
          }
        }
        if (c.ntaps != want || c.Hc <= 0 || c.Wc <= 0) continue;
        P.cls[P.nclass++] = c;
      }
    }
  }
  long long tiles = 0;
  for (int i = 0; i < P.nclass; ++i) {
    P.cls[i].begin = (int)tiles;
    tiles += (long long)((N + box_n - 1) / box_n) * P.cls[i].hblocks *
             P.cls[i].wblocks * P.ntiles * parts;
  }
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  P.tiles = (int)tiles;
  // The weight as (Cout, k^2, Cin): boxes of 64 ci x 1 tap x bk co; dy as
  // (N, Ho, Wo, Cout): boxes of 64 co x box_w x box_h x box_n pixels.
  CUtensorMap wmap, dymap;
  const cuuint64_t dims[3] = {(cuuint64_t)Cin, (cuuint64_t)(k * k),
                              (cuuint64_t)Cout};
  const cuuint64_t strides[2] = {(cuuint64_t)Cin * sizeof(bf16),
                                 (cuuint64_t)k * k * Cin * sizeof(bf16)};
  const cuuint32_t box[3] = {64, 1, (cuuint32_t)bk};
  cudaError_t err = encode_map(&wmap, 3, w, dims, strides, box);
  if (err != cudaSuccess) return (int)err;
  const cuuint64_t ddims[4] = {(cuuint64_t)Cout, (cuuint64_t)f.Wo,
                               (cuuint64_t)f.Ho, (cuuint64_t)N};
  const cuuint64_t dstrides[3] = {
      (cuuint64_t)Cout * sizeof(bf16),
      (cuuint64_t)f.Wo * Cout * sizeof(bf16),
      (cuuint64_t)f.Ho * f.Wo * Cout * sizeof(bf16)};
  const cuuint32_t dbox[4] = {64, (cuuint32_t)box_w, (cuuint32_t)box_h,
                              (cuuint32_t)box_n};
  err = encode_map(&dymap, 4, dy, ddims, dstrides, dbox);
  if (err != cudaSuccess) return (int)err;
  float* out = parts > 1 ? (float*)part : nullptr;
#define K5_DGRAD(BN) launch_dgrad_bk<BN>(bk, dymap, wmap, P, dx, out, st)
  switch (bn) {
    case 48: err = K5_DGRAD(48); break;
    case 64: err = K5_DGRAD(64); break;
    case 96: err = K5_DGRAD(96); break;
    case 128: err = K5_DGRAD(128); break;
    case 192: err = K5_DGRAD(192); break;
    default: err = K5_DGRAD(256); break;
  }
#undef K5_DGRAD
  if (err != cudaSuccess || parts == 1) return (int)err;
  const long long n = (long long)N * H * W * Cin;
  wgrad_reduce_kernel<bf16><<<(int)((n + 255) / 256), 256, 0, st>>>(
      (const float*)part, nullptr, (bf16*)dx, nullptr, parts, (int)n, 0);
  return (int)cudaGetLastError();
}

// K5-wgrad: dw (Cout, k, k, Cin) OHWI = sum over (n, ho, wo) of dy (x)
// im2col(x), and dbias (Cout,) = sum of dy when db is not NULL, both in
// x's dtype, for x (N, H, W, Cin) and dy (N, Ho, Wo, Cout) NHWC. With y
// (like dy, the conv's saved output) the ReLU mask y > 0 is applied as dy
// is read and the masked dy is written to dym. part: parts x Cout x K f32
// scratch, pbias parts x Cout (with db); parts x rows_per_part >= N Ho Wo.
// vec (bf16): Cin % 8 == 0 and x 16-byte aligned: the wgmma kernel with
// N tile bn (a wgmma width) and rows_per_part a multiple of 64; else
// (the stem's Cin = 3, and f32) rows_per_part a multiple of 32. Cout % 8
// == 0, dy / y / dym 16-byte aligned. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for what it does not take or a tensor map that
// cuTensorMapEncodeTiled refuses.
extern "C" int conv2d_wgrad(const void* x, const void* dy, const void* y,
                            void* dym, void* part, void* pbias, void* dw,
                            void* db, int N, int H, int W, int Cin,
                            int Cout, int k, int stride, int parts,
                            int rows_per_part, int vec, int dtype, int bn,
                            void* stream) {
  const ConvShape s = conv_shape(N, H, W, Cin, Cout, k, stride);
  const bool hopper = dtype == 1 && vec;
  if (Cout % 8 != 0 || (vec && Cin % 8 != 0) ||
      rows_per_part % (hopper ? kWRows : kWR) != 0 ||
      (long long)parts * rows_per_part < s.M || (db == nullptr) !=
      (pbias == nullptr) || (y == nullptr) != (dym == nullptr) ||
      (hopper && !wgmma_n(bn))) {
    return (int)cudaErrorInvalidValue;
  }
  if (Cout == 0 || s.K == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (hopper) {
    WgradParams P;
    P.N = N; P.H = H; P.W = W; P.Cin = Cin; P.Ho = s.Ho; P.Wo = s.Wo;
    P.Cout = Cout; P.k = k; P.stride = stride; P.pad = s.pad; P.M = s.M;
    P.K = s.K;
    P.rows_per_part = rows_per_part;
    P.howo = fast_div((uint32_t)(s.Ho * s.Wo));
    P.wo = fast_div((uint32_t)s.Wo);
    P.cin = fast_div((uint32_t)Cin);
    const bool xtma = k == 1 && stride == 1 && y == nullptr;
    CUtensorMap dymap, xmap;
    err = encode_rows(&dymap, dy, s.M, Cout, kWRows);
    if (err == cudaSuccess) {
      err = xtma ? encode_rows(&xmap, x, s.M, Cin, kWRows) : cudaSuccess;
      if (!xtma) xmap = dymap;  // not read
    }
    if (err != cudaSuccess) return (int)err;
    P.ktiles = (s.K + kTileRows - 1) / kTileRows;
    P.ntiles = (Cout + bn - 1) / bn;
    P.tiles = P.ktiles * P.ntiles * parts;
#define K5_WGRAD(BN)                                                  \
  launch_wgrad_any<BN>(dymap, xmap, P, xtma, x, dy, y, dym, (float*)part, \
                       (float*)pbias, st)
    switch (bn) {
      case 48: err = K5_WGRAD(48); break;
      case 64: err = K5_WGRAD(64); break;
      case 96: err = K5_WGRAD(96); break;
      case 128: err = K5_WGRAD(128); break;
      case 192: err = K5_WGRAD(192); break;
      default: err = K5_WGRAD(256); break;
    }
#undef K5_WGRAD
  } else {
    const dim3 grid((Cout + kWT - 1) / kWT, (s.K + kWT - 1) / kWT, parts);
    if (dtype == 0) {
      wgrad_f32_kernel<<<grid, kThreadsF32, 0, st>>>(
          (const float*)x, (const float*)dy, (const float*)y, (float*)dym,
          (float*)part, (float*)pbias, s, rows_per_part);
    } else {
      wgrad_bf16_scalar_kernel<<<grid, kThreadsMma, 0, st>>>(
          (const bf16*)x, (const bf16*)dy, (const bf16*)y, (bf16*)dym,
          (float*)part, (float*)pbias, s, rows_per_part);
    }
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  return (int)wgrad_reduce(part, pbias, dw, db, parts, Cout * s.K, Cout,
                           dtype, st);
}

// The ReLU mask of K5-conv's backward without K5-wgrad: dym = dy (y > 0)
// for n elements of dy, y and dym, dtype 0 = float32 or 1 = bfloat16.
// Returns cudaGetLastError().
extern "C" int conv2d_relu_mask(const void* dy, const void* y, void* dym,
                                int n, int dtype, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const long long want = ((long long)n + 255) / 256;
  const int blocks = (int)(want < 65535 * 8 ? want : 65535 * 8);
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    relu_mask_kernel<float><<<blocks, 256, 0, st>>>(
        (const float*)dy, (const float*)y, (float*)dym, n);
  } else {
    relu_mask_kernel<bf16><<<blocks, 256, 0, st>>>(
        (const bf16*)dy, (const bf16*)y, (bf16*)dym, n);
  }
  return (int)cudaGetLastError();
}

// The dynamic shared memory (bytes) of a wgmma kernel, and the blocks an
// SM holds by it (1 or 2), as out[0], out[1]: kind 1 K5-dgrad's for N tile
// bn and K step bk, kind 2 K5-conv's, kind 0 K5-wgrad's for N tile bn.
extern "C" int conv2d_wgmma_smem(int kind, int bn, int bk, int* out) {
  if (kind != 0) {
    const bool fwd = kind == 2;
    out[0] = gemm_bytes(bn, bk, fwd, gemm_stages(bn, bk, fwd));
    out[1] = gemm_pair(bn, bk, fwd) ? 2 : 1;
  } else {
    out[0] = wgrad_smem_bytes(bn);
    out[1] = 1;
  }
  return 0;
}

// ---- K10: the ResNet's 7x7 stem --------------------------------------------
//
// Replaces: shapy_tpu/models/backbones/resnet.py:54, conv_bn_relu(...,
// "conv1", "bn1", images, 64, 7, 2, 3): layers.py:91 conv2d with k = 7,
// stride 2, pad 3 on the 3 image channels (with fold_bn in eval), its ReLU,
// and its weight gradient in training (the images take no data gradient).
// What bounds it on the H100: bytes at batch 32 (x 12.6 MB + y 67.1 MB:
// 0.024 ms at 3.35 TB/s), with the tensor work close behind (11.8 GFLOP
// over the 176 K slots, 147 of them taps: 0.012 ms at 989 TFLOP/s, but
// mma.sync runs well below that rate), so the two must overlap.
// Design: the forward in bf16 at stride 2 and 64 output channels (the
// ResNet's) is stem7_kernel above: a warp a group of 32 output pixels, its
// input box landing by TMA (pad 3 as the map's zero fill) in a 2-deep
// mbarrier ring while the warp's products of the group before run, K = 7
// x 7 x 3 = 147 laid out as 7 rows of 24 (zero weights past each row's 21
// and past K, so no tap is read out of bounds) in eleven 16-deep mma.sync
// steps, the sums and their order those of the kernel it replaced; the
// epilogue is the 3x3 stem's (bias of the folded BN, ReLU) or none
// (training), in bf16 pairs into a swizzled shared tile that a TMA store
// writes out. Rows that TMA cannot map (3 W % 8 != 0) take the direct
// regime, the warp copying its box; 396 blocks of 4 warps, three an SM
// (70.7 KB of shared memory and 168 registers a thread each). Other shapes and f32 take the general stem kernels with k = 7 read
// from the shape. The weight gradient in bf16 at that shape is
// stem7_wgrad_kernel above: the same runs and patch, the run's dy tile
// staged beside it, a two-stage cp.async ring, mma.sync with the pixels as
// the reduction, dbias as a column of ones, over fixed partitions of runs
// from the shape alone; f32 and other shapes keep the scalar mma.sync /
// CUDA-core kernels over fixed row partitions. Either way the fixed-order
// reduce follows, dbias in the same pass. What bounds the weight gradient
// at batch 48: bytes (dy 100.7 MB + x 18.9 MB: 0.036 ms at 3.35 TB/s,
// against 14.8 GFLOP: 0.015 ms at 989 TFLOP/s). Two entry points of their
// own, so that a run counts K10's launches apart from K5's.

// y (N, Ho, Wo, Cout) = relu?(conv(x, w, stride, pad 3) + bias) for x (N, H,
// W, 3) NHWC, w (Cout, 7, 7, 3) OHWI, bias (Cout,) or NULL; dtype 0 =
// float32 (the CUDA-core kernel), 1 = bfloat16; Cout % 8 == 0, y 16-byte
// aligned. The caller's plan (layers.stem_plan, from the shape alone):
//   * grid > 0 (bf16, stride 2, Cout 64 only): stem7_kernel on at most
//     `grid` blocks (no more than its groups fill), each warp a group of
//     32 output pixels of a row at a time and its 7 x 224 box of x;
//     staged 1 (3 W % 8 == 0, x 16-byte aligned): the boxes by TMA, else
//     copied by the warp; w 16-byte aligned, the bias 4-byte aligned
//     (read in bf16 pairs);
//   * grid 0: the general stem kernels (mma.sync in bf16, CUDA cores in
//     f32) with k = 7.
// Returns cudaGetLastError(), or cudaErrorInvalidValue.
extern "C" int conv2d_stem_forward(const void* x, const void* w,
                                   const void* bias, void* y, int N, int H,
                                   int W, int Cin, int Cout, int k,
                                   int stride, int relu, int dtype,
                                   int staged, int grid, void* stream) {
  if (k != 7 || Cin != 3 || (stride != 1 && stride != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool runs = dtype == 1 && stride == 2 && Cout == 64;
  if (grid == 0 && !runs) {
    return conv2d_act_forward(x, w, bias, nullptr, y, nullptr, N, H, W, Cin,
                              Cout, k, stride, relu, dtype, 0, 0, 0, 0, 0, 0,
                              stream);
  }
  auto misaligned = [](const void* p) { return (uintptr_t)p % 16 != 0; };
  if (!runs || grid < 1 || (staged != 0 && staged != 1) || misaligned(w) ||
      misaligned(y) || (uintptr_t)bias % 4 != 0 ||
      (staged && (W % 8 != 0 || misaligned(x)))) {
    return (int)cudaErrorInvalidValue;
  }
  const ConvShape s = conv_shape(N, H, W, Cin, Cout, k, stride);
  const long long groups =
      (long long)N * s.Ho * ((s.Wo + kStemGroup - 1) / kStemGroup);
  if (groups == 0) return (int)cudaSuccess;
  if (groups > 0x7fffffff || 3LL * W * H * N >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long fill = (groups + kStemWarps - 1) / kStemWarps;
  return (int)launch_stem7(s, x, w, bias, y, relu, staged == 1,
                           (int)(grid < fill ? grid : fill),
                           (cudaStream_t)stream);
}

// K10's weight gradient: dw (Cout, 7, 7, 3) and dbias (with db) for x (N,
// H, W, 3) and dy (N, Ho, Wo, Cout) NHWC, the ReLU mask y and the masked
// dy dym as conv2d_wgrad takes them; part parts x Cout x 147 f32 scratch,
// pbias parts x Cout (with db). The caller picks the route:
//   * by_runs 1 (bf16, stride 2, Cout 64 only): stem7_wgrad_kernel;
//     partition p takes the runs [p per_part, (p + 1) per_part) of the N
//     Ho ceil(Wo / 128) runs of up to 128 output pixels of a row (run =
//     (n Ho + ho) ceil(Wo / 128) + wo / 128); x, dy, y and dym 16-byte
//     aligned.
//   * by_runs 0: conv2d_wgrad's kernels (vec 0: the scalar kernel in bf16,
//     the CUDA-core one in f32) over parts row partitions of per_part rows
//     (a multiple of 32).
// Returns cudaGetLastError(), or cudaErrorInvalidValue.
extern "C" int conv2d_stem_wgrad(const void* x, const void* dy,
                                 const void* y, void* dym, void* part,
                                 void* pbias, void* dw, void* db, int N,
                                 int H, int W, int Cin, int Cout, int k,
                                 int stride, int parts, int per_part,
                                 int by_runs, int dtype, void* stream) {
  if (k != 7 || Cin != 3 || (stride != 1 && stride != 2) ||
      (by_runs != 0 && by_runs != 1) ||
      (by_runs && !(dtype == 1 && stride == 2 && Cout == 64))) {
    return (int)cudaErrorInvalidValue;
  }
  if (!by_runs) {
    return conv2d_wgrad(x, dy, y, dym, part, pbias, dw, db, N, H, W, Cin,
                        Cout, k, stride, parts, per_part, 0, dtype, 0,
                        stream);
  }
  const ConvShape s = conv_shape(N, H, W, Cin, Cout, k, stride);
  const long long runs =
      (long long)N * s.Ho * ((s.Wo + kStemRun - 1) / kStemRun);
  auto misaligned = [](const void* p) { return (uintptr_t)p % 16 != 0; };
  if (runs > 0x7fffffff || parts < 1 || per_part < 1 ||
      (long long)parts * per_part < runs || (db == nullptr) !=
      (pbias == nullptr) || (y == nullptr) != (dym == nullptr) ||
      misaligned(x) || misaligned(dy) || misaligned(y) ||
      misaligned(dym) || 3LL * W * H * N >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  // The shared-memory attribute, set once a device (as launch_stem does).
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(stem7_wgrad_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSwBytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) configured[dev] = true;
  }
  stem7_wgrad_kernel<<<parts, kSwThreads, kSwBytes, st>>>(
      (const bf16*)x, (const bf16*)dy, (const bf16*)y, (bf16*)dym,
      (float*)part, (float*)pbias, s, (int)runs, per_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)wgrad_reduce(part, pbias, dw, db, parts, Cout * s.K, Cout,
                           dtype, st);
}
