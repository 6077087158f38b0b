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
// pixel's channels are contiguous. The A tile is gathered from x (the
// im2col view) with zero-fill for the padding, the ragged M and K edges
// and Cout beyond the tile.
//   * bf16: a block of 4 warps computes BM x BN outputs (BM 256, 128 or
//     64; BN 128, 96, 64 or 48): the largest tile whose BN divides Cout
//     (the 48- and 96-channel branches waste no column) that still puts a
//     block on every SM, else the smallest (the 16x16 and 8x8 maps). K is
//     walked in steps of 32 through a four-stage cp.async ring in dynamic
//     shared memory (16-byte copies when Cin % 8 == 0, each thread's tap
//     and channel carried from step to step; scalar loads for the stem's
//     Cin = 3); each warp runs mma.sync.m16n8k16 (bf16 x bf16 -> f32) on
//     ldmatrix fragments over its part of the tile (64 x 48 for the
//     48-channel convs, up to 64 x 64). The f32 sums are fixed per output:
//     no split-K, no atomics.
//   * f32: a block of 256 threads computes 64 x 64 outputs, 4 x 4 each,
//     with CUDA-core multiply-adds in K order (no TF32; --fmad=false keeps
//     each product rounded).
// Epilogue, per element, as the plain version's eager ops round: the f32
// sum is rounded to the output dtype, then the bias is added (in f32, then
// rounded), then the residual (rounded), then the ReLU. With equal sums the
// kernel and the plain version agree to the bit. In bf16 the rounded sums
// are staged in shared memory and the rest runs on 16-byte chunks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// The implicit GEMM of K5-conv and K5-dgrad: output row (n, ho, wo) at tap
// (r, c) reads source pixel (t_h / istride, t_w / istride) with t_h = ho
// stride - pad + r, or zero if t is negative, not a multiple of istride or
// beyond (H, W). The forward has istride 1; the data gradient is the same
// loop with stride 1 and istride the conv's stride (a gather per dx pixel).
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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

__device__ __forceinline__ void ldmatrix_x2(unsigned* r, const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

template <int BM, int BN>
constexpr int smem_bytes() {
  return kStages * (BM + BN) * kLds * (int)sizeof(bf16);
}

// A block of 4 warps, (4 / WN) along M and WN along N, computes BM x BN
// outputs, BN = 8 NT WN; each warp a (BM WN / 4) x (8 NT) part. kVec: Cin %
// 8 == 0 and 16-byte aligned rows, so that every 8-element K group lies in
// one (kh, kw) tap and is one 16-byte copy. kIS: s.istride (1, or 2 for
// the data gradient of a stride-2 conv; kVec only).
template <int BM, int NT, int WN, bool kVec, int kIS>
__global__ void __launch_bounds__(kThreadsMma) conv_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    const bf16* __restrict__ bias, const bf16* __restrict__ res,
    bf16* __restrict__ y, ConvShape s, int relu) {
  static_assert(kVec || kIS == 1, "istride 2 needs 16-byte copies");
  constexpr int BN = 8 * NT * WN;
  constexpr int WM = BM * WN / 4;   // rows of a warp's part
  constexpr int MT = WM / 16;       // its m16 tiles
  constexpr int A_ROWS = BM / 32;   // A rows each thread copies (kVec)
  constexpr int B_ROWS = (BN + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  typedef bf16 Row[kLds];
  Row* As = reinterpret_cast<Row*>(smem_raw);          // [kStages * BM]
  Row* Bs = As + kStages * BM;                         // [kStages * BN]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int HoWo = s.Ho * s.Wo;

  // kVec copies: thread tid takes K offset (tid & 3) * 8 of rows
  // (tid >> 2) + 32 i of the A tile and of the B tile.
  const int kk = (tid & 3) * 8;
  int a_base[A_ROWS], a_h[A_ROWS], a_w[A_ROWS];
#pragma unroll
  for (int i = 0; i < A_ROWS; ++i) {
    const int m = m0 + (tid >> 2) + 32 * i;
    a_base[i] = 0;
    a_h[i] = -(1 << 20);  // never inside the image
    a_w[i] = 0;
    if (kVec && m < s.M) {
      const int n = m / HoWo, r = m - n * HoWo;
      const int ho = r / s.Wo, wo = r - ho * s.Wo;
      a_base[i] = n * s.H;
      a_h[i] = ho * s.stride - s.pad;
      a_w[i] = wo * s.stride - s.pad;
    }
  }

  // kVec: the tap (r, c) and channel ci of this thread's K offset, kept
  // from one K step to the next (tiles load in order) instead of divided.
  int tap_r = 0, tap_c = 0, tap_ci = 0;
  if (kVec && kk < s.K) {
    const int rc = kk / s.Cin;
    tap_ci = kk - rc * s.Cin;
    tap_r = rc / s.k;
    tap_c = rc - tap_r * s.k;
  }

  // Without 16-byte copies: each row's (n H, ho stride - pad, wo stride -
  // pad), computed once per block.
  __shared__ int row_pix[kVec ? 1 : BM][3];
  if (!kVec) {
    for (int i = tid; i < BM; i += kThreadsMma) {
      const int m = m0 + i;
      int n = 0, ho = -(1 << 20), wo = 0;
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
  }

  auto load_tile = [&](int st, int k0) {
    Row* A = As + st * BM;
    Row* Bt = Bs + st * BN;
    if (kVec) {
      const int kg = k0 + kk;
      const bool kin = kg < s.K;
      const int r = tap_r, c = tap_c, ci = tap_ci;
      tap_ci += kBK;  // the next tile's position
      while (tap_ci >= s.Cin) {
        tap_ci -= s.Cin;
        if (++tap_c == s.k) {
          tap_c = 0;
          ++tap_r;
        }
      }
#pragma unroll
      for (int i = 0; i < A_ROWS; ++i) {
        int hi = a_h[i] + r, wi = a_w[i] + c;
        bool ok = kin && hi >= 0 && wi >= 0;
        if (kIS == 2) {  // only even taps land on a dy pixel
          ok = ok && ((hi | wi) & 1) == 0;
          hi >>= 1;
          wi >>= 1;
        }
        ok = ok && hi < s.H && wi < s.W;
        const bf16* src =
            ok ? x + ((size_t)(a_base[i] + hi) * s.W + wi) * s.Cin + ci : x;
        cp_async16(&A[(tid >> 2) + 32 * i][kk], src, ok);
      }
#pragma unroll
      for (int i = 0; i < B_ROWS; ++i) {
        const int row = (tid >> 2) + 32 * i;
        if (row < BN) {
          const int co = n0 + row;
          const bool ok = kin && co < s.Cout;
          const bf16* src = ok ? w + (size_t)co * s.K + kg : w;
          cp_async16(&Bt[row][kk], src, ok);
        }
      }
    } else {
      // Thread tid fills column tid % 32 of the tile: one tap and channel
      // per K step, the rows' pixels from the block's table.
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
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  // A kStages-deep cp.async ring: tile kt + kStages - 1 is in flight while
  // tile kt is multiplied. One barrier per K step: it also frees the stage
  // that the step's prefetch refills (the one consumed a step before).
  const int KT = (s.K + kBK - 1) / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < KT) load_tile(st, st * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
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
      if (NT & 1) {
        const int col = wn * (8 * NT) + (NT - 1) * 8 + (lane & 7);
        ldmatrix_x2(bfr[NT - 1], &Bt[col][ks + ((lane >> 3) & 1) * 8]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af[mt], bfr[nt]);
    }
    const int nk = kt + kStages - 1;
    if (nk < KT) load_tile(nk % kStages, nk * kBK);
    cp_async_commit();
  }

  // Epilogue: the sums, rounded to bf16 (its first step), go through the
  // freed ring so that the bias, residual and ReLU pass reads and writes
  // 16 bytes a thread, neighbouring threads on neighbouring addresses.
  cp_async_wait<0>();
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
    const uint4 u = *reinterpret_cast<const uint4*>(Cs + r * kCs + cc);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    float v[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
    if (bias) {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = rnd<bf16>(v[i] + to_f(bias[co + i]));
    }
    if (res) {
      const uint4 ru = *reinterpret_cast<const uint4*>(res + idx);
      const __nv_bfloat162* rh = reinterpret_cast<const __nv_bfloat162*>(&ru);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(rh[i]);
        v[2 * i] = rnd<bf16>(v[2 * i] + f.x);
        v[2 * i + 1] = rnd<bf16>(v[2 * i + 1] + f.y);
      }
    }
    uint4 out;
    __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = relu && v[2 * i] < 0.f ? 0.f : v[2 * i];
      const float b = relu && v[2 * i + 1] < 0.f ? 0.f : v[2 * i + 1];
      oh[i] = __floats2bfloat162_rn(a, b);
    }
    *reinterpret_cast<uint4*>(y + idx) = out;
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

template <int BM, int NT, int WN, bool kVec, int kIS>
cudaError_t launch_bf16(const ConvShape& s, const void* x, const void* w,
                        const void* bias, const void* res, void* y, int relu,
                        cudaStream_t stream) {
  constexpr int BN = 8 * NT * WN;
  constexpr int bytes = smem_bytes<BM, BN>();
  // The shared-memory attribute belongs to a device: it is set at each
  // kernel's first launch on each device (on every launch past the 64th).
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(conv_bf16_kernel<BM, NT, WN, kVec, kIS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) configured[dev] = true;
  }
  const dim3 grid((s.M + BM - 1) / BM, (s.Cout + BN - 1) / BN);
  conv_bf16_kernel<BM, NT, WN, kVec, kIS>
      <<<grid, kThreadsMma, bytes, stream>>>(
      (const bf16*)x, (const bf16*)w, (const bf16*)bias, (const bf16*)res,
      (bf16*)y, s, relu);
  return cudaGetLastError();
}

// The tile for a conv, (BM, NT, WN): of the tiles whose BN divides Cout,
// by area, the first whose grid puts a block on every one of the device's
// `sms` SMs; else the smallest, to spread a small conv (the 16x16 and 8x8
// maps) over as many SMs as it can fill. Without 16-byte copies (the
// stem's Cin = 3) the 64-column tiles; where no tile divides Cout, those
// with a ragged edge.
cudaError_t launch_bf16_any(const ConvShape& s, bool vec, const void* x,
                            const void* w, const void* bias, const void* res,
                            void* y, int relu, int sms, cudaStream_t st) {
  // Of two tiles of one area the wider first: it reads the A tiles fewer
  // times (128 x 96 before 256 x 48 for the 96-channel convs).
  static const int kTiles[][3] = {
      {128, 8, 2}, {128, 6, 2}, {256, 6, 1}, {128, 4, 2}, {64, 8, 2},
      {128, 3, 2}, {64, 6, 2},  {64, 4, 2},  {64, 3, 2}};
  auto blocks = [&](int bm, int bn) {
    return (long long)((s.M + bm - 1) / bm) * ((s.Cout + bn - 1) / bn);
  };
  int bm = 0, nt = 0, wn = 2;
  for (const auto& t : kTiles) {
    const int bn = 8 * t[1] * t[2];
    if (vec ? s.Cout % bn != 0 : bn != 64) continue;
    bm = t[0];
    nt = t[1];
    wn = t[2];
    if (blocks(bm, bn) >= sms) break;
  }
  if (bm == 0) {  // no tile divides Cout: 64 columns with a ragged edge
    nt = 4;
    wn = 2;
    bm = blocks(128, 64) >= sms ? 128 : 64;
  }
#define K5_LAUNCH(BM, NT, WN, VEC)                                       \
  return s.istride == 2                                                  \
             ? launch_bf16<BM, NT, WN, VEC, VEC ? 2 : 1>(s, x, w, bias, \
                                                         res, y, relu, st) \
             : launch_bf16<BM, NT, WN, VEC, 1>(s, x, w, bias, res, y, relu, st)
  if (!vec) {
    if (bm == 128) K5_LAUNCH(128, 4, 2, false);
    K5_LAUNCH(64, 4, 2, false);
  }
  if (bm == 256) K5_LAUNCH(256, 6, 1, true);
  if (bm == 128) {
    if (nt == 8) K5_LAUNCH(128, 8, 2, true);
    if (nt == 6) K5_LAUNCH(128, 6, 2, true);
    if (nt == 3) K5_LAUNCH(128, 3, 2, true);
    K5_LAUNCH(128, 4, 2, true);
  }
  if (nt == 8) K5_LAUNCH(64, 8, 2, true);
  if (nt == 6) K5_LAUNCH(64, 6, 2, true);
  if (nt == 3) K5_LAUNCH(64, 3, 2, true);
  K5_LAUNCH(64, 4, 2, true);
#undef K5_LAUNCH
}


// ---- K5-wgrad: dw = sum over rows (n, ho, wo) of dy (x) im2col(x) -------
//
// A GEMM of M = Cout, N = K (kh, kw, ci in the OHWI weight's order) over
// R = N Ho Wo rows, which is long (196,608 rows for the 48-channel 3x3s at
// 64^2 and batch 48) where M x N is small (48 x 432). The rows are cut into
// `parts` fixed partitions of `rows_per_part` (a function of the shape
// alone, chosen by the wrapper): block (co tile, K tile, partition) sums its
// rows in row order into an f32 partial; the second pass adds the partials
// in partition order and rounds once. No atomics: the same bits on any
// card. Blocks of the first K tile also sum dy's columns (dbias) and, with a
// ReLU mask (y > 0 on the saved output), write the masked dy once (dym),
// which the data gradient and the residual's gradient then read.
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

// kVec: Cin % 8 == 0 and x 16-byte aligned (an 8-column K group is one tap).
template <bool kVec>
__global__ void __launch_bounds__(kThreadsMma) wgrad_bf16_kernel(
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
  // x (kVec): the same chunk layout over K; its tap, decoded once.
  // x (scalar): column tid & 63 of rows (tid >> 6) + 2 j.
  const int xc = kVec ? (tid & 7) * 8 : (tid & 63);
  const int kk = kk0 + xc;
  const bool k_in = kk < s.K;
  int tap_r = 0, tap_c = 0, tap_ci = 0;
  if (k_in) {
    const int rc = kk / s.Cin;
    tap_ci = kk - rc * s.Cin;
    tap_r = rc / s.k;
    tap_c = rc - tap_r * s.k;
  }

  uint4 ra[2], rb[2];
  bf16 rs[16];
  const bf16 zero = __float2bfloat16_rn(0.f);
  auto x_at = [&](int g, bool& ok) -> size_t {
    const int n = g / HoWo, rem = g - n * HoWo;
    const int ho = rem / s.Wo, wo = rem - ho * s.Wo;
    const int hi = ho * s.stride - s.pad + tap_r;
    const int wi = wo * s.stride - s.pad + tap_c;
    ok = hi >= 0 && hi < s.H && wi >= 0 && wi < s.W;
    return ((size_t)(n * s.H + hi) * s.W + wi) * s.Cin + tap_ci;
  };
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
    if (kVec) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int g = base + (tid >> 3) + 16 * j;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (g < r_end && k_in) {
          bool ok;
          const size_t idx = x_at(g, ok);
          if (ok) v = *reinterpret_cast<const uint4*>(x + idx);
        }
        rb[j] = v;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int g = base + (tid >> 6) + 2 * j;
        bf16 v = zero;
        if (g < r_end && k_in) {
          bool ok;
          const size_t idx = x_at(g, ok);
          if (ok) v = x[idx];
        }
        rs[j] = v;
      }
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      *reinterpret_cast<uint4*>(&As[buf][(tid >> 3) + 16 * j][dc]) = ra[j];
    }
    if (kVec) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        *reinterpret_cast<uint4*>(&Bs[buf][(tid >> 3) + 16 * j][xc]) = rb[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) Bs[buf][(tid >> 6) + 2 * j][xc] = rs[j];
    }
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

}  // namespace

// x (N, H, W, Cin) and y (N, Ho, Wo, Cout) NHWC, w (Cout, k, k, Cin) OHWI,
// bias (Cout,) or NULL, residual like y or NULL; dtype 0 = float32, 1 =
// bfloat16 for all of them. k in {1, 3} with padding k / 2, stride >= 1;
// Cout % 8 == 0; y and residual 16-byte aligned. vec (bf16 only): Cin % 8
// == 0 and x, w 16-byte aligned. sms: the device's multiprocessor count,
// which the bf16 tile choice fills.
// Returns cudaGetLastError().
extern "C" int conv2d_act_forward(const void* x, const void* w,
                                  const void* bias, const void* residual,
                                  void* y, int N, int H, int W, int Cin,
                                  int Cout, int k, int stride, int relu,
                                  int dtype, int vec, int sms, void* stream) {
  const ConvShape s = conv_shape(N, H, W, Cin, Cout, k, stride);
  if (s.M == 0 || Cout == 0) return (int)cudaSuccess;
  if (Cout % 8 != 0 || (vec && Cin % 8 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    const dim3 grid((s.M + kTile - 1) / kTile, (Cout + kTile - 1) / kTile);
    conv_f32_kernel<<<grid, kThreadsF32, 0, st>>>(
        (const float*)x, (const float*)w, (const float*)bias,
        (const float*)residual, (float*)y, s, relu);
    return (int)cudaGetLastError();
  }
  return (int)launch_bf16_any(s, vec != 0, x, w, bias, residual, y, relu,
                              sms, st);
}

// K5-dgrad: dx (N, H, W, Cin) = the data gradient of the conv above from dy
// (N, Ho, Wo, Cout), with wt (Cin, k, k, Cout) the weight flipped in (kh,
// kw) and transposed (OHWI of the transposed conv). It is K5-conv's main
// loop on dy: stride 1, padding k - 1 - k / 2, and input stride `stride`,
// so that each dx pixel gathers the dy pixels it fed (a stride-2 3x3 conv:
// 1, 2, 2 or 4 taps by the parity of (h, w); a stride-2 1x1: dy at even
// pixels, zeros at odd ones). f32 sums in K order, rounded once; no
// epilogue. Cin % 8 == 0 and Cout % 8 == 0; all 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int conv2d_dgrad(const void* dy, const void* wt, void* dx, int N,
                            int H, int W, int Cin, int Cout, int k,
                            int stride, int dtype, int sms, void* stream) {
  const ConvShape f = conv_shape(N, H, W, Cin, Cout, k, stride);
  ConvShape s;
  s.N = N; s.H = f.Ho; s.W = f.Wo; s.Cin = Cout;
  s.Ho = H; s.Wo = W; s.Cout = Cin; s.k = k;
  s.stride = 1;
  s.pad = k - 1 - f.pad;
  s.istride = stride;
  s.M = N * H * W;
  s.K = k * k * Cout;
  if (s.M == 0 || Cin == 0) return (int)cudaSuccess;
  if (Cin % 8 != 0 || Cout % 8 != 0 || (stride != 1 && stride != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    const dim3 grid((s.M + kTile - 1) / kTile, (Cin + kTile - 1) / kTile);
    conv_f32_kernel<<<grid, kThreadsF32, 0, st>>>(
        (const float*)dy, (const float*)wt, nullptr, nullptr, (float*)dx, s,
        0);
    return (int)cudaGetLastError();
  }
  return (int)launch_bf16_any(s, true, dy, wt, nullptr, nullptr, dx, 0, sms,
                              st);
}

// K5-wgrad: dw (Cout, k, k, Cin) OHWI = sum over (n, ho, wo) of dy (x)
// im2col(x), and dbias (Cout,) = sum of dy when db is not NULL, both in
// x's dtype, for x (N, H, W, Cin) and dy (N, Ho, Wo, Cout) NHWC. With y
// (like dy, the conv's saved output) the ReLU mask y > 0 is applied as dy
// is read and the masked dy is written to dym. part: parts x Cout x K f32
// scratch, pbias parts x Cout (with db); rows_per_part a multiple of 32
// with parts x rows_per_part >= N Ho Wo. vec (bf16): Cin % 8 == 0 and x
// 16-byte aligned. Cout % 8 == 0, dy / y / dym 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int conv2d_wgrad(const void* x, const void* dy, const void* y,
                            void* dym, void* part, void* pbias, void* dw,
                            void* db, int N, int H, int W, int Cin,
                            int Cout, int k, int stride, int parts,
                            int rows_per_part, int vec, int dtype,
                            void* stream) {
  const ConvShape s = conv_shape(N, H, W, Cin, Cout, k, stride);
  if (Cout % 8 != 0 || (vec && Cin % 8 != 0) || rows_per_part % kWR != 0 ||
      (long long)parts * rows_per_part < s.M || (db == nullptr) !=
      (pbias == nullptr) || (y == nullptr) != (dym == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (Cout == 0 || s.K == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((Cout + kWT - 1) / kWT, (s.K + kWT - 1) / kWT, parts);
  if (dtype == 0) {
    wgrad_f32_kernel<<<grid, kThreadsF32, 0, st>>>(
        (const float*)x, (const float*)dy, (const float*)y, (float*)dym,
        (float*)part, (float*)pbias, s, rows_per_part);
  } else if (vec) {
    wgrad_bf16_kernel<true><<<grid, kThreadsMma, 0, st>>>(
        (const bf16*)x, (const bf16*)dy, (const bf16*)y, (bf16*)dym,
        (float*)part, (float*)pbias, s, rows_per_part);
  } else {
    wgrad_bf16_kernel<false><<<grid, kThreadsMma, 0, st>>>(
        (const bf16*)x, (const bf16*)dy, (const bf16*)y, (bf16*)dym,
        (float*)part, (float*)pbias, s, rows_per_part);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int CK = Cout * s.K;
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
  return (int)cudaGetLastError();
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
