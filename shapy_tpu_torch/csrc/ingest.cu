// K2 ingest: uint8 decode + affine bilinear crop + ImageNet normalisation +
// cast, forward only; in training with the per-crop channel noise between
// the crop and the normalisation.
//
// Replaces: shapy_tpu/data/crop.py:jax_bilinear_crop (line 96) together
// with the preprocessing of shapy_tpu/models/heads/regressor.py
// :BodyRegressor.apply_from_full_images (lines 531-542), which XLA runs as
// gathers and elementwise passes over f32 copies of the full images.
//
// What bounds it on the H100: bytes and the memory instructions that move
// them, then instruction issue. The served batch (32 uint8 images of
// 480x360 -> bf16 crops of 256x256) writes 12.6 MB and must read the
// source pixels inside each crop's footprint (chip_smoke.py counts them
// from the run's affines); each output channel also costs a true division
// and ~15 other operations. A gather of a corner's byte for 32 rotated
// output pixels touches many cache lines, and stores of 2 bytes at a
// 6-byte stride write partial sectors: both cost more than their bytes.
//
// Design: a block takes a 32 x 32 tile of one crop; a warp's lanes take
// its 32 columns and each of its kWarps warps kRows rows, so that in each
// step a warp samples 32 neighbouring pixels of one row; rows and columns
// come from the block and thread indices, with no division per pixel. The
// tile's source footprint is the box that its four corner pixels map to,
// from floor(min) to floor(max) + 1 (the +1 corner) and clipped to the
// image. It is exact without a margin: every operation of the affine map
// as rounded below, (a0 x + a1 y) + a2, is monotone, so the map is
// monotone in each output coordinate and no pixel of the tile maps outside
// its corners' range (and a box a row short fails the checks, where a
// margin would hide it). Where the image and its rows are 16-byte aligned
// and the box's rows, as whole 16-byte chunks of the image's rows, fit
// kBoxBytes, the block stages them with cp.async, every chunk in flight at
// once, and reads each bilinear corner's channels from shared memory. A
// tile whose box does not fit (a magnification above ~1.9 at 30 degrees
// for uint8, ~0.9 for f32 input), whose corners map to no finite point, or
// whose image's rows are not 16-byte aligned reads its corners from the
// image: a regime of the kernel (data/crop.py:ingest_plan replays which
// tile takes which). Either way a corner outside the image reads 0 before
// normalisation, so outside pixels come out as -mean/std as in the JAX
// package. The finished tile goes through shared memory (the box's) and
// leaves as 16-byte vectors, each of its rows contiguous in the output,
// where the output's rows are 16-byte aligned, else element by element.
//
// The training variant (ingest_noise_forward) takes a (B, 3) f32 factor a
// crop and channel and computes (clip(v * f, 0, 1) - mean) / std from the
// bilinear sample v in [0, 1]: the JAX package's Crop -> ChannelNoise ->
// Normalize (shapy_tpu/data/transforms.py:407-420, :526-545) in one pass.
// It is the same kernel with kNoise set; without it the operations are
// the ones above, so the served and evaluated crops do not move.
//
// Every output is bit-equal to the plain PyTorch version
// (data/crop.py:crop_normalize_plain): the same f32 operations in the same
// order, the normalisation a true division, built with --fmad=false so
// that nothing is contracted.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;  // output pixels a block: kTile x kTile, a column a lane
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kTile / kWarps;  // rows a thread
constexpr int kBoxBytes = 24 * 1024;  // a staged footprint's budget

struct Norm {
  float mean[3];
  float std[3];
};

// The plain version's uint8 -> [0, 1]: the byte as a float times 1/255
// rounded to f32 (torch casts the Python scalar to the tensor's type).
constexpr float kInv255 = (float)(1.0 / 255.0);

// A channel of a source pixel as a float in [0, 1] (uint8: the byte as a
// float, 2^23 + byte less 2^23, times 1/255 as the plain version).
__device__ __forceinline__ float channel(uint8_t v) {
  return (__uint_as_float(0x4B000000u | v) - 8388608.f) * kInv255;
}
__device__ __forceinline__ float channel(float v) { return v; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

template <typename In, typename Out, bool kNoise>
__global__ void __launch_bounds__(kThreads)
    ingest_kernel(const In* __restrict__ images,
                  const float* __restrict__ affines,
                  const float* __restrict__ factors, Out* __restrict__ out,
                  int H, int W, int S, Norm norm, int aligned, int vector_out) {
  static_assert(kTile * kTile * 3 * sizeof(Out) <= kBoxBytes,
                "the finished tile leaves through the box's memory");
  __shared__ __align__(16) uint8_t box[kBoxBytes];
  constexpr int kPx = 3 * (int)sizeof(In);  // bytes a source pixel
  const int b = blockIdx.z;
  const int tx = blockIdx.x * kTile, ty = blockIdx.y * kTile;
  const float* A = affines + (size_t)b * 9;
  const float a0 = A[0], a1 = A[1], a2 = A[2], a3 = A[3], a4 = A[4],
              a5 = A[5];
  const In* img = images + (size_t)b * H * W * 3;
  float noise[3];
  if (kNoise) {
#pragma unroll
    for (int c = 0; c < 3; ++c) noise[c] = factors[(size_t)b * 3 + c];
  }

  // The footprint: where the tile's four corner pixels map.
  float lo_x = INFINITY, hi_x = -INFINITY, lo_y = INFINITY, hi_y = -INFINITY;
  bool finite = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float gx = (float)(k & 1 ? min(tx + kTile, S) - 1 : tx);
    const float gy = (float)(k & 2 ? min(ty + kTile, S) - 1 : ty);
    const float sx = a0 * gx + a1 * gy + a2;
    const float sy = a3 * gx + a4 * gy + a5;
    finite = finite && isfinite(sx) && isfinite(sy);
    lo_x = fminf(lo_x, sx);
    hi_x = fmaxf(hi_x, sx);
    lo_y = fminf(lo_y, sy);
    hi_y = fmaxf(hi_y, sy);
  }
  // Corners are floor(s) and floor(s) + 1, clipped to the image (a box of
  // no pixel stages nothing).
  const float bx0 = fmaxf(floorf(lo_x), 0.f);
  const float bx1 = fminf(floorf(hi_x) + 1.f, (float)(W - 1));
  const float by0 = fmaxf(floorf(lo_y), 0.f);
  const float by1 = fminf(floorf(hi_y) + 1.f, (float)(H - 1));
  const int bw = finite && bx1 >= bx0 ? (int)(bx1 - bx0) + 1 : 0;
  const int bh = finite && by1 >= by0 ? (int)(by1 - by0) + 1 : 0;
  const int x_lo = (int)bx0, y_lo = (int)by0;
  // The box's rows as whole 16-byte chunks: a row starts `lead` bytes into
  // its first chunk and takes `pitch` bytes of shared memory (none for a
  // box of no pixel, whose x_lo may lie past the row's end).
  const int lead = x_lo * kPx % 16;
  const int pitch = bw ? (lead + bw * kPx + 15) / 16 * 16 : 0;
  const bool staged = aligned && finite && (long long)pitch * bh <= kBoxBytes;

  if (staged) {
    const int chunks = pitch / 16, n = chunks * bh;
    const size_t row_bytes = (size_t)W * kPx;
    const uint8_t* src = reinterpret_cast<const uint8_t*>(img) +
                         (size_t)y_lo * row_bytes + x_lo * kPx - lead;
    // i / chunks in f32: (i + 0.5) / chunks lies 0.5 / chunks or more from
    // an integer, and its two roundings move it by less while n < 2^22.
    const float inv = 1.f / (float)max(chunks, 1);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int r = (int)(((float)i + 0.5f) * inv), k = i - r * chunks;
      cp_async16(box + r * pitch + k * 16, src + r * row_bytes + k * 16);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }

  const int lane = threadIdx.x % 32, row0 = threadIdx.x / 32 * kRows;
  const int gx = tx + lane;
  const float fx = (float)gx;
  const float x_x = a0 * fx, x_y = a3 * fx;  // a0 x and a3 x
  const float xmax = (float)(W - 1), ymax = (float)(H - 1);
  float res[kRows][3];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int gy = ty + row0 + i;
    if (gx >= S || gy >= S) continue;
    const float fy = (float)gy;
    const float sx = x_x + a1 * fy + a2;  // (a0 x + a1 y) + a2
    const float sy = x_y + a4 * fy + a5;
    const float x0 = floorf(sx), y0 = floorf(sy);
    const float wx = sx - x0, wy = sy - y0;
    const float x1 = x0 + 1.f, y1 = y0 + 1.f;
    const bool in_x[2] = {x0 >= 0.f && x0 <= xmax, x1 >= 0.f && x1 <= xmax};
    const bool in_y[2] = {y0 >= 0.f && y0 <= ymax, y1 >= 0.f && y1 <= ymax};
    // Clamped so that the offsets stay small where no corner is read.
    const int xi = (int)fminf(fmaxf(x0, -1.f), xmax + 1.f);
    const int yi = (int)fminf(fmaxf(y0, -1.f), ymax + 1.f);
    float v[4][3];  // corners (x0, y0), (x1, y0), (x0, y1), (x1, y1)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int dx = k & 1, dy = k >> 1;
#pragma unroll
      for (int c = 0; c < 3; ++c) v[k][c] = 0.f;
      if (!(in_x[dx] && in_y[dy])) continue;
      if (staged) {  // a shared-memory load a channel
        const In* p = reinterpret_cast<const In*>(
            box + (yi + dy - y_lo) * pitch + lead + (xi + dx - x_lo) * kPx);
#pragma unroll
        for (int c = 0; c < 3; ++c) v[k][c] = channel(p[c]);
      } else {
        const In* p = img + ((size_t)(yi + dy) * W + (xi + dx)) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) v[k][c] = channel(p[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float top = v[0][c] * (1.f - wx) + v[1][c] * wx;
      const float bot = v[2][c] * (1.f - wx) + v[3][c] * wx;
      float val = top * (1.f - wy) + bot * wy;
      if (kNoise) val = fminf(fmaxf(val * noise[c], 0.f), 1.f);
      res[i][c] = (val - norm.mean[c]) / norm.std[c];
    }
  }

  // The finished tile, row by row in the output's layout, in the box's
  // memory once every corner has been read.
  Out* tile = reinterpret_cast<Out*>(box);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      store(tile + ((row0 + i) * kTile + lane) * 3 + c, res[i][c]);
    }
  }
  __syncthreads();
  const int w = min(kTile, S - tx), h = min(kTile, S - ty);
  Out* dst = out + (((size_t)b * S + ty) * S + tx) * 3;
  if (vector_out && w == kTile) {
    constexpr int kChunks = kTile * 3 * (int)sizeof(Out) / 16;  // a row's
    for (int i = threadIdx.x; i < h * kChunks; i += kThreads) {
      const int r = i / kChunks, k = i % kChunks;
      reinterpret_cast<uint4*>(dst + (size_t)r * S * 3)[k] =
          reinterpret_cast<const uint4*>(tile + r * kTile * 3)[k];
    }
  } else {
    for (int i = threadIdx.x; i < h * w * 3; i += kThreads) {
      const int r = i / (w * 3), k = i - r * w * 3;
      dst[(size_t)r * S * 3 + k] = tile[r * kTile * 3 + k];
    }
  }
}

template <typename In, typename Out>
void launch(const void* images, const void* affines, const void* factors,
            void* out, int B, int H, int W, int S, Norm norm,
            cudaStream_t stream) {
  const int tiles = (S + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles, B);
  // Footprints are staged in 16-byte chunks where the tensor, each image
  // and each of its rows start 16-byte aligned, else no tile is staged.
  const size_t row = (size_t)W * 3 * sizeof(In);
  const int aligned = (uintptr_t)images % 16 == 0 && row % 16 == 0;
  // Whole tile rows as 16-byte vectors where every output row starts
  // 16-byte aligned (a tile row starts 32 pixels apart).
  const int vector_out = (uintptr_t)out % 16 == 0 &&
                         (size_t)S * 3 * sizeof(Out) % 16 == 0;
  if (factors) {
    ingest_kernel<In, Out, true><<<grid, kThreads, 0, stream>>>(
        (const In*)images, (const float*)affines, (const float*)factors,
        (Out*)out, H, W, S, norm, aligned, vector_out);
  } else {
    ingest_kernel<In, Out, false><<<grid, kThreads, 0, stream>>>(
        (const In*)images, (const float*)affines, nullptr, (Out*)out, H, W,
        S, norm, aligned, vector_out);
  }
}

int ingest(const void* images, const void* affines, const void* factors,
           void* out, int B, int H, int W, int out_h, int out_w, int in_kind,
           int out_kind, Norm norm, void* stream) {
  if (out_h != out_w) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int S = out_h;
  if (in_kind == 0 && out_kind == 0) {
    launch<uint8_t, float>(images, affines, factors, out, B, H, W, S, norm, s);
  } else if (in_kind == 0 && out_kind == 1) {
    launch<uint8_t, __nv_bfloat16>(images, affines, factors, out, B, H, W, S,
                                   norm, s);
  } else if (in_kind == 1 && out_kind == 0) {
    launch<float, float>(images, affines, factors, out, B, H, W, S, norm, s);
  } else if (in_kind == 1 && out_kind == 1) {
    launch<float, __nv_bfloat16>(images, affines, factors, out, B, H, W, S,
                                 norm, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// images (B, H, W, 3) uint8 (in_kind 0) or f32 in [0, 1] (in_kind 1);
// affines (B, 3, 3) f32 crop->image; out (B, out_h, out_w, 3) f32
// (out_kind 0) or bf16 (out_kind 1), square (out_h == out_w). Returns
// cudaGetLastError().
extern "C" int ingest_forward(const void* images, const void* affines,
                              void* out, int B, int H, int W, int out_h,
                              int out_w, int in_kind, int out_kind,
                              float mean0, float mean1, float mean2,
                              float std0, float std1, float std2,
                              void* stream) {
  const Norm norm = {{mean0, mean1, mean2}, {std0, std1, std2}};
  return ingest(images, affines, nullptr, out, B, H, W, out_h, out_w,
                in_kind, out_kind, norm, stream);
}

// As ingest_forward, with factors (B, 3) f32: the channel noise of each
// crop, applied to the sample and clipped to [0, 1] before normalising.
extern "C" int ingest_noise_forward(const void* images, const void* affines,
                                    const void* factors, void* out, int B,
                                    int H, int W, int out_h, int out_w,
                                    int in_kind, int out_kind, float mean0,
                                    float mean1, float mean2, float std0,
                                    float std1, float std2, void* stream) {
  if (!factors) return (int)cudaErrorInvalidValue;
  const Norm norm = {{mean0, mean1, mean2}, {std0, std1, std2}};
  return ingest(images, affines, factors, out, B, H, W, out_h, out_w,
                in_kind, out_kind, norm, stream);
}
