// K2 ingest: uint8 decode + affine bilinear crop + ImageNet normalisation +
// cast, forward only.
//
// Replaces: shapy_tpu/data/crop.py:jax_bilinear_crop (line 96) together
// with the preprocessing of shapy_tpu/models/heads/regressor.py
// :BodyRegressor.apply_from_full_images (lines 531-542), which XLA runs as
// gathers and elementwise passes over f32 copies of the full images.
//
// What bounds it on the H100: memory and gather latency. Per output pixel
// it reads four 3-byte corners (mostly L1/L2 hits: neighbouring threads
// read neighbouring source pixels) and writes 6 B (bf16) or 12 B (f32);
// ~30 FLOPs per channel. A batch of 32 crops of 256x256 is 12.6 MB of bf16
// output, and the 480x360 uint8 sources are 16.6 MB.
//
// Design: one thread per output pixel, all three channels. The uint8 image
// is sampled directly (no f32 copy of the full image, which the plain
// version materialises); each of the four corners is tested for validity
// on its own and reads 0 outside, *before* normalisation, so outside pixels
// come out as -mean/std as in the JAX package. The result is normalised in
// f32 and written in the backbone's working dtype into an NHWC buffer,
// whose permute(0, 3, 1, 2) is already a channels_last NCHW tensor.
// Built with --fmad=false so the affine map and the lerps round as the
// plain PyTorch version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Norm {
  float mean[3];
  float std[3];
};

__device__ __forceinline__ float load(const uint8_t* p) {
  return (float)(*p) * (1.0f / 255.0f);
}
__device__ __forceinline__ float load(const float* p) { return *p; }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

template <typename In, typename Out>
__global__ void ingest_kernel(const In* __restrict__ images,
                              const float* __restrict__ affines,
                              Out* __restrict__ out, int H, int W, int out_h,
                              int out_w, Norm norm) {
  const int b = blockIdx.y;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= out_h * out_w) return;
  const float gx = (float)(pix % out_w);
  const float gy = (float)(pix / out_w);
  const float* A = affines + b * 9;
  const float sx = A[0] * gx + A[1] * gy + A[2];
  const float sy = A[3] * gx + A[4] * gy + A[5];
  const float x0 = floorf(sx), y0 = floorf(sy);
  const float wx = sx - x0, wy = sy - y0;
  const In* img = images + (size_t)b * H * W * 3;

  float v[4][3];
  const float cy[4] = {y0, y0, y0 + 1.f, y0 + 1.f};
  const float cx[4] = {x0, x0 + 1.f, x0, x0 + 1.f};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool valid = cx[k] >= 0.f && cx[k] <= (float)(W - 1) &&
                       cy[k] >= 0.f && cy[k] <= (float)(H - 1);
    if (valid) {
      const In* src = img + ((size_t)cy[k] * W + (size_t)cx[k]) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) v[k][c] = load(src + c);
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) v[k][c] = 0.f;
    }
  }
  Out* dst = out + ((size_t)b * out_h * out_w + pix) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float top = v[0][c] * (1.f - wx) + v[1][c] * wx;
    const float bot = v[2][c] * (1.f - wx) + v[3][c] * wx;
    const float val = top * (1.f - wy) + bot * wy;
    store(dst + c, (val - norm.mean[c]) / norm.std[c]);
  }
}

template <typename In, typename Out>
void launch(const void* images, const void* affines, void* out, int B, int H,
            int W, int out_h, int out_w, Norm norm, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const dim3 grid((out_h * out_w + kThreads - 1) / kThreads, B);
  ingest_kernel<In, Out><<<grid, kThreads, 0, stream>>>(
      (const In*)images, (const float*)affines, (Out*)out, H, W, out_h,
      out_w, norm);
}

}  // namespace

// images (B, H, W, 3) uint8 (in_kind 0) or f32 in [0, 1] (in_kind 1);
// affines (B, 3, 3) f32 crop->image; out (B, out_h, out_w, 3) f32
// (out_kind 0) or bf16 (out_kind 1). Returns cudaGetLastError().
extern "C" int ingest_forward(const void* images, const void* affines,
                              void* out, int B, int H, int W, int out_h,
                              int out_w, int in_kind, int out_kind,
                              float mean0, float mean1, float mean2,
                              float std0, float std1, float std2,
                              void* stream) {
  const Norm norm = {{mean0, mean1, mean2}, {std0, std1, std2}};
  cudaStream_t s = (cudaStream_t)stream;
  if (in_kind == 0 && out_kind == 0) {
    launch<uint8_t, float>(images, affines, out, B, H, W, out_h, out_w, norm, s);
  } else if (in_kind == 0 && out_kind == 1) {
    launch<uint8_t, __nv_bfloat16>(images, affines, out, B, H, W, out_h,
                                   out_w, norm, s);
  } else if (in_kind == 1 && out_kind == 0) {
    launch<float, float>(images, affines, out, B, H, W, out_h, out_w, norm, s);
  } else if (in_kind == 1 && out_kind == 1) {
    launch<float, __nv_bfloat16>(images, affines, out, B, H, W, out_h, out_w,
                                 norm, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
