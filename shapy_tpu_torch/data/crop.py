"""On-device crop + normalisation (port of ``jax_bilinear_crop`` in
``shapy_tpu/data/crop.py`` and the preprocessing of
``BodyRegressor.apply_from_full_images``).

:func:`crop_normalize` is the main-path entry: its CUDA path is kernel K2
(``csrc/ingest.cu``), which decodes uint8, samples bilinearly through the
crop->image affine, normalises and casts in one pass.
"""

from __future__ import annotations

from typing import Tuple

import torch

from shapy_tpu.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from shapy_tpu_torch.utils.cuda_kernels import CudaKernel, check_cuda_input

INGEST_KERNEL = CudaKernel("ingest.cu",
                           {"ingest_forward": "ppp iiiiiii ffffff p"})
_IN_KINDS = {torch.uint8: 0, torch.float32: 1}
_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1}


def bilinear_crop(images: torch.Tensor, affines: torch.Tensor,
                  res: Tuple[int, int] = (256, 256)) -> torch.Tensor:
    """images (B, H, W, C) float + crop->image affines (B, 3, 3) ->
    (B, res_h, res_w, C) crops; bilinear, zero outside the image (each of
    the four corners is tested on its own)."""
    B, H, W, C = images.shape
    out_h, out_w = res
    dev = images.device
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    gx, gy = gx.reshape(1, -1), gy.reshape(1, -1)
    # The affine map elementwise, (a0 x + a1 y) + a2, in K2's order: at
    # source coordinates of some hundreds of pixels a matmul's other
    # rounding moves the samples by 1e-4 of a pixel.
    A = affines.to(torch.float32)[..., None]
    sx = A[:, 0, 0] * gx + A[:, 0, 1] * gy + A[:, 0, 2]
    sy = A[:, 1, 0] * gx + A[:, 1, 1] * gy + A[:, 1, 2]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = sx - x0
    wy = sy - y0
    flat = images.reshape(B, H * W, C)

    def sample(yi, xi):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xi_c = torch.clamp(xi, 0, W - 1).long()
        yi_c = torch.clamp(yi, 0, H - 1).long()
        idx = (yi_c * W + xi_c)[..., None].expand(-1, -1, C)
        vals = torch.gather(flat, 1, idx)
        return torch.where(valid[..., None], vals, torch.zeros_like(vals))

    v00 = sample(y0, x0)
    v01 = sample(y0, x0 + 1)
    v10 = sample(y0 + 1, x0)
    v11 = sample(y0 + 1, x0 + 1)
    top = v00 * (1 - wx)[..., None] + v01 * wx[..., None]
    bot = v10 * (1 - wx)[..., None] + v11 * wx[..., None]
    out = top * (1 - wy)[..., None] + bot * wy[..., None]
    return out.reshape(B, out_h, out_w, C)


def crop_normalize_plain(images, affines, crop_size=256, mean=IMAGENET_MEAN,
                         std=IMAGENET_STD, out_dtype=torch.float32):
    """Plain version of K2: uint8 -> [0, 1], bilinear crop, ``(x - mean) /
    std``, cast to ``out_dtype``. Pixels outside the image are 0 before
    normalisation, so they come out as ``-mean / std``."""
    if not torch.is_floating_point(images):
        images = images.to(torch.float32) * (1.0 / 255.0)
    dev = images.device
    crops = bilinear_crop(images, affines, (crop_size, crop_size))
    mean_t = torch.tensor(mean, dtype=crops.dtype, device=dev)
    std_t = torch.tensor(std, dtype=crops.dtype, device=dev)
    return ((crops - mean_t) / std_t).to(out_dtype)


def crop_normalize(images: torch.Tensor, affines: torch.Tensor,
                   crop_size: int = 256, mean=IMAGENET_MEAN,
                   std=IMAGENET_STD, out_dtype: torch.dtype = torch.float32
                   ) -> torch.Tensor:
    """Crop + normalise full images for the backbone.

    images (B, H, W, 3) uint8 (or f32 in [0, 1]); affines (B, 3, 3) f32
    crop->image -> (B, crop_size, crop_size, 3) NHWC in ``out_dtype``.
    The plain version for CPU tensors, kernel K2 for CUDA tensors
    (forward only). ``out.permute(0, 3, 1, 2)`` is a channels_last NCHW
    view, no copy."""
    if images.device.type == "cpu":
        return crop_normalize_plain(images, affines, crop_size, mean, std,
                                    out_dtype)
    if images.device.type != "cuda":
        raise ValueError(f"crop_normalize: unsupported device {images.device}")
    if images.dtype not in _IN_KINDS:
        raise TypeError(f"crop_normalize: images dtype {images.dtype}")
    if out_dtype not in _OUT_KINDS:
        raise TypeError(f"crop_normalize: out_dtype {out_dtype}")
    B, H, W, C = images.shape
    dev = images.device
    check_cuda_input(images, "images", images.dtype, (B, H, W, 3), dev)
    check_cuda_input(affines, "affines", torch.float32, (B, 3, 3), dev)
    out = torch.empty((B, crop_size, crop_size, 3), dtype=out_dtype,
                      device=dev)
    if B == 0:
        return out
    INGEST_KERNEL.launches += 1
    INGEST_KERNEL.launch("ingest_forward", [
        images, affines, out, B, H, W, crop_size, crop_size,
        _IN_KINDS[images.dtype], _OUT_KINDS[out_dtype],
        *(float(m) for m in mean), *(float(s) for s in std)])
    return out
