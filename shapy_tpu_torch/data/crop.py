"""On-device crop + normalisation (port of ``jax_bilinear_crop`` in
``shapy_tpu/data/crop.py`` and the preprocessing of
``BodyRegressor.apply_from_full_images``).

:func:`crop_normalize` is the main-path entry: its CUDA path is kernel K2
(``csrc/ingest.cu``), which decodes uint8, samples bilinearly through the
crop->image affine, normalises and casts in one pass.

``IMAGENET_MEAN`` / ``IMAGENET_STD``, :func:`crop_to_image_affine`,
:func:`image_to_crop_affine`, :func:`crop_image` and
:func:`transform_points` are numpy copies of the JAX package's
(``data/transforms.py``, ``data/crop.py``): the port imports nothing of
``shapy_tpu``. :func:`crop_image` is the host-side ``cv2.warpAffine`` crop
of the data loader; it imports ``cv2`` when called, and the evaluation
path, which crops on the device, never calls it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from shapy_tpu_torch.utils.cuda_kernels import (
    CudaKernel,
    check_cuda_input,
    check_no_grad,
)

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
REF_BBOX_SIZE = 200.0

INGEST_KERNEL = CudaKernel("ingest.cu",
                           {"ingest_forward": "ppp iiiiiii ffffff p",
                            "ingest_noise_forward": "pppp iiiiiii ffffff p"})
_IN_KINDS = {torch.uint8: 0, torch.float32: 1}
_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1}
# K2's tiles (csrc/ingest.cu): a block a tile of INGEST_TILE^2 output
# pixels; a tile's footprint is staged in shared memory where it fits
# INGEST_BOX_BYTES.
INGEST_TILE = 32
INGEST_BOX_BYTES = 24 * 1024


def crop_to_image_affine(center: Sequence[float], scale: float,
                         res: Tuple[int, int], rot_deg: float = 0.0
                         ) -> np.ndarray:
    """3x3 f64 matrix mapping crop pixel coords -> image pixel coords: the
    crop spans ``200 * scale`` px centred at ``center``, optionally
    rotated by ``rot_deg`` about the crop centre (the hourglass
    convention of the reference's ``get_transform``, inverted)."""
    h = REF_BBOX_SIZE * scale
    out_h, out_w = res
    A = np.array([[h / out_w, 0.0, center[0] - 0.5 * h],
                  [0.0, h / out_h, center[1] - 0.5 * h],
                  [0.0, 0.0, 1.0]], dtype=np.float64)
    if rot_deg != 0.0:
        rad = np.deg2rad(rot_deg)
        sn, cs = np.sin(rad), np.cos(rad)
        c = np.array([out_w / 2.0, out_h / 2.0])
        R = np.array([[cs, -sn, c[0] - cs * c[0] + sn * c[1]],
                      [sn, cs, c[1] - sn * c[0] - cs * c[1]],
                      [0.0, 0.0, 1.0]])
        A = A @ R
    return A


def image_to_crop_affine(center, scale, res, rot_deg: float = 0.0
                         ) -> np.ndarray:
    """The inverse of :func:`crop_to_image_affine`."""
    return np.linalg.inv(crop_to_image_affine(center, scale, res, rot_deg))


def crop_image(img: np.ndarray, center, scale: float,
               res: Tuple[int, int] = (256, 256), rot_deg: float = 0.0
               ) -> np.ndarray:
    """The (res x res) crop by one host-side affine warp (``cv2``, bilinear,
    its fixed-point 1/32-pixel coordinates)."""
    import cv2

    M = image_to_crop_affine(center, scale, res, rot_deg)[:2]
    return cv2.warpAffine(img, M.astype(np.float32), (res[1], res[0]),
                          flags=cv2.INTER_LINEAR).astype(np.float32)


def transform_points(points: np.ndarray, affine: np.ndarray) -> np.ndarray:
    """Apply a 3x3 affine to (..., 2) points."""
    ph = np.concatenate([points, np.ones_like(points[..., :1])], axis=-1)
    return (ph @ affine.T)[..., :2]


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
                         std=IMAGENET_STD, out_dtype=torch.float32,
                         factors=None):
    """Plain version of K2: uint8 -> [0, 1], bilinear crop, with
    ``factors`` (B, 3) the channel noise ``clip(x * f, 0, 1)``, then
    ``(x - mean) / std``, cast to ``out_dtype``. Pixels outside the image
    are 0 before normalisation, so they come out as ``-mean / std``."""
    if not torch.is_floating_point(images):
        images = images.to(torch.float32) * (1.0 / 255.0)
    dev = images.device
    crops = bilinear_crop(images, affines, (crop_size, crop_size))
    if factors is not None:
        crops = torch.clamp(crops * factors.to(crops.dtype)[:, None, None],
                            0.0, 1.0)
    mean_t = torch.tensor(mean, dtype=crops.dtype, device=dev)
    std_t = torch.tensor(std, dtype=crops.dtype, device=dev)
    return ((crops - mean_t) / std_t).to(out_dtype)


def ingest_plan(affines: torch.Tensor, H: int, W: int, crop_size: int,
                in_dtype: torch.dtype = torch.uint8, data_ptr: int = 0
                ) -> dict:
    """K2's tiles as the kernel finds them, in its f32 arithmetic, on any
    device: for each crop and tile (B, tiles, tiles; rows of tiles first)
    ``box``, the footprint's source pixels (x0, y0, x1, y1), inclusive,
    ``pitch``, the bytes of shared memory a row of it takes, and
    ``staged``, whether the tile stages it (else it reads its corners
    from the image). ``data_ptr`` is the images' address.

    The box is where the tile's four corner pixels map, (a0 x + a1 y) +
    a2 rounded in f32, from floor(min) to floor(max) + 1 (the +1 corner),
    clipped to the image: each of those roundings is monotone, so no
    pixel of the tile maps outside its corners' range. A box of no pixel
    has x1 < x0 or y1 < y0 and stages nothing. A row of it is staged as
    whole 16-byte chunks of the image's row, from the chunk that holds
    its first byte. A tile is staged where the images and their rows
    start 16-byte aligned, its rows take at most ``INGEST_BOX_BYTES`` and
    its corners map to finite points."""
    px = 3 * torch.empty((), dtype=in_dtype).element_size()
    aligned = data_ptr % 16 == 0 and W * px % 16 == 0
    S = crop_size
    A = affines.to(torch.float32)
    starts = torch.arange(0, S, INGEST_TILE, device=A.device)
    ends = torch.clamp(starts + INGEST_TILE, max=S) - 1
    g = torch.stack([starts, ends], -1).to(torch.float32)  # (tiles, 2)
    gx = g[None, None, :, None, :]  # (1, 1, tx, 1, corner x)
    gy = g[None, :, None, :, None]  # (1, ty, 1, corner y, 1)

    def coord(r):
        a = [A[:, r, k, None, None, None, None] for k in range(3)]
        return (a[0] * gx + a[1] * gy + a[2]).flatten(-2)

    sx, sy = coord(0), coord(1)  # (B, ty, tx, 4)
    finite = (torch.isfinite(sx) & torch.isfinite(sy)).all(-1)
    box = torch.stack([
        torch.clamp(torch.floor(sx.amin(-1)), min=0),
        torch.clamp(torch.floor(sy.amin(-1)), min=0),
        torch.clamp(torch.floor(sx.amax(-1)) + 1, max=W - 1),
        torch.clamp(torch.floor(sy.amax(-1)) + 1, max=H - 1)], -1)
    box = torch.where(finite[..., None], box, torch.zeros_like(box))
    box = box.to(torch.int64)
    bw = torch.clamp(box[..., 2] - box[..., 0] + 1, min=0)
    bh = torch.clamp(box[..., 3] - box[..., 1] + 1, min=0)
    lead = box[..., 0] * px % 16
    pitch = torch.where(bw > 0, (lead + bw * px + 15) // 16 * 16, 0)
    staged = finite & (pitch * bh <= INGEST_BOX_BYTES) & aligned
    return {"box": box, "pitch": pitch, "staged": staged}


def crop_normalize(images: torch.Tensor, affines: torch.Tensor,
                   crop_size: int = 256, mean=IMAGENET_MEAN,
                   std=IMAGENET_STD, out_dtype: torch.dtype = torch.float32,
                   factors: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Crop + normalise full images for the backbone.

    images (B, H, W, 3) uint8 (or f32 in [0, 1]); affines (B, 3, 3) f32
    crop->image -> (B, crop_size, crop_size, 3) NHWC in ``out_dtype``.
    ``factors`` (B, 3) f32, the training's channel noise, multiplies each
    crop's channels and clips them to [0, 1] before the normalisation
    (the JAX package's ``ChannelNoise`` between its ``Crop`` and
    ``Normalize``). The plain version for CPU tensors, kernel K2 for CUDA
    tensors (forward only; bit-equal to the plain version, its tiles as
    :func:`ingest_plan` has them; ``ingest_noise_forward`` with factors).
    ``out.permute(0, 3, 1, 2)`` is a channels_last NCHW view, no copy."""
    if images.device.type == "cpu":
        return crop_normalize_plain(images, affines, crop_size, mean, std,
                                    out_dtype, factors)
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
    check_no_grad(images, "images")
    check_no_grad(affines, "affines")
    if factors is not None:
        check_cuda_input(factors, "factors", torch.float32, (B, 3), dev)
        check_no_grad(factors, "factors")
    out = torch.empty((B, crop_size, crop_size, 3), dtype=out_dtype,
                      device=dev)
    if B == 0:
        return out
    args = [images, affines, out, B, H, W, crop_size, crop_size,
            _IN_KINDS[images.dtype], _OUT_KINDS[out_dtype],
            *(float(m) for m in mean), *(float(s) for s in std)]
    if factors is None:
        INGEST_KERNEL.launch("ingest_forward", args)
    else:
        INGEST_KERNEL.launch("ingest_noise_forward", [*args[:2], factors,
                                                      *args[2:]])
    return out
