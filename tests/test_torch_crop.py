"""Parity of kernel K2's plain version (crop + normalise) with the JAX
package's ``jax_bilinear_crop`` followed by the normalisation of
``apply_from_full_images``.

uint8 and f32 images with rotated, scaled affines whose crops partly
leave the image (so the zero padding and its normalisation to
``-mean/std`` are exercised). Tolerance atol 1e-4 on normalised values
of order 1: the same f32 lerps, but XLA's dot rounds the source
coordinates (up to ~100 px here, one f32 ulp = 8e-6 px) differently from
the port's elementwise affine map, and a normalised channel changes by
up to 1/0.225 per pixel, so samples may differ by ~4e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.data.crop import crop_to_image_affine, jax_bilinear_crop
from shapy_tpu.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from shapy_tpu_torch.data.crop import crop_normalize

torch.set_num_threads(2)


def _jax_reference(images, affines, size):
    x = jnp.asarray(images)
    if jnp.issubdtype(x.dtype, jnp.integer):
        x = x.astype(jnp.float32) * (1.0 / 255.0)
    crops = jax_bilinear_crop(x, jnp.asarray(affines), (size, size))
    return np.asarray((crops - jnp.asarray(IMAGENET_MEAN))
                      / jnp.asarray(IMAGENET_STD))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_crop_normalize_matches_jax(dtype):
    rng = np.random.default_rng(0)
    H, W, size = 90, 70, 48
    if dtype == "uint8":
        images = rng.integers(0, 256, size=(3, H, W, 3), dtype=np.uint8)
    else:
        images = rng.uniform(size=(3, H, W, 3)).astype(np.float32)
    affines = np.stack([
        crop_to_image_affine([35.0, 45.0], 0.4, (size, size), rot_deg=25.0),
        crop_to_image_affine([10.0, 80.0], 0.5, (size, size), rot_deg=-40.0),
        crop_to_image_affine([60.0, 20.0], 0.3, (size, size)),
    ]).astype(np.float32)
    want = _jax_reference(images, affines, size)
    got = crop_normalize(torch.from_numpy(images), torch.from_numpy(affines),
                         size).numpy()
    assert got.shape == (3, size, size, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)
    # Crops that leave the image hold exactly normalised zeros there.
    outside = -np.asarray(IMAGENET_MEAN) / np.asarray(IMAGENET_STD)
    assert np.isclose(got[1], outside, atol=1e-6).all(-1).any()


def test_crop_normalize_bf16_output_is_the_rounded_f32():
    rng = np.random.default_rng(1)
    images = torch.from_numpy(
        rng.integers(0, 256, size=(2, 40, 50, 3), dtype=np.uint8))
    affines = torch.from_numpy(np.stack([
        crop_to_image_affine([25.0, 20.0], 0.2, (32, 32), rot_deg=10.0)] * 2
    ).astype(np.float32))
    f32 = crop_normalize(images, affines, 32)
    bf16 = crop_normalize(images, affines, 32, out_dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    torch.testing.assert_close(bf16, f32.to(torch.bfloat16), rtol=0, atol=0)
