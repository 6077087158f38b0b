"""K2's tiling plan on the CPU (``data/crop.py:ingest_plan``).

``csrc/ingest.cu`` gives a block a tile of output pixels, a lane a column
of it and a thread a run of rows, and stages the source pixels that a tile's bilinear
corners can read: the box that its four corner pixels map to, with the
+1 corner, clipped to the image. Here every output pixel must be covered
once, every in-image corner that a staged tile's pixels read (their
source coordinates rounded in f32 as the kernel and the plain version
compute them) must lie inside the tile's box, the box must be no larger
than those corners' range (clipped: no margin that would hide a box a
row short), and
a tile whose box holds more than the budget, or whose corners map to no
finite point, must take the direct regime. Cases: the served requests
(``flagship.synthetic_requests`` at batch 32 and 128), a magnification of
4, a 90 degree rotation and a crop wholly outside the image, each for
uint8 and f32 input; odd crop sizes and image widths. The card holds the
kernel bit-equal to ``crop_normalize_plain`` on the same cases
(``chip_smoke.py``, ``tests/test_torch_kernels_cuda.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from shapy_tpu_torch.data.crop import (
    INGEST_BOX_BYTES,
    INGEST_TILE,
    crop_normalize_plain,
    crop_to_image_affine,
    ingest_plan,
)
from shapy_tpu_torch.flagship import synthetic_requests

SOURCE = (Path(__file__).resolve().parents[1] / "shapy_tpu_torch" / "csrc"
          / "ingest.cu")
H, W, S = 360, 480, 256
ROWS = 8  # output rows a thread (kRows): a lane takes a column of its tile


def extreme_affines(H, W, S):
    """Magnification 4 (a 1024 px box onto S), a 90 degree rotation and
    a crop wholly outside the image (f32)."""
    return np.stack([
        crop_to_image_affine((W / 2, H / 2), 4 * S / 200, (S, S)),
        crop_to_image_affine((W / 2, H / 2), min(H, W) / 200, (S, S),
                             rot_deg=90.0),
        crop_to_image_affine((-3 * W, 2 * H), 1.0, (S, S), rot_deg=10.0),
    ]).astype(np.float32)


def _cases():
    served = {B: torch.from_numpy(synthetic_requests(B, H, W, S, 0)[1])
              for B in (32, 128)}
    return {"served32": served[32], "served128": served[128],
            "extreme": torch.from_numpy(extreme_affines(H, W, S))}


CASES = _cases()


def test_plan_constants_are_the_kernels():
    text = SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", text))
    assert int(consts["kTile"]) == INGEST_TILE
    sizes = {k: int(consts[k]) for k in ("kTile", "kWarps")}
    assert eval(consts["kRows"], sizes) == ROWS
    assert eval(consts["kBoxBytes"]) == INGEST_BOX_BYTES


def _aligned(Hi, Wi, dtype, data_ptr=0):
    """Whether ``ingest_plan`` stages a served crop's tiles: only where
    the images and their rows start 16-byte aligned."""
    A = CASES["served32"][:1]
    return bool(ingest_plan(A, Hi, Wi, S, dtype, data_ptr)["staged"].any())


def test_staging_unit_follows_the_alignment():
    assert _aligned(360, 480, torch.uint8)  # rows of 1440 bytes
    assert not _aligned(360, 480, torch.uint8, data_ptr=4)
    assert not _aligned(360, 484, torch.uint8)  # rows of 1452 bytes
    assert not _aligned(360, 482, torch.uint8)  # rows of 1446 bytes
    assert not _aligned(33, 45, torch.float32)  # rows of 540 bytes
    assert _aligned(360, 484, torch.float32)  # rows of 5808 bytes


@pytest.mark.parametrize("size", [256, 100, 37, 8])
def test_tiles_and_threads_cover_every_output_pixel_once(size):
    tiles = -(-size // INGEST_TILE)
    threads = INGEST_TILE * INGEST_TILE // ROWS
    seen = np.zeros((size, size), np.int64)
    for by in range(tiles):
        for bx in range(tiles):
            for t in range(threads):  # lane t % 32, rows from t // 32
                gx = bx * INGEST_TILE + t % 32
                for i in range(ROWS):
                    gy = by * INGEST_TILE + t // 32 * ROWS + i
                    if gy < size and gx < size:
                        seen[gy, gx] += 1
    assert (seen == 1).all()


def _corners(affines, size):
    """Each output pixel's four corners (B, size, size, 4) as the kernel
    and ``bilinear_crop`` compute them, (a0 x + a1 y) + a2 in f32."""
    g = torch.arange(size, dtype=torch.float32)
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    A = affines[:, :, :, None, None]
    sx = A[:, 0, 0] * gx + A[:, 0, 1] * gy + A[:, 0, 2]
    sy = A[:, 1, 0] * gx + A[:, 1, 1] * gy + A[:, 1, 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    return (torch.stack([x0, x0 + 1, x0, x0 + 1], -1),
            torch.stack([y0, y0, y0 + 1, y0 + 1], -1))


def _check_plan(affines, Hi, Wi, size, dtype):
    plan = ingest_plan(affines, Hi, Wi, size, dtype)
    box, pitch, staged = plan["box"], plan["pitch"], plan["staged"]
    tiles = -(-size // INGEST_TILE)
    assert box.shape == (affines.shape[0], tiles, tiles, 4)
    bw = (box[..., 2] - box[..., 0] + 1).clamp(min=0)
    bh = (box[..., 3] - box[..., 1] + 1).clamp(min=0)
    px = 3 * torch.empty((), dtype=dtype).element_size()
    # whole 16-byte chunks from the one that holds the row's first byte,
    # none for a box of no pixel
    lead = box[..., 0] * px % 16
    assert bool((pitch % 16 == 0).all())
    assert bool(((pitch >= lead + bw * px)
                 & (pitch < lead + bw * px + 16) | (bw == 0)).all())
    assert bool((pitch[bw == 0] == 0).all())
    fits = (pitch * bh <= INGEST_BOX_BYTES) & (Wi * px % 16 == 0)
    assert not bool((staged & ~fits).any())
    t = torch.arange(size) // INGEST_TILE
    for i in range(0, affines.shape[0], 8):  # 8 crops at a time
        cx, cy = _corners(affines[i:i + 8], size)
        inside = (cx >= 0) & (cx <= Wi - 1) & (cy >= 0) & (cy <= Hi - 1)
        tb = box[i:i + 8, t[:, None], t[None, :], None]  # each pixel's box
        in_box = ((cx >= tb[..., 0]) & (cx <= tb[..., 2])
                  & (cy >= tb[..., 1]) & (cy <= tb[..., 3]))
        st = staged[i:i + 8, t[:, None], t[None, :], None]
        assert bool((in_box | ~inside | ~st).all()), (
            "a read corner outside its tile's box")
        # tight: the corners' range over each tile, clipped, is the box
        ntile = affines[i:i + 8].shape[0], tiles, INGEST_TILE, tiles, (
            INGEST_TILE)
        pad = tiles * INGEST_TILE - size
        for k, (c, hi) in enumerate(((cx, Wi - 1), (cy, Hi - 1))):
            c = torch.nn.functional.pad(c.permute(0, 3, 1, 2),
                                        (0, pad, 0, pad), mode="replicate")
            c = c.permute(0, 2, 3, 1).reshape(*ntile, 4)
            lo = c.amin((2, 4, 5)).clamp(min=0)
            up = c.amax((2, 4, 5)).clamp(max=hi)
            fin = torch.isfinite(affines[i:i + 8]).all()
            if fin:
                assert torch.equal(lo.long(), box[i:i + 8, ..., k])
                assert torch.equal(up.long(), box[i:i + 8, ..., k + 2])
    # the box is clipped to the image
    assert bool((box[..., :2] >= 0).all())
    assert bool((box[..., 2] <= Wi - 1).all() & (box[..., 3] <= Hi - 1).all())
    return plan


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_read_corners_lie_inside_the_staged_box(case, dtype):
    plan = _check_plan(CASES[case], H, W, S, dtype)
    staged = plan["staged"]
    if case.startswith("served") and dtype == torch.uint8:
        assert bool(staged.all())  # the served path stages every tile
    if case == "extreme":
        # magnification 4: the tiles whose boxes lie inside the image
        # (128 x 128 source pixels) overflow the budget, the direct regime
        assert 0 < int((~staged[0]).sum()) < staged[0].numel()
        assert bool(staged[1].all()) == (dtype == torch.uint8)
        # wholly outside: an empty box, nothing staged
        box = plan["box"][2]
        assert bool(((box[..., 2] < box[..., 0])
                     | (box[..., 3] < box[..., 1])).all())


@pytest.mark.parametrize("Hi,Wi,size", [(50, 71, 100), (33, 45, 37),
                                        (360, 480, 8)])
def test_plan_on_odd_shapes(Hi, Wi, size):
    rng = np.random.default_rng(Wi)
    affines = np.stack([
        crop_to_image_affine((rng.uniform(0, Wi), rng.uniform(0, Hi)),
                             rng.uniform(0.05, 0.6) * min(Hi, Wi) / 200,
                             (size, size), rot_deg=rng.uniform(-180, 180))
        for _ in range(6)] + list(extreme_affines(Hi, Wi, size)))
    for dtype in (torch.uint8, torch.float32):
        _check_plan(torch.from_numpy(affines.astype(np.float32)), Hi, Wi,
                    size, dtype)


def test_non_finite_affines_take_the_direct_regime():
    A = torch.from_numpy(extreme_affines(H, W, S)[1:2]).repeat(2, 1, 1)
    A[0, 0, 0] = float("nan")
    A[1, 1, 2] = float("inf")
    assert not bool(ingest_plan(A, H, W, S)["staged"].any())


def test_a_crop_outside_the_image_is_its_normalised_zero():
    images = torch.full((1, H, W, 3), 200, dtype=torch.uint8)
    A = torch.from_numpy(extreme_affines(H, W, 64)[2:])
    out = crop_normalize_plain(images, A, 64)
    mean = torch.tensor([0.485, 0.456, 0.406])
    std = torch.tensor([0.229, 0.224, 0.225])
    assert torch.equal(out, ((0 - mean) / std).expand_as(out))


def test_a_box_right_of_the_image_stages_no_chunk():
    """A crop beside the image, on its rows: each tile's box has rows but
    no pixel, and copies nothing (its first chunk would lie past the
    row's end, past the last image's end on its last rows)."""
    A = torch.from_numpy(np.stack([crop_to_image_affine(
        (W + 200, H / 2), 0.5, (S, S))]).astype(np.float32))
    plan = _check_plan(A, H, W, S, torch.uint8)
    box = plan["box"]
    assert bool((box[..., 2] < box[..., 0]).all())
    assert bool((box[..., 3] >= box[..., 1]).any())
    assert bool((plan["pitch"] == 0).all()) and bool(plan["staged"].all())
