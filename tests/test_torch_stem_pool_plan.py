"""The tile plans of K11's backward (the ResNet max pool's gradient) and
K10's forward (the ResNet's 7x7 / stride-2 stem), on the CPU.

``layers.max_pool_backward_plan`` and ``layers.stem_plan`` are what the
wrappers pass to ``csrc/max_pool.cu`` and ``csrc/conv.cu``. The
geometry that the kernels build from a plan (K11: which pixels a tile
writes and which box of x it stages; K10: the groups of output pixels a
warp takes and each group's input box) is taken here from the kernels'
documented rules and their ``constexpr`` constants, read from the
sources. Each plan is checked at the shapes the port runs and at odd and
tiny ones: every output written once, every staged box holding what its
kernel reads, the regime and the shared memory. Two replays in plain
numpy follow each kernel's geometry (K11: the tile's box, its first
maxima and its 2 x 2 gathers; K10: the im2col view of a group's box, in
both regimes) and are held to the JAX package's ``reduce_window`` VJP
(bit-equal) and to a float64 convolution (1e-12 relative: the same
products in another order).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu_torch.models.backbones import layers
from shapy_tpu_torch.models.backbones.layers import (
    max_pool_backward_plan,
    stem_plan,
)

CSRC = Path(__file__).resolve().parents[1] / "shapy_tpu_torch" / "csrc"


def _constants(source: str) -> dict:
    """The file-scope ``constexpr int k...`` constants of a kernel source
    that are integer expressions of those before them (C's division of
    positive integers: ``//``)."""
    consts = {}
    text = (CSRC / source).read_text()
    for decl in re.findall(r"^constexpr int (k\w+ *=[^;]+);", text, re.M):
        for part in decl.split(","):
            name, expr = (t.strip() for t in part.split("=", 1))
            try:
                consts[name] = int(eval(expr.replace("/", "//"), {},
                                        dict(consts)))
            except (NameError, SyntaxError):
                pass
    return consts


POOL_CU, CONV_CU = _constants("max_pool.cu"), _constants("conv.cu")

# An H100's shared memory: what a block may take, and an SM's (each block
# also holds 1 KB for the system).
BLOCK_SMEM, SM_SMEM = 232448, 233472

POOL_SHAPES = [  # (N, C, H, W, dtype)
    (48, 64, 128, 128, torch.bfloat16),  # a ResNet train step
    (48, 64, 128, 128, torch.float32),   # two 32-channel slices
    (2, 64, 33, 17, torch.bfloat16),
    (2, 64, 35, 35, torch.bfloat16),     # Ho 18: ragged, halo at the edge
    (2, 64, 37, 21, torch.bfloat16),     # Ho 19
    (2, 128, 36, 38, torch.bfloat16),    # two 64-channel slices
    (3, 8, 21, 19, torch.bfloat16),      # 8-channel rows
    (3, 4, 19, 21, torch.float32),       # 4-channel rows
    (1, 8, 1, 1, torch.bfloat16),
    (2, 8, 2, 3, torch.bfloat16),
    (2, 16, 17, 33, torch.float32),
    (2, 24, 9, 9, torch.bfloat16),       # 3 chunks: slices of 1
]


def _pool_plan(N, C, H, W, dtype):
    esize = torch.empty((), dtype=dtype).element_size()
    return max_pool_backward_plan(N, H, W, C, esize), esize


def _pool_tiles(plan, H, W):
    """The tiles a row and a column of the kernel's grid: ceil(Ho / th),
    ceil(Wo / tw)."""
    ho, wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    return -(-ho // plan.th), -(-wo // plan.tw)


def _pool_pixels(plan, ti, tj):
    """The input rows and columns (first, last) whose dx tile (ti, tj)
    writes, before clipping to the image."""
    i0, j0 = ti * plan.th, tj * plan.tw
    return ((2 * i0, 2 * i0 + 2 * plan.th - 1),
            (2 * j0, 2 * j0 + 2 * plan.tw - 1))


def _pool_box(plan, ti, tj):
    """Tile (ti, tj)'s staged rows and columns of x, (first, last) each,
    before clipping to the image: the taps of windows i0 .. i0 + th."""
    i0, j0 = ti * plan.th, tj * plan.tw
    return ((2 * i0 - 1, 2 * i0 + 2 * plan.th + 1),
            (2 * j0 - 1, 2 * j0 + 2 * plan.tw + 1))


@pytest.mark.parametrize("shape", POOL_SHAPES, ids=str)
def test_pool_plan_writes_every_pixel_once(shape):
    """The tiles' pixels (rows and columns 2 i0 .. 2 i0 + 2 th - 1 of each
    tile, clipped) cover every input pixel once, and the slices every
    channel once; a slice is a power of two of 16-byte chunks."""
    N, C, H, W = shape[:4]
    plan, esize = _pool_plan(*shape)
    chunks = plan.cs * esize // 16
    assert plan.cs * esize % 16 == 0 and chunks & (chunks - 1) == 0
    assert C % plan.cs == 0
    assert plan.cs * esize <= layers._POOL_SLICE_BYTES
    tiles_h, tiles_w = _pool_tiles(plan, H, W)
    count = np.zeros((H, W), dtype=np.int64)
    for ti in range(tiles_h):
        for tj in range(tiles_w):
            (r0, r1), (c0, c1) = _pool_pixels(plan, ti, tj)
            count[max(r0, 0):min(r1, H - 1) + 1,
                  max(c0, 0):min(c1, W - 1) + 1] += 1
    assert (count == 1).all()
    ho, wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    assert plan.th == min(layers._POOL_TILE, ho)
    assert plan.tw == min(layers._POOL_TILE, wo)


@pytest.mark.parametrize("shape", POOL_SHAPES, ids=str)
def test_pool_plan_boxes_hold_every_tap(shape):
    """Every window that a tile's pixels receive from is one of the tile's
    staged windows (i0 .. i0 + th, j0 .. j0 + tw), and each of its taps in
    the image lies in the tile's staged box of x, which one TMA box of at
    most 256 pixels a side brings."""
    N, C, H, W = shape[:4]
    plan, _ = _pool_plan(*shape)
    assert 2 * plan.th + 3 <= 256 and 2 * plan.tw + 3 <= 256
    ho, wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    tiles_h, tiles_w = _pool_tiles(plan, H, W)
    for ti in range(tiles_h):
        for tj in range(tiles_w):
            (r0, r1), (c0, c1) = _pool_pixels(plan, ti, tj)
            (br0, br1), (bc0, bc1) = _pool_box(plan, ti, tj)
            wins_r = {i for h in range(r0, min(r1, H - 1) + 1)
                      for i in range(h // 2, min(ho - 1, (h + 1) // 2) + 1)}
            wins_c = {j for w in range(c0, min(c1, W - 1) + 1)
                      for j in range(w // 2, min(wo - 1, (w + 1) // 2) + 1)}
            i0, j0 = ti * plan.th, tj * plan.tw
            assert wins_r <= set(range(i0, i0 + plan.th + 1))
            assert wins_c <= set(range(j0, j0 + plan.tw + 1))
            taps_r = {h for i in wins_r for h in range(2 * i - 1, 2 * i + 2)
                      if 0 <= h < H}
            taps_c = {w for j in wins_c for w in range(2 * j - 1, 2 * j + 2)
                      if 0 <= w < W}
            assert taps_r <= set(range(br0, br1 + 1))
            assert taps_c <= set(range(bc0, bc1 + 1))


@pytest.mark.parametrize("shape", POOL_SHAPES, ids=str)
def test_pool_plan_shared_memory_within_budget(shape):
    """A tile's shared memory, as ``max_pool.cu`` lays it out (x's box of
    (2 th + 3) x (2 tw + 3) pixels, the dy of its (th + 1) x (tw + 1)
    windows, their taps at 16 bits a channel, each on a 128-byte
    boundary; the mbarrier; 128 bytes to align the base), stays within a
    block's limit (the kernel's ``kMaxSmem``), and three blocks share an
    SM at any shape."""
    plan, esize = _pool_plan(*shape)

    def up(b):
        return -(-b // 128) * 128

    box = (2 * plan.th + 3) * (2 * plan.tw + 3)
    win = (plan.th + 1) * (plan.tw + 1)
    smem = (up(box * plan.cs * esize) + up(win * plan.cs * esize)
            + up(win * plan.cs * 2) + 8 + 128)
    assert smem <= POOL_CU["kMaxSmem"] == BLOCK_SMEM
    assert 3 * (smem + 1024) <= SM_SMEM


# A pixel (2i + dh, 2j + dw) of window (i, j)'s 2 x 2 block and the tap it
# is of windows (i, j), (i, j + 1), (i + 1, j), (i + 1, j + 1), in that
# (row-major) order; -1: not a tap of that window.
BLOCK_TAPS = {(0, 0): (4, -1, -1, -1), (0, 1): (5, 3, -1, -1),
              (1, 0): (7, -1, 1, -1), (1, 1): (8, 6, 2, 0)}


def _pool_tiles_replay(plan, dy, x):
    """dx as the kernel's tiles make it, in numpy (NHWC): each tile's
    windows' first maxima from its box (taps out of the image skipped by
    their coordinates), then each owned window's 2 x 2 pixels summing in
    f32, in the windows' row-major order, the dy of those whose maximum
    they are."""
    N, H, W, C = x.shape
    ho, wo = dy.shape[1:3]
    dx = np.full((N, H, W, C), np.nan, dtype=np.float32)
    tiles_h, tiles_w = _pool_tiles(plan, H, W)
    for ti in range(tiles_h):
        for tj in range(tiles_w):
            (br0, br1), (bc0, bc1) = _pool_box(plan, ti, tj)
            i0, j0 = ti * plan.th, tj * plan.tw
            code = {}
            for i in range(i0, min(i0 + plan.th + 1, ho)):
                for j in range(j0, min(j0 + plan.tw + 1, wo)):
                    best = arg = None
                    for r in range(3):
                        for t in range(3):
                            h, w = 2 * i - 1 + r, 2 * j - 1 + t
                            if not (0 <= h < H and 0 <= w < W):
                                continue
                            assert br0 <= h <= br1 and bc0 <= w <= bc1
                            v = x[:, h, w]
                            if best is None:
                                best = v
                                arg = np.full(v.shape, 3 * r + t)
                            else:
                                more = v > best
                                best = np.where(more, v, best)
                                arg = np.where(more, 3 * r + t, arg)
                    code[i, j] = arg
            for i in range(i0, min(i0 + plan.th, ho)):
                for j in range(j0, min(j0 + plan.tw, wo)):
                    for (dh, dw), taps in BLOCK_TAPS.items():
                        if 2 * i + dh >= H or 2 * j + dw >= W:
                            continue
                        acc = np.zeros((N, C), dtype=np.float32)
                        for u, tap in enumerate(taps):
                            win = (i + (u >> 1), j + (u & 1))
                            if tap < 0 or win not in code:
                                continue
                            acc = acc + np.where(code[win] == tap,
                                                 dy[:, win[0], win[1]],
                                                 np.float32(0))
                        dx[:, 2 * i + dh, 2 * j + dw] = acc
    return dx


@pytest.mark.parametrize("shape", [(2, 8, 33, 17), (3, 8, 21, 19),
                                   (2, 8, 35, 35), (1, 8, 1, 1),
                                   (2, 8, 2, 3), (2, 8, 20, 14),
                                   (2, 8, 36, 38), (1, 8, 37, 21),
                                   (2, 16, 18, 34), (1, 8, 34, 33),
                                   (2, 8, 3, 5), (1, 8, 32, 31)], ids=str)
def test_pool_tiles_replay_matches_jax_vjp(shape):
    """The replay of the kernel's tiles (several a side where Ho or Wo
    passes 8, the last ragged) is bit-equal to ``jax.vjp`` of the JAX
    package's ``reduce_window`` max (3x3 / stride 2 / pad 1, init -inf):
    small integers after a ReLU, so that most windows tie, and an
    all-zero corner; f32 (bf16 rounds the same f32 sum once)."""
    N, C, H, W = shape
    rng = np.random.default_rng(17 + H + W)
    x = np.clip(rng.integers(-2, 3, (N, H, W, C)), 0, None).astype(np.float32)
    x[0, :6, :6] = 0.0
    ho, wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    dy = rng.standard_normal((N, ho, wo, C)).astype(np.float32)

    def pool(v):
        return jax.lax.reduce_window(v, -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                     (1, 2, 2, 1),
                                     ((0, 0), (1, 1), (1, 1), (0, 0)))

    _, vjp = jax.vjp(pool, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(dy))[0])
    plan = max_pool_backward_plan(N, H, W, C, 4)
    got = _pool_tiles_replay(plan, dy, x)
    assert np.array_equal(got, want)


STEM_SHAPES = [(32, 256), (48, 256), (128, 256), (32, 224), (3, 61),
               (3, 301), (2, 64)]
# stem7_kernel's geometry: a warp's group of kStemGroup output pixels of a
# row; kStemWarps warps a block; its box of kStemRows input rows x
# kStemBox halves of a row (3 W halves: NHWC with 3 channels); pixel m of
# the group reads K element (r, j), j < kStemJ, at half 6 m + j of row r
# of its patch, which starts at half 6 wo0 - 9 (pad 3 at stride 2).
GROUP, WARPS = CONV_CU["kStemGroup"], CONV_CU["kStemWarps"]
ROWS, BOX, SHIFT, TAPS = (CONV_CU["kStemRows"], CONV_CU["kStemBox"],
                          CONV_CU["kStemShift"], CONV_CU["kStemJ"])


def _stem_groups(plan, n, side):
    """(image, output row, first pixel) of each group that each warp of
    the kernel's grid takes, as ``stem7_kernel`` walks them: warp gw of nw
    takes groups gw, gw + nw, ...; group (i Ho + ho) ceil(Wo / GROUP) +
    wo0 / GROUP holds pixels wo0 .. wo0 + GROUP - 1 below Wo of row ho
    of image i. The grid: ``plan.grid`` blocks, no more than the groups
    fill."""
    ho = wo = (side - 1) // 2 + 1
    per_row = -(-wo // GROUP)
    groups = n * ho * per_row
    nw = min(plan.grid, -(-groups // WARPS)) * WARPS
    grp = np.concatenate([np.arange(gw, groups, nw) for gw in range(nw)])
    return grp // per_row // ho, grp // per_row % ho, grp % per_row * GROUP


@pytest.mark.parametrize("n,side", STEM_SHAPES, ids=str)
def test_stem_plan_writes_every_pixel_once(n, side):
    """K10's warps, on the plan's grid, take every group once and so
    write every output pixel once."""
    plan = stem_plan(n, side, side, 64, 2, torch.bfloat16)
    assert 1 <= plan.grid <= layers._STEM_BLOCKS
    ho = wo = (side - 1) // 2 + 1
    count = np.zeros((n, ho, wo), dtype=np.int64)
    for img, h, wo0 in zip(*_stem_groups(plan, n, side)):
        count[img, h, wo0:min(wo0 + GROUP, wo)] += 1
    assert (count == 1).all()


def _stem_box(plan, h, wo0):
    """The input rows (first, last) and row halves (first, last) of the
    group at (h, wo0)'s box, before clipping to the image: the TMA box
    from kStemShift halves before the patch (staged), else the patch's
    first half on (direct)."""
    first = 6 * wo0 - 9 - (SHIFT if plan.staged else 0)
    return (2 * h - 3, 2 * h - 3 + ROWS - 1), (first, first + BOX - 1)


@pytest.mark.parametrize("n,side", STEM_SHAPES, ids=str)
def test_stem_plan_boxes_cover_each_patch(n, side):
    """Each group's box covers the group's patch: the 7 input rows 2 ho -
    3 .. 2 ho + 3 and the 6 x 32 + 24 halves from 6 wo0 - 9 (pad 3 at
    stride 2, 3 channels), padding included. Staged, the box is one TMA
    box (a start on a 16-byte boundary, at most 256 halves, 16-byte
    wide), and the patch is what stays of it once the warp moves it
    kStemShift halves down a chunk at a time, its last chunk dropped."""
    plan = stem_plan(n, side, side, 64, 2, torch.bfloat16)
    ho = wo = (side - 1) // 2 + 1
    assert ROWS == layers.STEM_K and BOX <= 256 and BOX % 8 == 0
    for h in (0, 1, ho // 2, ho - 1):
        for wo0 in range(0, wo, GROUP):
            (r0, r1), (q0, q1) = _stem_box(plan, h, wo0)
            assert (r0, r1) == (2 * h - 3, 2 * h + 3)
            first, last = 6 * wo0 - 9, 6 * wo0 - 9 + 6 * GROUP + TAPS - 1
            if plan.staged:
                assert q0 % 8 == 0 and 0 <= first - q0 == SHIFT < 8
                assert last - first < BOX - 8
            else:
                assert q0 == first and last <= q1


@pytest.mark.parametrize("n,side", STEM_SHAPES, ids=str)
def test_stem_plan_regime(n, side):
    """TMA stages the boxes where an input row's 6 W bytes are a multiple
    of 16 (every ResNet crop); else the warp copies them (the direct
    regime); f32, stride 1 and other widths take the general stem
    kernels (grid 0)."""
    plan = stem_plan(n, side, side, 64, 2, torch.bfloat16)
    assert plan.grid == layers._STEM_BLOCKS
    assert plan.staged == (6 * side % 16 == 0)
    assert plan.staged == (side in (256, 224, 64))
    for dt, stride, cout in ((torch.float32, 2, 64),
                             (torch.bfloat16, 1, 64),
                             (torch.bfloat16, 2, 32)):
        assert stem_plan(n, side, side, cout, stride, dt).grid == 0


@pytest.mark.parametrize("side", [64, 61])
def test_stem_box_view_matches_conv(side):
    """The im2col view the kernel reads from each group's box (pixel m, K
    element (r, j) of 7 rows of 24, the weight zero past each row's 21:
    half 6m + j of row r of the patch), with the box filled as TMA or
    the warp fills it (zeros out of the image) and, staged, moved
    kStemShift halves down, gives the 7x7 / stride-2 / pad-3 conv
    (float64, within 1e-12 of the largest |y|): staged at 64, direct at
    61."""
    n = 2
    rng = np.random.default_rng(19)
    x = rng.standard_normal((n, side, side, 3))
    w = rng.standard_normal((64, 7, 7, 3))
    plan = stem_plan(n, side, side, 64, 2, torch.bfloat16)
    assert plan.staged == (side == 64)
    ho = wo = (side - 1) // 2 + 1
    rows = x.reshape(n, side, side * 3)
    wk = np.zeros((64, 7, TAPS))
    wk[:, :, :21] = w.reshape(64, 7, 21)
    y = np.zeros((n, ho, wo, 64))
    for img in range(n):
        for h in range(ho):
            for wo0 in range(0, wo, GROUP):
                (r0, _), (q0, q1) = _stem_box(plan, h, wo0)
                box = np.zeros((ROWS, BOX))
                for r in range(ROWS):
                    if 0 <= r0 + r < side:
                        lo, hi = max(q0, 0), min(q1 + 1, 3 * side)
                        box[r, lo - q0:hi - q0] = rows[img, r0 + r, lo:hi]
                if plan.staged:
                    box = box[:, SHIFT:BOX - 8 + SHIFT]
                for m in range(min(GROUP, wo - wo0)):
                    a = box[:, 6 * m:6 * m + TAPS]
                    y[img, h, wo0 + m] = np.einsum("rj,orj->o", a, wk)
    want = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(w).permute(0, 3, 1, 2), None, 2, 3)
    want = want.permute(0, 2, 3, 1).numpy()
    assert np.abs(y - want).max() <= 1e-12 * np.abs(want).max()
