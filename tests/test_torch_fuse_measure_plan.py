"""The shape-only plans of K5-fuse's backward and K1's forward, replayed on
the CPU (neither kernel runs here), and the fusion gradient's plain version
in the kernel's summation order against ``jax.vjp``.

* ``hr_fuse_backward_plan``: for all 26 fusion targets of HRNet-W48 at
  64^2 and 256^2 crops, in bf16 and f32, the tiles' threads (their index
  arithmetic as ``csrc/hr_fuse.cu`` does it) read every fine pixel's
  channel vector once and write every coarse pixel of each shifted term
  once, each from the threads of its own box; the kernel's f32 tree,
  replayed from those indices, gives ``hr_fuse_backward_plain``'s bits.
* ``measure_plan``: the CTAs of each plane's cluster walk every position
  once and in order, those of the mass cluster every face, for all F =
  20,908 faces, the eval subsets and small meshes.
* ``hr_fuse_backward_plain`` against ``jax.vjp`` of ``relu(x +
  nearest_upsample(t, 2^s) + ...)`` (the JAX package's ``_fuse`` sum) at
  batch 2, 16^2, shifts 0-3: f32 within 1e-6 of the largest value (XLA
  sums the upsample's adjoint in another order), bf16 within one bf16
  step (rounded once from an f32 sum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.models.backbones import layers as jlayers
from shapy_tpu_torch.measure.measurements import (
    _K1_MAX_CLUSTER,
    measure_plan,
)
from shapy_tpu_torch.models.backbones import hrnet
from shapy_tpu_torch.models.backbones.hrnet import (
    hr_fuse_backward_plain,
    hr_fuse_backward_plan,
)
from shapy_tpu_torch.models.backbones.layers import bf16_step


def _w48_targets(crop: int):
    """(channels, side, shifts) of each of the 26 fusion targets of a
    W48 forward: stage 2's module, stage 3's four and stage 4's three;
    target i of n branches sums the upsampled j > i (shift j - i), then the
    stride-2 chains j < i (shift 0)."""
    out = []
    for stage in ("stage2", "stage3", "stage4"):
        modules, n = hrnet.W48_STAGES[stage][:2]
        chans = hrnet._branch_channels(stage)
        for _ in range(modules):
            for i in range(n):
                shifts = [j - i for j in range(i + 1, n)] + [0] * i
                out.append((chans[i], (crop // 4) >> i, shifts))
    return out


def _fuse_threads(plan, N: int, H: int, W: int):
    """Every thread of the plan's launch, as ``hr_fuse_backward_kernel``
    finds its place: (n, h0, w0, channel vector, micro-box row, column)."""
    bx, by, t = np.meshgrid(np.arange(plan.grid[0]), np.arange(plan.grid[1]),
                            np.arange(plan.threads), indexing="ij")
    bx, by, t = bx.ravel(), by.ravel(), t.ravel()
    cv = t % plan.cs
    col = t // plan.cs % plan.tw
    row = t // plan.cs // plan.tw
    rt = bx // plan.col_tiles
    ct = bx - rt * plan.col_tiles
    hs = H >> plan.shift
    n = rt // hs
    h0 = ((rt - n * hs) << plan.shift) + row * plan.side
    w0 = (ct * plan.tw + col) * plan.side
    c = by * plan.cs + cv
    return n, h0, w0, c, row, col


@pytest.mark.parametrize("crop", [64, 256])
@pytest.mark.parametrize("element_size", [2, 4], ids=["bf16", "f32"])
def test_fuse_backward_tiles_cover_every_pixel_once(crop, element_size):
    targets = _w48_targets(crop)
    assert len(targets) == 26
    N = 2
    for C, side, shifts in targets:
        plan = hr_fuse_backward_plan(N, C, side, side, shifts, element_size)
        cv = C * element_size // 16
        rows = (1 << plan.shift) // plan.side
        assert plan.shift == max(shifts)
        assert plan.threads == rows * plan.tw * plan.cs <= 256
        n, h0, w0, c, row, col = _fuse_threads(plan, N, side, side)
        fine = np.zeros((N, side, side, cv), np.int64)
        for dh in range(plan.side):
            for dw in range(plan.side):
                np.add.at(fine, (n, h0 + dh, w0 + dw, c), 1)
        assert (fine == 1).all(), (C, side, shifts)
        for level in range(1, plan.shift + 1):
            # level 1: every thread; level l: the threads at the corner of
            # a 2^(l-1) x 2^(l-1) block of micro boxes inside the tile
            k = 1 << (level - 1)
            w = (row % k == 0) & (col % k == 0) if level > 1 else \
                np.ones_like(row, bool)
            assert ((row[w] + k <= rows) & (col[w] + k <= plan.tw)).all()
            assert ((h0[w] % (1 << level) == 0)
                    & (w0[w] % (1 << level) == 0)).all()
            s = side >> level
            coarse = np.zeros((N, s, s, cv), np.int64)
            np.add.at(coarse, (n[w], h0[w] >> level, w0[w] >> level, c[w]),
                      1)
            assert (coarse == 1).all(), (C, side, shifts, level)


@pytest.mark.parametrize("crop", [64, 256])
def test_fuse_backward_tile_tree_gives_the_plain_bits(crop):
    """The kernel's f32 tree replayed from the tiles' indices: each
    thread's 2x2 sum (g00 + g01) + (g10 + g11) of its micro box, then each
    coarser box from the four quarters the kernel reads (micro boxes
    (row, col), (row, col + k/2), (row + k/2, col), (row + k/2, col +
    k/2)) in that order; rounded once to bf16, equal to
    ``hr_fuse_backward_plain`` at every shifted term."""
    rng = np.random.default_rng(3)
    N = 1 if crop == 256 else 2
    for C, side, shifts in _w48_targets(crop):
        if max(shifts) == 0:
            continue
        plan = hr_fuse_backward_plan(N, C, side, side, shifts, 2)
        dy = torch.from_numpy(rng.normal(size=(N, C, side, side))
                              .astype(np.float32)).bfloat16()
        y = torch.from_numpy(rng.normal(size=(N, C, side, side))
                             .astype(np.float32)).bfloat16()
        _, want = hr_fuse_backward_plain(dy, y, shifts)
        g = torch.where(y > 0, dy, 0).float().permute(0, 2, 3, 1).numpy()
        g = g.reshape(N, side, side, C // 8, 8)
        n, h0, w0, c, row, col = _fuse_threads(plan, N, side, side)
        acc = ((g[n, h0, w0, c] + g[n, h0, w0 + 1, c])
               + (g[n, h0 + 1, w0, c] + g[n, h0 + 1, w0 + 1, c]))
        # a thread's index in the launch, from (block, micro box, vector)
        block = (np.arange(len(n)) // plan.threads) * plan.threads
        for level in range(1, plan.shift + 1):
            if level > 1:
                k = 1 << (level - 2)
                q01 = block + ((row * plan.tw + col + k) * plan.cs + c
                               % plan.cs)
                q10 = block + (((row + k) * plan.tw + col) * plan.cs + c
                               % plan.cs)
                q11 = block + (((row + k) * plan.tw + col + k) * plan.cs + c
                               % plan.cs)
                w = (row % (2 * k) == 0) & (col % (2 * k) == 0)
                new = np.zeros_like(acc)
                idx = np.nonzero(w)[0]
                new[idx] = ((acc[idx] + acc[q01[idx]])
                            + (acc[q10[idx]] + acc[q11[idx]]))
                acc = new
            else:
                w = np.ones_like(row, bool)
            s = side >> level
            got = np.zeros((N, s, s, C // 8, 8), np.float32)
            got[n[w], h0[w] >> level, w0[w] >> level, c[w]] = acc[w]
            got = torch.from_numpy(got.reshape(N, s, s, C)).bfloat16()
            for t, sh in zip(want, shifts):
                if sh == level:
                    assert torch.equal(got, t.permute(0, 2, 3, 1)), (
                        C, side, shifts, level)


_SUBSETS = (3840, 3584, 3072)  # the flagship's candidate faces (SMPL-X)


@pytest.mark.parametrize("B", [1, 32, 48])
@pytest.mark.parametrize("counts,F", [
    ((20908,) * 3, 20908), (_SUBSETS, 20908), ((320,) * 3, 320),
    ((256, 256, 256), 320), ((20, 7, 0), 30), ((0, 0, 0), 20908),
    ((62724,) * 3, 20908)],
    ids=["all-faces", "subsets", "small-all", "small-subsets", "tiny",
         "no-planes", "aos-triangles"])
def test_measure_plan_walks_every_position_once_in_order(counts, F, B):
    plan = measure_plan(counts, F, B)
    assert 1 <= plan.cluster <= _K1_MAX_CLUSTER
    for n, span in zip(counts, plan.spans):
        walked = []
        for r in range(plan.cluster):  # as measure_cluster_kernel bounds it
            lo = min(n, r * span)
            hi = min(n, lo + span)
            walked.extend(range(lo, hi))
        assert walked == list(range(n))
    faces = []
    for r in range(plan.cluster):
        lo = min(F, r * plan.mass_span)
        faces.extend(range(lo, min(F, lo + plan.mass_span)))
    assert faces == list(range(F))


def test_measure_plan_sizes_the_cluster_by_walk_and_batch():
    """16 CTAs for a fit's one body on all faces; fewer as the batch
    fills the card (about 128 CTAs a plane) or the walk shortens."""
    assert measure_plan((20908,) * 3, 20908, 1).cluster == 16
    assert measure_plan((20908,) * 3, 20908, 48).cluster == 2
    assert measure_plan(_SUBSETS, 20908, 32).cluster == 4
    assert measure_plan((320,) * 3, 320, 1).cluster == 1
    assert measure_plan((20908,) * 3, 20908, 500).cluster == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fuse_backward_plain_matches_jax_vjp(dtype):
    rng = np.random.default_rng(21)
    shifts = (1, 2, 3, 0)
    N, C, S = 2, 16, 16

    def rand(shape):
        a = rng.normal(size=shape).astype(np.float32)
        return torch.from_numpy(a).to(getattr(torch, dtype)).float().numpy()

    x = rand((N, S, S, C))
    ts = [rand((N, S >> s, S >> s, C)) for s in shifts]
    dy = rand((N, S, S, C))

    def fuse(x, *ts):
        y = x
        for t, s in zip(ts, shifts):
            y = y + (jlayers.nearest_upsample(t, 2 ** s) if s else t)
        return jax.nn.relu(y)

    y, vjp = jax.vjp(fuse, jnp.asarray(x), *map(jnp.asarray, ts))
    want = vjp(jnp.asarray(dy))

    def nchw(a):
        return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).to(
            getattr(torch, dtype))

    dx, grads = hr_fuse_backward_plain(nchw(dy), nchw(y), shifts)
    for got, ref in zip([dx] + grads, want):
        ref = torch.from_numpy(np.array(ref)).permute(0, 3, 1, 2)
        assert got.dtype == getattr(torch, dtype)
        assert got.shape == ref.shape
        err = (got.float() - ref).abs()
        if dtype == "float32":
            assert float(err.max()) <= 1e-6 * float(ref.abs().max())
        else:
            assert bool((err <= bf16_step(ref.abs())).all())
