"""K7's design replayed on the CPU (``shapy_tpu_torch/ops/repulsion.py``):
the shape-only plan, the forward's tile and tree sum order in f64, the
backward's face -> entry lists and per-face sums in ascending entry id,
and the live mask that lets the backward skip pairs, held against the
plain version (its value, and autograd's gradient) and the JAX package's
``repulsion_loss``.

The replays repeat what kernel K7 (``csrc/repulsion.cu``) does; the kernel
runs only on the card, where ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py`` hold it to these replays bit for bit. Tolerances: the
replays sum the plain version's per-pair terms in another order than the
plain version does, so the loss within rel 1e-5 and the gradient within
1e-5 of its largest entry; against JAX the gradient within
``test_torch_repulsion.py``'s 1e-4 of the largest (JAX contracts into
FMAs under jit); skipping pairs that are not live changes no bit.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.ops import repulsion as jr
from shapy_tpu_torch.ops import repulsion as tr
from shapy_tpu_torch.utils.cuda_kernels import CARD_SMS, CSRC_DIR

CASES = [
    dict(sigma=0.5, penalize_outside=True, linear_max=1000.0),
    dict(sigma=0.03, penalize_outside=True, linear_max=1000.0),
    dict(sigma=0.03, penalize_outside=False, linear_max=1000.0),
]
IDS = ["default", "sigma3cm", "inside-only"]


def _soup(seed, B=2, F=48, C=300):
    """Small triangles (~2 cm) in a 5 cm cloud (many vertices inside other
    triangles' cones), seeded pairs with padded ones: a padded tail, a
    padded receiver, a padded intruder."""
    rng = np.random.default_rng(seed)
    cent = rng.normal(size=(B, F, 1, 3)) * 0.05
    tris = (cent + rng.normal(size=(B, F, 3, 3)) * 0.02).astype(np.float32)
    pairs = rng.integers(0, F, size=(B, C, 2)).astype(np.int32)
    pairs[0, -5:] = -1
    if B > 1:
        pairs[1, -3:, 0] = -1
        pairs[1, 5, 1] = -1
    return torch.from_numpy(tris), torch.from_numpy(pairs)


def _autograd(tris, pairs, g, **kw):
    x = tris.clone().requires_grad_()
    loss = tr.repulsion_loss_plain(x, pairs, **kw)
    return torch.autograd.grad((loss * g).sum(), x)[0]


@pytest.mark.parametrize("B, C, F", [
    (1, 1, 1), (2, 40, 48), (1, 257, 30), (4, 1300, 41816),
    (8, 5000, 41816), (1, 0, 10), (3, 5, 0), (64, 20000, 100)])
def test_plan_covers_every_pair_pass_and_face(B, C, F):
    """Every pair in one tile, every (pair, tangent pass) one thread, every
    face one face-pass thread; the pair pass's block the largest that
    still gives 3 blocks an SM, down to 32 threads."""
    plan = tr.repulsion_plan(B, C, F)
    assert plan == tr.repulsion_plan(B, C, F)  # shapes alone
    assert plan.tiles * 256 >= C > (plan.tiles - 1) * 256 or C == 0
    work = B * C * tr._PASSES
    t = plan.pair_threads
    assert t in (32, 64, 128, 256)
    assert plan.pair_blocks * t >= work > (plan.pair_blocks - 1) * t \
        or work == 0
    want = 3 * CARD_SMS
    assert plan.pair_blocks >= want or t == 32
    if t < 256:
        assert -(-work // (2 * t)) < want
    assert plan.face_blocks * 256 >= B * F > (plan.face_blocks - 1) * 256 \
        or B * F == 0


def test_plan_at_phase_9():
    """Phase 9's 4 bodies of 1300 pairs (the bodies' triangles side by
    side, 41816 faces a row): 6 tiles a body, 64 threads a block for
    46800 pair passes."""
    assert tr.repulsion_plan(4, 1300, 41816) == tr.RepulsionPlan(
        6, 64, 732, 654)


def test_plan_constants_match_the_source():
    """The wrapper's geometry is the kernel source's."""
    src = (CSRC_DIR / "repulsion.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([^;/]+);",
                             src).group(1).split("/")[0].strip())

    assert const("kTile") == tr._PAIR_TILE
    assert 18 // const("kTangents") == tr._PASSES
    assert const("kPairThreadsMax") == tr._PAIR_THREADS_MAX
    assert const("kFaceBlock") == tr._FACE_BLOCK


def _tree_sum_loop(per_pair):
    """The forward kernel's sums written as its threads run them: each
    tile's shared-memory tree, then the last block's loop over tiles."""
    B, C = per_pair.shape
    tiles = -(-C // 256)
    out = []
    for b in range(B):
        s = 0.0
        for k in range(tiles):
            red = [float(per_pair[b, c]) if c < C else 0.0
                   for c in range(k * 256, k * 256 + 256)]
            step = 128
            while step:
                for t in range(step):
                    red[t] = red[t] + red[t + step]
                step //= 2
            s = s + red[0]
        out.append(s)
    return torch.tensor(out, dtype=torch.float64)


@pytest.mark.parametrize("C", [1, 256, 300, 1300])
def test_forward_replay_is_the_kernels_order(C):
    """The vectorised replay gives the bits of the kernel's loops (Python
    floats are f64), at one tile, a full tile and a tile and a part."""
    gen = torch.Generator().manual_seed(C)
    per_pair = torch.rand(3, C, generator=gen) ** 8
    per_pair[1, C // 2:] = 0.0
    loss, total = tr.repulsion_forward_replay(per_pair)
    want = _tree_sum_loop(per_pair)
    assert torch.equal(total, want)
    assert torch.equal(loss, want.float())


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_forward_replay_matches_plain(kw):
    tris, pairs = _soup(0)
    per_pair, live = tr.repulsion_pairs_plain(tris, pairs, **kw)
    loss, total = tr.repulsion_forward_replay(per_pair)
    want = tr.repulsion_loss_plain(tris, pairs, **kw)
    assert bool((want > 0).all())
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=0)
    torch.testing.assert_close(total, per_pair.double().sum(-1), rtol=1e-12,
                               atol=0)
    assert bool((per_pair[~live] == 0).all())


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_backward_replay_matches_autograd(kw):
    """The plain pair gradients (what the pair pass writes), bucketed and
    summed in ascending entry id, against autograd through the whole plain
    loss (which sums them by index_add in its own order)."""
    tris, pairs = _soup(1)
    g = torch.tensor([1.0, -0.7])
    entries = tr.repulsion_entries_plain(tris, pairs, g, **kw)
    assert entries.shape == (2, 300, 2, 3, 3)
    got = tr.repulsion_backward_replay(entries, pairs, 48)
    want = _autograd(tris, pairs, g, **kw)
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= 1e-5 * scale


def test_backward_replay_matches_jax():
    tris, pairs = _soup(2)
    g = np.asarray([1.0, -0.7], np.float32)
    want = np.asarray(jax.grad(lambda t: jnp.sum(
        jr.repulsion_loss(t, jnp.asarray(pairs.numpy())) * g))(
            jnp.asarray(tris.numpy())))
    entries = tr.repulsion_entries_plain(tris, pairs, torch.from_numpy(g))
    got = tr.repulsion_backward_replay(entries, pairs, 48).numpy()
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= 1e-4 * scale


def test_buckets_hold_ascending_entry_ids():
    """Planted duplicate faces: face 3 in 45 entries (as receiver and as
    intruder, in two bodies), face 5 in one, face 7 in none. Each bucket
    lists its entries once, in ascending id, and only its own."""
    B, C, F = 2, 60, 10
    pairs = torch.full((B, C, 2), -1, dtype=torch.int32)
    pairs[0, :40] = torch.tensor([3, 4], dtype=torch.int32)
    pairs[0, 40:45] = torch.tensor([6, 3], dtype=torch.int32)
    pairs[0, 45] = torch.tensor([5, 8], dtype=torch.int32)
    pairs[0, 46] = torch.tensor([3, -1], dtype=torch.int32)  # padded
    pairs[1, :30] = torch.tensor([2, 3], dtype=torch.int32)
    order, starts = tr.repulsion_buckets(pairs, F)
    counts = (starts[1:] - starts[:-1]).reshape(B, F)
    assert counts[0, 3] == 45 and counts[0, 5] == 1 and counts[0, 7] == 0
    assert counts[0, 4] == 40 and counts[1, 3] == 30
    assert int(counts.sum()) == len(order) == 2 * (46 + 30)
    flat = pairs.reshape(-1)
    for bf in range(B * F):
        ids = order[starts[bf]:starts[bf + 1]]
        assert bool((ids[1:] > ids[:-1]).all())
        assert bool((flat[ids] + (ids // (2 * C)) * F == bf).all())


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_skipped_pairs_change_no_bit(kw):
    """Pairs whose six points all lie outside their cones (not live) have
    exact-zero entries: leaving them out of the buckets gives the same
    bits. Some pairs are skipped and some kept in each case."""
    tris, pairs = _soup(3)
    g = torch.tensor([1.3, -0.4])
    entries = tr.repulsion_entries_plain(tris, pairs, g, **kw)
    _, live = tr.repulsion_pairs_plain(tris, pairs, **kw)
    valid = torch.all(pairs >= 0, dim=-1)
    assert 0 < int(live.sum()) < int(valid.sum())
    assert bool((entries[valid & ~live] == 0).all())
    full = tr.repulsion_backward_replay(entries, pairs, 48)
    skipped = tr.repulsion_backward_replay(entries, pairs, 48, live, g)
    assert torch.equal(full, skipped)
    order, _ = tr.repulsion_buckets(pairs, 48, live, g)
    assert len(order) == 2 * int(live.sum())


def test_a_cotangent_that_is_not_finite_skips_nothing():
    """With grad_loss[b] inf the pairs that are not live give NaN entries
    (inf * 0), so the kernel's rule keeps them for that body."""
    tris, pairs = _soup(4)
    _, live = tr.repulsion_pairs_plain(tris, pairs)
    valid = torch.all(pairs >= 0, dim=-1)
    g = torch.tensor([float("inf"), 1.0])
    order, _ = tr.repulsion_buckets(pairs, 48, live, g)
    assert len(order) == 2 * int(valid[0].sum() + live[1].sum())


def test_padded_rows_and_no_pairs():
    """A row of only padded pairs and C = 0: zero loss and gradient, empty
    buckets, no tile of the forward."""
    tris, pairs = _soup(5, C=20)
    pairs[1] = -1
    g = torch.tensor([1.0, 2.0])
    per_pair, live = tr.repulsion_pairs_plain(tris, pairs)
    loss, _ = tr.repulsion_forward_replay(per_pair)
    assert float(loss[1]) == 0.0 and not bool(live[1].any())
    entries = tr.repulsion_entries_plain(tris, pairs, g)
    grad = tr.repulsion_backward_replay(entries, pairs, 48, live, g)
    want = _autograd(tris, pairs, g)
    assert float((grad - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    assert bool((grad[1] == 0).all())
    empty = pairs[:, :0].contiguous()
    assert tr.repulsion_plan(2, 0, 48).tiles == 0
    loss, total = tr.repulsion_forward_replay(
        tr.repulsion_pairs_plain(tris, empty)[0])
    assert loss.shape == (2,) and bool((loss == 0).all())
    order, starts = tr.repulsion_buckets(empty, 48)
    assert len(order) == 0 and bool((starts == 0).all())
    grad = tr.repulsion_backward_replay(
        torch.empty(2, 0, 2, 3, 3), empty, 48)
    assert grad.shape == (2, 48, 3, 3) and bool((grad == 0).all())


def on_axis_pair():
    """A pair whose value is exactly 0 but whose gradient is NaN: an
    intruder vertex exactly on the receiver's cone axis (every coordinate
    a power of 2, so the axis is (0, 0, 1) and the circumcentre (a/2, a/2,
    0) exactly) 1 m in front, where the intensity is 0; the intruder's
    other points lie in the cone (intensity 0) and the receiver's outside
    the intruder's cone. Faces 2, 3: a copy 0.3 m away."""
    a = 2.0 ** -6
    tris = torch.zeros(1, 4, 3, 3)
    tris[0, 0] = torch.tensor([[0, 0, 0], [a, 0, 0], [0, a, 0]])
    tris[0, 1] = torch.tensor([[a / 2, a / 2, 1.0], [a / 2, a / 2 + 0.01, 1.0],
                               [a / 2, a / 2, 1.01]])
    tris[0, 2:] = tris[0, :2] + 0.3
    return tris, torch.tensor([[[0, 1], [2, 3]]], dtype=torch.int32)


def test_a_zero_pair_on_a_cone_axis_is_live():
    """The on-axis pair adds 0, yet the plain version's gradient is NaN
    there (sqrt's derivative at 0, times 0) and so is the kernel's (its
    dual sqrt divides 0 by 0). Its points pass their masks, so it is live
    and the kernel does not skip it: the port keeps the NaN."""
    tris, pairs = on_axis_pair()
    per_pair, live = tr.repulsion_pairs_plain(tris, pairs)
    assert bool((per_pair == 0).all()) and bool(live.all())
    grad = _autograd(tris, pairs, torch.tensor([1.0]))
    assert bool(torch.isnan(grad[0, 0]).any())
    assert bool(torch.isnan(grad[0, 1]).any())
