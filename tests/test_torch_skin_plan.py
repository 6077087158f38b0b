"""K3's work split and order replays on the CPU (``models/body/lbs.py``).

``skin_plan`` must cover every vertex and body once, in both kernels,
with the backward's partitions (the order of its sums) fixed by V and J
alone; the kernels' shared memory is checked on the card, where each
launch asks for it (``tests/test_torch_kernels_cuda.py`` at 76 joints and
128 bodies). ``fma32``
must round as CUDA's ``__fmaf_rn``. The replays of the kernels' order must
agree with the plain version, and the JAX einsum, within the kernels'
tolerances.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu_torch.models.body.lbs import (
    _SKIN_TILE,
    fma32,
    skin_backward_replay,
    skin_forward_replay,
    skin_plain,
    skin_plan,
)

BATCHES = (1, 5, 32, 48, 128)


@pytest.mark.parametrize("V", [1, 127, 300, 10475])
@pytest.mark.parametrize("J", [24, 52, 55, 76])
def test_skin_plan_covers_every_vertex_and_body_once(J, V):
    tiles = -(-V // _SKIN_TILE)
    for B in BATCHES:
        plan = skin_plan(B, V, J)
        assert 1 <= plan.run <= 4  # the kernels' kMaxRun
        # the forward: block (x, y), warp w < its run's bodies
        seen = np.zeros((B, V), np.int64)
        for y in range(-(-B // plan.run)):
            b0 = y * plan.run
            for x in range(tiles):
                v0 = x * _SKIN_TILE
                seen[b0:b0 + plan.run, v0:v0 + _SKIN_TILE] += 1
        assert (seen == 1).all()
        # the backward: block (partition, y); a tile's vertices split in
        # `sub` sub-ranges, a lane 4 of the joints (q, q + nq, ...)
        assert plan.parts * plan.tiles_per_part >= tiles
        assert (plan.parts - 1) * plan.tiles_per_part < tiles
        seen[:] = 0
        for y in range(-(-B // plan.run)):
            b0 = y * plan.run
            for p in range(plan.parts):
                for t in range(p * plan.tiles_per_part,
                               min(tiles, (p + 1) * plan.tiles_per_part)):
                    for s in range(plan.sub):
                        vs = np.arange(t * _SKIN_TILE + s,
                                       min(V, (t + 1) * _SKIN_TILE), plan.sub)
                        seen[b0:b0 + plan.run, vs] += 1
        assert (seen == 1).all()
        nq = -(-J // 4)
        joints = (np.arange(nq)[:, None] + nq * np.arange(4)).ravel()
        assert set(joints[joints < J]) == set(range(J))
        assert plan.sub * nq <= 32
        # the sums' order does not depend on the batch
        assert ((plan.tiles_per_part, plan.sub)
                == (skin_plan(1, V, J).tiles_per_part,
                    skin_plan(1, V, J).sub))


def _round_f32(x: Fraction) -> float:
    """The float32 nearest the exact ``x``, ties to even."""
    r = np.float32(float(x))
    cands = [np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf))]
    return float(min(cands, key=lambda c: (
        abs(Fraction(float(c)) - x),
        int(np.float32(c).view(np.uint32)) & 1)))


def test_fma32_rounds_once():
    """``fma32`` against the exact product and sum rounded once, on
    random triples and on one whose float64 sum lands on a float32
    midpoint (where rounding twice gives the other neighbour)."""
    rng = np.random.default_rng(0)
    n = 4000
    a = (rng.normal(size=n) * 10.0 ** rng.integers(-3, 3, n)).astype(
        np.float32)
    b = rng.normal(size=n).astype(np.float32)
    c = (rng.normal(size=n) * 10.0 ** rng.integers(-6, 2, n)).astype(
        np.float32)
    a[0], b[0], c[0] = 2.0 ** -24 + 2.0 ** -47, 1 - 2.0 ** -23, 1 + 2.0 ** -23
    got = fma32(*(torch.from_numpy(t) for t in (a, b, c))).numpy()
    want = [_round_f32(Fraction(float(x)) * Fraction(float(y))
                       + Fraction(float(z))) for x, y, z in zip(a, b, c)]
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    twice = np.float32(np.float64(a[0]) * np.float64(b[0])
                       + np.float64(c[0]))
    assert got[0] == np.float32(1 + 2.0 ** -23) != twice


def _inputs(B, V, J, seed):
    rng = np.random.default_rng(seed)
    w = rng.uniform(size=(V, J)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    A = rng.normal(size=(B, J, 4, 4)).astype(np.float32)
    vp = rng.normal(size=(B, V, 3)).astype(np.float32)
    dv = rng.normal(size=(B, V, 3)).astype(np.float32)
    return w, A, vp, dv


@pytest.mark.parametrize("B,V,J", [(3, 300, 55), (2, 10475, 55),
                                   (5, 127, 24), (2, 1000, 52),
                                   (1, 700, 76)])
def test_skin_backward_replay_matches_f64_autograd(B, V, J):
    """The backward's order replay against autograd through the plain
    version in f64: within 1e-5 of the largest gradient, the CUDA test's
    tolerance (sums over the vertices in f32)."""
    w, A, vp, dv = (torch.from_numpy(t) for t in _inputs(B, V, J, 1))
    d_rel, d_v = skin_backward_replay(w, A, vp, dv)
    a = A.double().requires_grad_()
    v = vp.double().requires_grad_()
    skin_plain(w.double(), a, v).backward(dv.double())
    for got, want in ((d_rel, a.grad), (d_v, v.grad)):
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got.double(), want, rtol=0,
                                   atol=1e-5 * scale)
    assert not d_rel[:, :, 3].any()


def test_skin_forward_replay_matches_jax_einsum():
    """The forward's replay against the JAX package's skinning
    (``lbs.py:97-101``) and the plain version: atol 1e-5 m."""
    w, A, vp, _ = _inputs(2, 300, 55, 2)
    T = jnp.einsum("vj,bjmn->bvmn", jnp.asarray(w), jnp.asarray(A))
    v_hom = jnp.concatenate([jnp.asarray(vp), jnp.ones((2, 300, 1))], -1)
    want = np.asarray(jnp.einsum("bvmn,bvn->bvm", T[..., :3, :], v_hom))
    got = skin_forward_replay(*(torch.from_numpy(t) for t in (w, A, vp)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    plain = skin_plain(*(torch.from_numpy(t) for t in (w, A, vp)))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=1e-5)


def test_skin_replays_are_batch_invariant():
    """A body alone replays to the same bits as its row of a batch: the
    order depends on V and J alone."""
    w, A, vp, dv = (torch.from_numpy(t) for t in _inputs(6, 1000, 55, 3))
    out = skin_forward_replay(w, A, vp)
    d_rel, d_v = skin_backward_replay(w, A, vp, dv)
    for i in (0, 5):
        s = slice(i, i + 1)
        assert torch.equal(skin_forward_replay(w, A[s], vp[s])[0], out[i])
        one = skin_backward_replay(w, A[s], vp[s], dv[s])
        assert torch.equal(one[0][0], d_rel[i])
        assert torch.equal(one[1][0], d_v[i])
