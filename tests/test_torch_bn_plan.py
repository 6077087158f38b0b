"""K4's plan on the CPU, for its forward and its backward.

K4 runs only on the card, but its row tiles, its regime and the order of
its sums are decided in Python from the shape alone (``_bn_plan``;
``_bn_plan_regime`` forces a regime), and both passes run the same plan.
Here the plan's tiles must cover every row once in both regimes (one
cluster launch, or partials + finalize + the elementwise pass), and a
plain replay of the kernels' sum order (a thread's rows in order, the row
lanes, then the blocks or tiles, each as the plan says) must give the JAX
package's ``bn_train_core`` (the forward's ``y, mean, var`` and the
running-stat EMA of ``batch_norm``) and its VJP within the tolerance the
port's BN holds against it (``tests/test_torch_train.py``: rtol 1e-5,
atol 1e-6, in f32). Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.models.backbones import layers as jlayers
from shapy_tpu_torch.models.backbones import layers
from shapy_tpu_torch.models.backbones.layers import _bn_plan, _bn_plan_regime

# (N, C, H, W) of a train step's BNs at batch 48, and ragged ones.
STEP_SHAPES = [
    (48, 64, 128, 128), (48, 256, 64, 64), (48, 64, 64, 64),
    (48, 48, 64, 64), (48, 2048, 8, 8), (48, 96, 32, 32),
    (48, 48, 32, 32), (48, 192, 16, 16), (48, 512, 8, 8),
    (48, 96, 16, 16), (48, 384, 8, 8), (48, 48, 16, 16),
    (48, 192, 8, 8), (48, 96, 8, 8), (48, 48, 8, 8),
]
RAGGED = [(3, 48, 5, 7), (2, 36, 5, 5), (1, 40, 3, 3), (5, 12, 7, 9)]


def _rows(plan, tile: int, lane: int, R: int) -> range:
    """The rows lane ``lane`` of tile ``tile`` sums, in order."""
    return range(tile * plan.rows + lane, min(R, (tile + 1) * plan.rows),
                 plan.lanes)


@pytest.mark.parametrize("fused", [None, "forward", True, False],
                         ids=["planned", "planned-forward", "cluster",
                              "split"])
@pytest.mark.parametrize("shape", STEP_SHAPES + RAGGED,
                         ids=lambda s: "x".join(map(str, s)))
def test_bn_plan_tiles_cover_every_row_once(shape, fused):
    """Each row lies in one tile and one lane of it (and in one band of
    the forward's elementwise pass); a block holds at most 256 threads; a thread takes 8 channels where C % 8 == 0; the cluster
    regime has 8 or 16 blocks; the plans depend on the shape alone, and
    the planned regime is the cluster for the step's 8^2 and 16^2 layers
    up to 384 channels in the backward, and in the forward for its 8^2
    and 16^2 layers and its 48-channel 32^2 ones."""
    N, C, H, W = shape
    R = N * H * W
    planned = fused in (None, "forward")
    forward = fused == "forward"
    plan = (_bn_plan(R, C, forward) if planned
            else _bn_plan_regime(R, C, fused))
    assert plan == (_bn_plan.__wrapped__(R, C, forward) if planned
                    else _bn_plan_regime(R, C, fused))
    assert plan == _bn_plan_regime(R, C, plan.fused)
    assert plan.vec == (8 if C % 8 == 0 else 1)
    assert plan.group * plan.lanes <= 256
    seen = np.zeros(R, dtype=int)
    for t in range(plan.tiles):
        for lane in range(plan.lanes):
            seen[list(_rows(plan, t, lane, R))] += 1
    assert (seen == 1).all()
    if plan.fused:
        assert plan.tiles in (8, 16) and plan.lanes == 256
        assert plan.bands == 0
    else:
        assert plan.group == min(C // plan.vec, 256)
        # The forward's elementwise pass: a grid of at most _BN_NORM_BLOCKS
        # blocks writes every row once.
        cgroups = -(-(C // plan.vec) // plan.group)
        assert 1 <= plan.bands * cgroups <= max(cgroups,
                                                 layers._BN_NORM_BLOCKS)
        band = plan.bands * plan.lanes
        seen[:] = 0
        for first in range(min(band, R)):
            seen[list(range(first, R, band))] += 1
        assert (seen == 1).all()
    if fused is None and shape in STEP_SHAPES:
        assert plan.fused == (H <= 16 and C <= 384)
    if forward and shape in STEP_SHAPES:
        assert plan.fused == (H <= 16 or (H == 32 and C == 48))


def block_sums(d, plan, R: int, row_terms):
    """The kernels' two f32 sums of each channel over the R rows, in the
    plan's order: ``row_terms(r)`` gives row r's pair of (C,) terms."""
    zero = torch.zeros(d.shape[1])

    def lane_sums(rows):
        s, q = zero.clone(), zero.clone()
        for r in rows:
            a, b = row_terms(r)
            s, q = s + a, q + b
        return s, q

    tile_sums = []
    for t in range(plan.tiles):
        lanes = [lane_sums(_rows(plan, t, lane, R))
                 for lane in range(plan.lanes)]
        s, q = zero.clone(), zero.clone()
        if plan.fused:  # 8 groups of 32 lanes, each in order, then in order
            for g in range(8):
                gs, gq = zero.clone(), zero.clone()
                for a, b in lanes[32 * g:32 * g + 32]:
                    gs, gq = gs + a, gq + b
                s, q = s + gs, q + gq
        else:
            for a, b in lanes:
                s, q = s + a, q + b
        tile_sums.append((s, q))
    s, q = zero.clone(), zero.clone()
    if plan.fused:  # the cluster's blocks in order
        for a, b in tile_sums:
            s, q = s + a, q + b
    else:  # 32 finalize lanes over strided tiles, then the lanes in order
        for f in range(32):
            fs, fq = zero.clone(), zero.clone()
            for a, b in tile_sums[f::32]:
                fs, fq = fs + a, fq + b
            s, q = s + fs, q + fq
    return s, q


def forward_replay(x, gamma, beta, running_mean, running_var, plan,
                   eps=1e-5, momentum=0.1):
    """K4's forward in the plan's sum order, f32 (N, C, H, W) tensors:
    (y, mean, var, running_mean, running_var)."""
    N, C, H, W = x.shape
    R = N * H * W
    xr = x.permute(0, 2, 3, 1).reshape(R, C)
    s, q = block_sums(xr, plan, R, lambda r: (xr[r], xr[r] * xr[r]))
    mean = s / R
    var = q / R - mean * mean
    inv = torch.rsqrt(var + eps)
    y = ((xr - mean) * inv) * gamma + beta
    keep = 1.0 - momentum
    rm = keep * running_mean + momentum * mean
    rv = keep * running_var + momentum * (var * (R / (R - 1)))
    return (y.reshape(N, H, W, C).permute(0, 3, 1, 2), mean, var, rm, rv)


@pytest.mark.parametrize("fused", [True, False], ids=["cluster", "split"])
@pytest.mark.parametrize("shape", [(2, 16, 8, 8), (3, 12, 5, 7),
                                   (4, 48, 6, 6), (48, 8, 4, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_bn_forward_replay_matches_jax(shape, fused, monkeypatch):
    """The replay of the forward's sum order (row tiles of 64 elements in
    the split regime, so that many tiles meet in the finalize) against
    JAX ``bn_train_core``'s ``y, mean, var`` and ``batch_norm``'s
    running-stat EMA: rtol 1e-5, atol 1e-6 in f32."""
    monkeypatch.setattr(layers, "_BN_TILE_ELEMS", 64)
    N, C, H, W = shape
    rng = np.random.default_rng(sum(shape) + 7 * fused)
    x = (rng.normal(size=(N, H, W, C)) * 2 + 0.3).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, size=C).astype(np.float32)
    beta = rng.normal(size=C).astype(np.float32)
    rmean = rng.normal(size=C).astype(np.float32)
    rvar = rng.uniform(0.5, 2.0, size=C).astype(np.float32)
    want = jlayers.bn_train_core(jnp.asarray(x), jnp.asarray(gamma),
                                 jnp.asarray(beta), 1e-5, None)
    store = jlayers.ParamStore({"bn.weight": gamma, "bn.bias": beta,
                                "bn.running_mean": rmean,
                                "bn.running_var": rvar})
    jlayers.batch_norm(store, "bn", jnp.asarray(x), train=True)

    plan = _bn_plan_regime(N * H * W, C, fused)  # the tile size above
    assert plan.tiles > 1
    got = forward_replay(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                         torch.from_numpy(gamma), torch.from_numpy(beta),
                         torch.from_numpy(rmean), torch.from_numpy(rvar),
                         plan)
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(),
                               np.asarray(want[0]), **tol)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **tol)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **tol)
    np.testing.assert_allclose(
        got[3].numpy(), np.asarray(store.stat_updates["bn.running_mean"]),
        **tol)
    np.testing.assert_allclose(
        got[4].numpy(), np.asarray(store.stat_updates["bn.running_var"]),
        **tol)


def backward_replay(dy, x, gamma, mean, inv, plan):
    """K4's backward in the plan's sum order, f32 (N, C, H, W) tensors:
    (dx, dgamma, dbeta)."""
    N, C, H, W = x.shape
    R = N * H * W
    d = dy.permute(0, 2, 3, 1).reshape(R, C)
    xh = ((x - mean[:, None, None]) * inv[:, None, None]).permute(
        0, 2, 3, 1).reshape(R, C)
    sdy, sdyx = block_sums(d, plan, R, lambda r: (d[r], d[r] * xh[r]))
    k0, k1, k2 = sdy / R, sdyx / R, gamma * inv
    dx = k2 * ((d - k0) - xh * k1)
    return dx.reshape(N, H, W, C).permute(0, 3, 1, 2), sdyx, sdy


@pytest.mark.parametrize("fused", [True, False], ids=["cluster", "split"])
@pytest.mark.parametrize("shape", [(2, 16, 8, 8), (3, 12, 5, 7),
                                   (4, 48, 6, 6)],
                         ids=lambda s: "x".join(map(str, s)))
def test_bn_backward_replay_matches_jax(shape, fused, monkeypatch):
    """The replay of the plan's sum order (row tiles of 64 elements in the
    split regime, so that many tiles meet in the finalize) against
    ``jax.vjp`` of ``bn_train_core``: dx, dgamma and dbeta rtol 1e-5, atol
    1e-6 in f32."""
    monkeypatch.setattr(layers, "_BN_TILE_ELEMS", 64)
    N, C, H, W = shape
    rng = np.random.default_rng(sum(shape) + fused)
    x = (rng.normal(size=(N, H, W, C)) * 2 + 0.3).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, size=C).astype(np.float32)
    beta = rng.normal(size=C).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(
        lambda a, g, b: jlayers.bn_train_core(a, g, b, 1e-5, None),
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    zeros = jnp.zeros(C, jnp.float32)
    want = vjp((jnp.asarray(dy), zeros, zeros))

    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    mean, var = layers._moments_plain(xt)
    inv = torch.rsqrt(var + 1e-5)
    plan = _bn_plan_regime(N * H * W, C, fused)  # the tile size above
    assert plan.tiles > 1
    got = backward_replay(torch.from_numpy(dy.transpose(0, 3, 1, 2).copy()),
                          xt, torch.from_numpy(gamma), mean, inv, plan)
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(),
                               np.asarray(want[0]), **tol)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **tol)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **tol)
