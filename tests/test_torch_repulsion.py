"""Parity of the port's repulsion loss (``shapy_tpu_torch/ops/
repulsion.py``) with the JAX package's (``shapy_tpu/ops/repulsion.py``).

On the CPU :func:`repulsion_loss` runs its plain version, the oracle of
kernel K7 (value, and gradient through autograd) on the card. Both sides
get the same f32 triangle soups and (receiver, intruder) pairs, made with
numpy, with padded pairs (either id -1).

Tolerances: values rel 2e-5 (the same f32 operations; JAX contracts some
into FMAs and sums the pairs in another order); gradients within 1e-4 of
the largest, since the 4th and 8th powers spread them over many orders of
magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.ops import repulsion as jr
from shapy_tpu_torch.ops import repulsion_loss
from shapy_tpu_torch.ops import repulsion as tr

B, F, C = 2, 48, 40
WEIGHTS = np.asarray([1.0, -0.7], np.float32)  # a cotangent for the loss
# sigma and linear_max traced (f32), so that one compile serves each
# penalize_outside
jax_loss = jax.jit(jr.repulsion_loss, static_argnames=("penalize_outside",))


def _weighted(tris, pairs, sigma, penalize_outside, linear_max):
    return jnp.sum(jr.repulsion_loss(tris, pairs, sigma, penalize_outside,
                                     linear_max) * WEIGHTS)


jax_grad = jax.jit(jax.grad(_weighted), static_argnums=(3,))


def _soup(seed):
    """Small triangles (~2 cm) in a 5 cm cloud, so that many vertices lie
    inside other triangles' cones, some deep (the linear band)."""
    rng = np.random.default_rng(seed)
    cent = rng.normal(size=(B, F, 1, 3)) * 0.05
    tris = (cent + rng.normal(size=(B, F, 3, 3)) * 0.02).astype(np.float32)
    pairs = rng.integers(0, F, size=(B, C, 2)).astype(np.int32)
    pairs[0, -5:] = -1
    pairs[1, -3:, 0] = -1  # receiver padded
    pairs[1, 5, 1] = -1  # intruder padded
    return tris, pairs


CASES = [
    dict(sigma=0.5, penalize_outside=True, linear_max=1000.0),
    dict(sigma=0.03, penalize_outside=True, linear_max=1000.0),
    dict(sigma=0.03, penalize_outside=False, linear_max=1000.0),
    dict(sigma=0.03, penalize_outside=True, linear_max=0.05),
]
IDS = ["default", "sigma3cm", "inside-only", "linear_max"]


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_repulsion_loss_matches_jax(kw):
    tris, pairs = _soup(0)
    want = np.asarray(jax_loss(jnp.asarray(tris), jnp.asarray(pairs), **kw))
    got = repulsion_loss(torch.from_numpy(tris), torch.from_numpy(pairs),
                         **kw)
    assert got.shape == (B,) and got.dtype == torch.float32
    assert (want > 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_repulsion_gradient_matches_jax(kw):
    tris, pairs = _soup(1)
    want = np.asarray(jax_grad(jnp.asarray(tris), jnp.asarray(pairs),
                               kw["sigma"], kw["penalize_outside"],
                               kw["linear_max"]))
    x = torch.from_numpy(tris).requires_grad_()
    loss = repulsion_loss(x, torch.from_numpy(pairs), **kw)
    got, = torch.autograd.grad((loss * torch.from_numpy(WEIGHTS)).sum(), x)
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got.numpy() - want).max() <= 1e-4 * scale
    # faces that no valid pair names get exactly 0
    named = np.zeros((B, F), bool)
    for b in range(B):
        for r, i in pairs[b]:
            if r >= 0 and i >= 0:
                named[b, [r, i]] = True
    assert (got.numpy()[~named] == 0).all() and (~named).any()


def test_penalty_parts_match_jax():
    """circumcircle, the intensity's bands and the cone field alone."""
    tris, _ = _soup(2)
    t = tris.reshape(-1, 3, 3)
    jrad, jcen = jax.jit(jr.circumcircle)(jnp.asarray(t))
    rad, cen = tr.circumcircle(torch.from_numpy(t))
    np.testing.assert_allclose(rad.numpy(), np.asarray(jrad), rtol=1e-5)
    np.testing.assert_allclose(cen.numpy(), np.asarray(jcen), atol=1e-6)
    x = np.linspace(-2.0, 2.0, 401, dtype=np.float32)
    for po in (True, False):
        want = np.asarray(jax.jit(jr.repulsion_intensity, static_argnums=2)(
            jnp.asarray(x), 0.3, po, 1.5))
        got = tr.repulsion_intensity(torch.from_numpy(x), 0.3, po, 1.5)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_all_padded_pairs_give_zero():
    tris, pairs = _soup(3)
    pairs[:] = -1
    x = torch.from_numpy(tris).requires_grad_()
    loss = repulsion_loss(x, torch.from_numpy(pairs))
    assert (loss == 0).all()
    grad, = torch.autograd.grad(loss.sum(), x)
    assert (grad == 0).all()
    want = np.asarray(jax_loss(jnp.asarray(tris), jnp.asarray(pairs)))
    assert (want == 0).all()
