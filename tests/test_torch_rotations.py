"""The port's remaining rotation and edge helpers against the JAX package
(``core/rotations.py`` ``rotmat_to_aa``, ``rotmat_to_rot6d``,
``svd_project_rotation``, ``quat_to_rotmat``; ``core/geometry.py``
``edge_vectors``, ``faces_to_edges``) on the same seeded numpy inputs.

Tolerances: atol 1e-6 for the closed forms (a few f32 ulps of unit-scale
values); ``rotmat_to_aa`` atol 2e-6 rad away from the clipped ends and
2e-5 within 1e-3 rad of 0 and of pi, where ``arccos`` is steep (its slope
reaches ~2e3 at the clip, so one ulp of the trace moves the angle by
~1e-4 of a radian; both sides clip at the same f32 constant);
``svd_project_rotation`` atol 1e-5 against the JAX result and against
an f64 SVD, 5e-5 for inputs near a reflection (the determinant fix flips
the weakest direction; both f32 SVDs then sit ~1e-5 from the f64 one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.core import geometry as jgeo
from shapy_tpu.core import rotations as jrot
from shapy_tpu_torch.core import geometry, rotations

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rotmats(aa):
    return np.asarray(jrot.aa_to_rotmat(jnp.asarray(aa, jnp.float32)))


def _axes(rng, n):
    ax = rng.normal(size=(n, 3))
    return ax / np.linalg.norm(ax, axis=1, keepdims=True)


@pytest.mark.parametrize("regime,angles,atol", [
    ("generic", (0.1, 3.0), 2e-6),
    ("near_zero", (0.0, 1e-3), 2e-5),
    ("near_pi", (np.pi - 1e-3, np.pi), 2e-5),
])
def test_rotmat_to_aa_matches_jax(regime, angles, atol):
    """The eps branches: below 1e-5 rad the unnormalised skew part is the
    axis; the cosine is clipped at 1 - 1e-7 and -1 + 1e-7."""
    rng = np.random.default_rng(7)
    theta = rng.uniform(*angles, size=(64, 1))
    if regime == "near_zero":
        theta[:8] = 0.0
        theta[8:16] = rng.uniform(0, 1e-5, size=(8, 1))
    R = _rotmats((_axes(rng, 64) * theta).astype(np.float32))
    want = np.asarray(jrot.rotmat_to_aa(jnp.asarray(R)))
    got = rotations.rotmat_to_aa(_t(R)).numpy()
    assert got.shape == want.shape == (64, 3)
    np.testing.assert_allclose(got, want, atol=atol)
    # batch dimensions are kept
    got4 = rotations.rotmat_to_aa(_t(R).reshape(4, 16, 3, 3))
    assert torch.equal(got4.reshape(64, 3), torch.from_numpy(got))


def test_rotmat_to_rot6d_matches_jax():
    rng = np.random.default_rng(8)
    R = _rotmats((_axes(rng, 30) * rng.uniform(0, 3, (30, 1))).astype(
        np.float32)).reshape(5, 6, 3, 3)
    want = np.asarray(jrot.rotmat_to_rot6d(jnp.asarray(R)))
    got = rotations.rotmat_to_rot6d(_t(R)).numpy()
    np.testing.assert_array_equal(got, want)
    back = rotations.rot6d_to_rotmat(_t(got)).numpy()
    np.testing.assert_allclose(back, R, atol=1e-6)


@pytest.mark.parametrize("kind,atol", [("noisy_rotation", 1e-5),
                                       ("reflection", 5e-5),
                                       ("random", 1e-5)])
def test_svd_project_rotation_matches_jax(kind, atol):
    """A reflection-producing input (det < 0) is where the determinant fix
    acts and where two SVDs' sign conventions could differ."""
    rng = np.random.default_rng(9)
    R = _rotmats((_axes(rng, 40) * rng.uniform(0, 3, (40, 1))).astype(
        np.float32))
    if kind == "noisy_rotation":
        M = R + rng.normal(size=R.shape) * 0.05
    elif kind == "reflection":
        M = R @ np.diag([1.0, 1.0, -1.0]) + rng.normal(size=R.shape) * 0.05
        assert (np.linalg.det(M) < 0).all()
    else:
        M = rng.normal(size=R.shape)
    M = M.astype(np.float32)
    want = np.asarray(jrot.svd_project_rotation(jnp.asarray(M)))
    got = rotations.svd_project_rotation(_t(M)).numpy()
    U, _, Vt = np.linalg.svd(M.astype(np.float64))
    det = np.linalg.det(U @ Vt)
    exact = (U * np.stack([np.ones_like(det), np.ones_like(det), det],
                          -1)[:, None, :]) @ Vt
    np.testing.assert_allclose(got, want, atol=atol)
    np.testing.assert_allclose(got, exact, atol=atol)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)
    np.testing.assert_allclose(got @ np.swapaxes(got, -1, -2),
                               np.broadcast_to(np.eye(3), got.shape),
                               atol=1e-5)


def test_quat_to_rotmat_matches_jax():
    rng = np.random.default_rng(10)
    q = rng.normal(size=(3, 7, 4)).astype(np.float32) * 2.0
    q[0, 0] = [1.0, 0.0, 0.0, 0.0]
    want = np.asarray(jrot.quat_to_rotmat(jnp.asarray(q)))
    got = rotations.quat_to_rotmat(_t(q)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got[0, 0], np.eye(3), atol=0)


def test_edges_match_jax():
    from shapy_tpu_torch.models.body.assets import icosphere

    rng = np.random.default_rng(11)
    _, faces = icosphere(2)
    edges = geometry.faces_to_edges(faces)
    want = jgeo.faces_to_edges(faces)
    np.testing.assert_array_equal(edges, want)
    assert edges.shape == (len(faces) * 3 // 2, 2)  # closed mesh: E = 3F/2
    verts = rng.normal(size=(3, int(faces.max()) + 1, 3)).astype(np.float32)
    got = geometry.edge_vectors(_t(verts), _t(edges)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jgeo.edge_vectors(jnp.asarray(verts),
                                          jnp.asarray(edges))))
