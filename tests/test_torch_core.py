"""Parity of the port's core math (rotations, geometry, kinematics) and its
copy of the synthetic-asset generator against the JAX package.

Inputs are seeded numpy arrays handed to both sides. Tolerances: f32
results of the same formulas in another framework agree to a few ulps;
atol 1e-6 on unit-scale rotations and metre-scale coordinates leaves
room for a different summation order in the small matmuls.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.core import geometry as jgeo
from shapy_tpu.core import kinematics as jkin
from shapy_tpu.core import rotations as jrot
from shapy_tpu.models.body import assets as jassets
from shapy_tpu_torch.core import geometry, kinematics, rotations
from shapy_tpu_torch.models.body import assets

torch.set_num_threads(2)
ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("fn", ["aa_to_rotmat", "rot6d_to_rotmat",
                                "rotmat_to_euler_y"])
def test_rotations_match_jax(fn):
    rng = np.random.default_rng(0)
    if fn == "aa_to_rotmat":
        x = rng.normal(size=(4, 7, 3)).astype(np.float32)
    elif fn == "rot6d_to_rotmat":
        x = rng.normal(size=(4, 7, 6)).astype(np.float32)
    else:
        aa = rng.normal(size=(4, 7, 3)).astype(np.float32)
        x = np.asarray(jrot.aa_to_rotmat(jnp.asarray(aa)))
    want = np.asarray(getattr(jrot, fn)(jnp.asarray(x)))
    got = getattr(rotations, fn)(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_geometry_matches_jax():
    rng = np.random.default_rng(1)
    B, V, L, J, F = 3, 50, 12, 9, 40
    betas = rng.normal(size=(B, L)).astype(np.float32)
    dirs = rng.normal(size=(V, 3, L)).astype(np.float32) * 0.01
    verts = rng.normal(size=(B, V, 3)).astype(np.float32)
    jreg = rng.uniform(size=(J, V)).astype(np.float32)
    faces = rng.integers(0, V, size=(F, 3))
    lmk_idx = rng.integers(0, F, size=(11,))
    bary = rng.uniform(size=(11, 3)).astype(np.float32)

    np.testing.assert_allclose(
        geometry.blend_shapes(_t(betas), _t(dirs)).numpy(),
        np.asarray(jgeo.blend_shapes(jnp.asarray(betas), jnp.asarray(dirs))),
        atol=ATOL)
    np.testing.assert_allclose(
        geometry.vertices2joints(_t(jreg), _t(verts)).numpy(),
        np.asarray(jgeo.vertices2joints(jnp.asarray(jreg),
                                        jnp.asarray(verts))),
        atol=1e-5)  # sums of 50 unit-scale products
    np.testing.assert_allclose(
        geometry.vertices2landmarks(_t(verts), _t(faces), _t(lmk_idx),
                                    _t(bary)).numpy(),
        np.asarray(jgeo.vertices2landmarks(
            jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(lmk_idx),
            jnp.asarray(bary))),
        atol=ATOL)


def test_kinematics_matches_jax():
    rng = np.random.default_rng(2)
    J = 55
    parents = np.concatenate([[-1], (np.arange(1, J) - 1) // 2])
    levels = kinematics.compute_level_schedule(parents)
    want_levels = jkin.compute_level_schedule(parents)
    assert len(levels) == len(want_levels)
    for a, b in zip(levels, want_levels):
        np.testing.assert_array_equal(a, b)

    aa = rng.normal(size=(3, J, 3)).astype(np.float32) * 0.5
    rot = np.asarray(jrot.aa_to_rotmat(jnp.asarray(aa)))
    joints = rng.normal(size=(3, J, 3)).astype(np.float32) * 0.3
    want = jkin.batch_rigid_transform(jnp.asarray(rot), jnp.asarray(joints),
                                      parents)
    got = kinematics.batch_rigid_transform(_t(rot), _t(joints), parents)
    for g, w in zip(got, want):
        # world transforms compose up to 6 levels of 4x4 products
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("kwargs", [
    {"subdivisions": 2},
    {"subdivisions": 5, "exact_counts": True},
], ids=["subdiv2", "exact_counts"])
def test_asset_copy_is_identical(kwargs):
    got = assets.make_synthetic_model_data("smplx", **kwargs)
    want = jassets.make_synthetic_model_data("smplx", **kwargs)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
