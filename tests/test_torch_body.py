"""Parity of the port's SMPL-X forward (and of kernel K3's plain version)
with the JAX package.

The same synthetic SMPL-X assets, betas, expression and 6D-decoded poses
go to both sides. Tolerance atol 1e-5 m: vertices are metre-scale sums of
~55 weighted 4x4 transforms composed over the tree's depth in f32, so a
different summation order moves them by some 1e-7 m; 1e-5 still catches
any wrong index, transpose or pose-group order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.core.rotations import rot6d_to_rotmat as jrot6d
from shapy_tpu.models.body import SMPLX as JSMPLX
from shapy_tpu_torch.core.rotations import rot6d_to_rotmat
from shapy_tpu_torch.io.from_jax import load_body_model_from_jax
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
from shapy_tpu_torch.models.body.lbs import skin, skin_plain
from shapy_tpu_torch.models.body.model import SMPLX

torch.set_num_threads(2)
ATOL = 1e-5
GROUPS = {"global_rot": 1, "body_pose": 21, "jaw_pose": 1, "leye_pose": 1,
          "reye_pose": 1, "left_hand_pose": 15, "right_hand_pose": 15}


@pytest.fixture(scope="module")
def models():
    data = make_synthetic_model_data("smplx", subdivisions=2, seed=3)
    return JSMPLX(model_data=data), SMPLX(data)


def _inputs(B, seed):
    rng = np.random.default_rng(seed)
    kw = {"betas": rng.normal(size=(B, 10)).astype(np.float32),
          "expression": rng.normal(size=(B, 10)).astype(np.float32)}
    for name, n in GROUPS.items():
        six = np.tile([1, 0, 0, 1, 0, 0], (B, n, 1)) + 0.4 * rng.normal(
            size=(B, n, 6))
        kw[name] = np.asarray(jrot6d(jnp.asarray(six, jnp.float32)))
    return kw


def test_state_dict_keys_are_jax_param_names(models):
    jmodel, model = models
    # The kernels take the body model's buffers as they are.
    assert all(b.is_contiguous() for b in model.buffers())
    own = set(model.state_dict())
    assert own <= set(jmodel.params)
    assert set(jmodel.params) - own == {"dynamic_lmk_faces_idx",
                                        "dynamic_lmk_bary_coords"}


def test_smplx_forward_matches_jax(models):
    jmodel, model = models
    kw = _inputs(3, seed=0)
    want = jmodel(**{k: jnp.asarray(v) for k, v in kw.items()})
    got = model(**{k: torch.from_numpy(v) for k, v in kw.items()})
    for key in ("vertices", "joints", "v_shaped"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, err_msg=key)


def test_from_jax_body_params_roundtrip(models):
    jmodel, _ = models
    other = SMPLX(make_synthetic_model_data("smplx", subdivisions=2, seed=4))
    load_body_model_from_jax(other, {k: np.asarray(v)
                                     for k, v in jmodel.params.items()})
    kw = _inputs(2, seed=1)
    want = jmodel(**{k: jnp.asarray(v) for k, v in kw.items()})
    got = other(**{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(got["vertices"].numpy(),
                               np.asarray(want["vertices"]), atol=ATOL)


def test_rot6d_decoded_pose_and_default_groups(models):
    """Missing pose groups are identity and missing expression is zero,
    as in the JAX model."""
    jmodel, model = models
    rng = np.random.default_rng(5)
    six = (np.tile([1, 0, 0, 1, 0, 0], (2, 22, 1))
           + 0.3 * rng.normal(size=(2, 22, 6))).astype(np.float32)
    betas = rng.normal(size=(2, 10)).astype(np.float32)
    want = jmodel(betas=jnp.asarray(betas),
                  global_rot=jrot6d(jnp.asarray(six[:, :1])),
                  body_pose=jrot6d(jnp.asarray(six[:, 1:])))
    t6 = torch.from_numpy(six)
    got = model(betas=torch.from_numpy(betas),
                global_rot=rot6d_to_rotmat(t6[:, :1]),
                body_pose=rot6d_to_rotmat(t6[:, 1:]))
    np.testing.assert_allclose(got["vertices"].numpy(),
                               np.asarray(want["vertices"]), atol=ATOL)


def test_skin_plain_matches_jax_einsum():
    rng = np.random.default_rng(6)
    B, V, J = 2, 300, 55
    w = rng.uniform(size=(V, J)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    A = rng.normal(size=(B, J, 4, 4)).astype(np.float32)
    vp = rng.normal(size=(B, V, 3)).astype(np.float32)
    T = jnp.einsum("vj,bjmn->bvmn", jnp.asarray(w), jnp.asarray(A))
    v_hom = jnp.concatenate([jnp.asarray(vp), jnp.ones((B, V, 1))], -1)
    want = np.asarray(jnp.einsum("bvmn,bvn->bvm", T[..., :3, :], v_hom))
    got = skin_plain(torch.from_numpy(w), torch.from_numpy(A),
                     torch.from_numpy(vp)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # On CPU tensors the wrapper is the plain version.
    np.testing.assert_array_equal(
        skin(torch.from_numpy(w), torch.from_numpy(A),
             torch.from_numpy(vp)).numpy(), got)


def test_skin_rejects_other_devices():
    """A wrapper takes its plain version only for CPU tensors."""
    t = torch.empty((1, 4, 3), device="meta")
    with pytest.raises(ValueError):
        skin(torch.empty((4, 2), device="meta"),
             torch.empty((1, 2, 4, 4), device="meta"), t)
