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

from shapy_tpu.core.rotations import aa_to_rotmat as jaa_to_rotmat
from shapy_tpu.core.rotations import rot6d_to_rotmat as jrot6d
from shapy_tpu.data import keypoints as jkeypoints
from shapy_tpu.models.body import SMPL as JSMPL
from shapy_tpu.models.body import SMPLX as JSMPLX
from shapy_tpu_torch.data import keypoints
from shapy_tpu_torch.core.rotations import rot6d_to_rotmat
from shapy_tpu_torch.io.from_jax import load_body_model_from_jax
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
from shapy_tpu_torch.models.body.lbs import skin, skin_plain
from shapy_tpu_torch.models.body.model import SMPL, SMPLX

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
    assert set(model.state_dict()) == set(jmodel.params)


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


def _close(got, want, keys):
    assert set(got) == set(want), (set(got), set(want))
    for key in keys:
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]),
                                   atol=ATOL, err_msg=key)


@pytest.mark.parametrize("options", [
    dict(transl=True),
    dict(transl=True, get_skin=False, return_full_pose=True),
    dict(return_shaped=False, return_full_pose=True),
])
def test_forward_options_match_jax(models, options):
    """``transl`` moves joints and vertices; ``get_skin``,
    ``return_full_pose`` and ``return_shaped`` select the outputs."""
    jmodel, model = models
    kw = _inputs(2, seed=2)
    options = dict(options)
    if options.pop("transl", False):
        kw["transl"] = np.asarray([[0.5, -1.0, 2.0], [0.0, 0.3, -0.2]],
                                  np.float32)
    want = jmodel(**{k: jnp.asarray(v) for k, v in kw.items()}, **options)
    got = model(**{k: torch.from_numpy(v) for k, v in kw.items()}, **options)
    _close(got, want, [k for k in want if k != "faces"])
    np.testing.assert_array_equal(got["faces"], want["faces"])


def test_unknown_keyword_raises(models):
    _, model = models
    with pytest.raises(TypeError, match="bodypose"):
        model(bodypose=torch.zeros(1, 21, 3, 3))
    with pytest.raises(TypeError, match="expression"):
        SMPL(make_synthetic_model_data("smpl", subdivisions=1))(
            expression=torch.zeros(1, 10))


def test_model_options_match_jax():
    """Extra joints on the mesh, the J14 override, a ``v_template``
    override and the dynamic face contour at neck yaws across the table's
    range; ``num_faces`` and ``keypoint_names``."""
    data = make_synthetic_model_data("smplx", subdivisions=2, seed=5)
    rng = np.random.default_rng(8)
    V, F = data["v_template"].shape[0], data["f"].shape[0]
    bcs = rng.dirichlet(np.ones(3), size=4).astype(np.float32)
    reg = rng.uniform(size=(14, V)).astype(np.float32)
    reg /= reg.sum(1, keepdims=True)
    opts = dict(
        v_template=data["v_template"] * 1.1,
        extra_joint_faces=rng.integers(0, F, size=4),
        extra_joint_bcs=bcs, extra_joint_names=[f"x{i}" for i in range(4)],
        j14_regressor=reg, j14_source_idxs=np.arange(3, 17),
        j14_target_idxs=np.arange(14)[::-1], use_face_contour=True)
    jmodel, model = JSMPLX(model_data=data, **opts), SMPLX(data, **opts)
    assert model.num_faces == jmodel.num_faces == F
    assert model.keypoint_names == jmodel.keypoint_names
    assert len(model.keypoint_names) == 55 + 51 + 17 + 4
    kw = _inputs(2, seed=3)
    # Neck yaws (axis-angle about y on the neck chain's first joint) past
    # both ends of the table and in between.
    rows = []
    for yaw in ((-1.2, 0.5), (0.3, -0.05), (0.9, -0.6)):
        body = np.zeros((2, 21, 3), np.float32)
        body[:, 14, 1] = yaw  # joint 15, the head
        kw["body_pose"] = np.asarray(jaa_to_rotmat(jnp.asarray(body)))
        want = jmodel(return_full_pose=True,
                      **{k: jnp.asarray(v) for k, v in kw.items()})
        got = model(return_full_pose=True,
                    **{k: torch.from_numpy(v) for k, v in kw.items()})
        _close(got, want, ("joints", "vertices", "v_shaped", "full_pose"))
        pose = np.asarray(want["full_pose"])
        faces_idx = model._dynamic_contour(torch.from_numpy(pose))[0]
        np.testing.assert_array_equal(faces_idx.numpy(), np.asarray(
            jmodel._dynamic_contour(jnp.asarray(pose), jmodel.params)[0]))
        rows.extend(_contour_rows(model, pose))
    assert min(rows) == 0 and max(rows) == 78 and len(set(rows)) >= 4


def _contour_rows(model, pose):
    """The dynamic table's rows the port picks for full poses ``pose``."""
    table = model.dynamic_lmk_faces_idx
    picked = model._dynamic_contour(torch.from_numpy(pose))[0]
    return [int((table == row).all(-1).nonzero()[0, 0]) for row in picked]


@pytest.mark.parametrize("flat_hand_mean", [True, False])
def test_hand_pca_matches_jax(flat_hand_mean):
    data = make_synthetic_model_data("smplx", subdivisions=1, seed=6)
    jmodel = JSMPLX(model_data=data, num_hand_components=12,
                    flat_hand_mean=flat_hand_mean)
    model = SMPLX(data, num_hand_components=12, flat_hand_mean=flat_hand_mean)
    coeffs = np.random.default_rng(9).normal(size=(2, 12)).astype(np.float32)
    for side in ("l", "r"):
        np.testing.assert_allclose(
            model.hand_pca_to_rotmats(torch.from_numpy(coeffs), side).numpy(),
            np.asarray(jmodel.hand_pca_to_rotmats(jnp.asarray(coeffs), side)),
            atol=1e-6)


def test_from_jax_loads_every_body_param():
    """No JAX param is skipped: the options' params load too, and a param
    the port lacks raises."""
    data = make_synthetic_model_data("smpl", subdivisions=1, seed=2)
    V = data["v_template"].shape[0]
    opts = dict(extra_joint_faces=np.arange(2),
                extra_joint_bcs=np.full((2, 3), 1 / 3, np.float32),
                j14_regressor=np.full((14, V), 1.0 / V, np.float32),
                j14_source_idxs=np.arange(14), j14_target_idxs=np.arange(14))
    jmodel = JSMPL(model_data=data, **opts)
    other = SMPL(make_synthetic_model_data("smpl", subdivisions=1, seed=3),
                 **opts)
    params = {k: np.asarray(v) for k, v in jmodel.params.items()}
    load_body_model_from_jax(other, params)
    for k, v in params.items():
        np.testing.assert_array_equal(other.state_dict()[k].numpy(), v)
    with pytest.raises(KeyError):
        load_body_model_from_jax(other, {**params, "unknown": params["posedirs"]})


def test_keypoints_copy_matches_jax():
    names = [k for k in dir(jkeypoints) if k.isupper()]
    for k in names:
        assert getattr(keypoints, k) == getattr(jkeypoints, k), k
    for fmt in keypoints.KEYPOINT_NAMES_DICT:
        for contour in (True, False):
            assert keypoints.model_keypoint_names(fmt, contour) == \
                jkeypoints.model_keypoint_names(fmt, contour)
        for a, b in zip(keypoints.get_part_idxs(fmt).items(),
                        jkeypoints.get_part_idxs(fmt).items()):
            assert a[0] == b[0]
            np.testing.assert_array_equal(a[1], b[1])
        assert keypoints.flip_pairs(fmt) == jkeypoints.flip_pairs(fmt)
        np.testing.assert_array_equal(keypoints.flip_permutation(fmt),
                                      jkeypoints.flip_permutation(fmt))
        for dst in ("smplx", "openpose25_v1", "coco"):
            for x, y in zip(keypoints.keypoint_mapping(fmt, dst),
                            jkeypoints.keypoint_mapping(fmt, dst)):
                np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(keypoints.pose_flip_permutation(55),
                                  jkeypoints.pose_flip_permutation(55))
