"""The regressor family against the JAX package's: ``build_body_head``
builds ``SMPLRegressor``, ``SMPLHRegressor`` and ``SMPLXRegressor`` from one
config dict (ResNet-18 at 64^2, batch 2, 2 stages, MLP (32,), synthetic
bodies at ``subdivisions`` 1, measurements with 64 hull directions), with
a mean-pose pickle (latin1) and a shape-mean ``.npy`` written here; the
weights come from the JAX head through ``load_regressor_from_jax``.

Tolerances, those of ``tests/test_torch_resnet.py``'s slice: rel 1e-4 on
features (atol 1e-4), betas (atol 1e-5) and measurements; atol 1e-5 m on
vertices, joints and the projection; ``param_mean`` exact.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.measure import BodyMeasurements as JBodyMeasurements
from shapy_tpu.measure import MeasurementAnchors as JAnchors
from shapy_tpu.models.body import model as jbody
from shapy_tpu.models.heads import build_body_head as jbuild_body_head
from shapy_tpu_torch.io.from_jax import load_regressor_from_jax
from shapy_tpu_torch.measure.measurements import (
    BodyMeasurements,
    MeasurementAnchors,
)
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
from shapy_tpu_torch.models.body.model import MODEL_CLASSES
from shapy_tpu_torch.models.heads.regressor import (
    BODY_HEAD_REGISTRY,
    SMPLHRegressor,
    SMPLRegressor,
    SMPLXRegressor,
    build_body_head,
)
from tests.test_torch_regressor import _perturbed_params

torch.set_num_threads(2)
HEADS = {"SMPLRegressor": ("smpl", 23), "SMPLHRegressor": ("smplh", 21),
         "SMPLXRegressor": ("smplx", 21)}


def _cfg(head, tmp_path, with_means=True, **network):
    model_type, joints = HEADS[head]
    rng = np.random.default_rng(len(head))
    body = {"global_rot": {"type": "cont_rot_repr"},
            "body_pose": {"type": "cont_rot_repr"}}
    if with_means:
        pose = tmp_path / f"{model_type}_mean_pose.pkl"
        with open(pose, "wb") as f:  # the reference's layout, protocol 2
            pickle.dump({"body_pose": {"cont_rot_repr": rng.normal(
                size=joints * 6).astype(np.float32) * 0.1}}, f, protocol=2)
        shape = tmp_path / f"{model_type}_shape_mean.npy"
        np.save(shape, rng.normal(size=(1, 16)).astype(np.float32))
        body.update(mean_pose_path=str(pose), shape_mean_path=str(shape))
    sub = {"num_stages": 2, "predict_hands": False, "predict_face": False,
           "backbone": {"type": "resnet", "depth": 18},
           "mlp": {"layers": [32], "dropout": 0.0},
           "camera": {"type": "weak-persp", "pos_func": "softplus"},
           **network}
    return {"network": {"type": head, model_type: sub},
            "body_model": {"type": model_type, model_type: body}}


def _heads(head, tmp_path):
    model_type = HEADS[head][0]
    cfg = _cfg(head, tmp_path)
    data = make_synthetic_model_data(model_type, subdivisions=1, seed=2)
    jmodel = jbody.MODEL_CLASSES[model_type](model_data=data)
    v_t = np.asarray(jmodel.params["v_template"])
    jreg = jbuild_body_head(
        cfg, body_model=jmodel,
        measurements=JBodyMeasurements(
            anchors=JAnchors.synthetic(jmodel.faces, v_t),
            num_hull_directions=64))
    model = MODEL_CLASSES[model_type](data)
    reg = build_body_head(
        cfg, body_model=model,
        measurements=BodyMeasurements(
            MeasurementAnchors.synthetic(model.faces, v_t), model.faces,
            num_hull_directions=64))
    return jreg, reg


@pytest.mark.parametrize("head", list(HEADS))
def test_body_head_matches_jax(head, tmp_path):
    jreg, reg = _heads(head, tmp_path)
    assert type(reg) is BODY_HEAD_REGISTRY[head]
    assert reg.MODEL_TYPE == HEADS[head][0] == reg.model.NAME
    assert reg.param_slices == jreg.param_slices
    np.testing.assert_array_equal(reg.param_mean.numpy(),
                                  np.asarray(jreg.params["param_mean"]))
    # the mean files landed in the mean vector
    sl = reg.param_slices["betas"]
    np.testing.assert_array_equal(
        reg.param_mean[0, sl].numpy(),
        np.load(_cfg(head, tmp_path)["body_model"][HEADS[head][0]][
            "shape_mean_path"]).reshape(-1)[:10])

    params = _perturbed_params(jreg.params, jreg.param_slices, seed=4)
    load_regressor_from_jax(reg, params)
    reg.prepare_for_eval_()
    rng = np.random.default_rng(5)
    images = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = jreg.apply(jax.tree_util.tree_map(jnp.asarray, params),
                      jnp.asarray(images))
    with torch.inference_mode():
        got = reg.apply(torch.from_numpy(images))
    np.testing.assert_allclose(got["features"].numpy(),
                               np.asarray(want["features"]), rtol=1e-4,
                               atol=1e-4)
    last, jlast = got["stage_01"], want["stage_01"]
    betas = last["betas"].numpy()
    assert np.abs(betas[0] - betas[1]).max() > 1e-3  # image-dependent
    np.testing.assert_allclose(betas, np.asarray(jlast["betas"]), rtol=1e-4,
                               atol=1e-5)
    for key in ("global_rot", "body_pose", "vertices", "joints", "v_shaped"):
        np.testing.assert_allclose(last[key].numpy(), np.asarray(jlast[key]),
                                   atol=1e-5, err_msg=key)
    np.testing.assert_allclose(got["proj_joints"].numpy(),
                               np.asarray(want["proj_joints"]), atol=1e-5)
    assert set(got["measurements"]) == set(want["measurements"])
    for k, v in got["measurements"].items():
        np.testing.assert_allclose(v.numpy(),
                                   np.asarray(want["measurements"][k]),
                                   rtol=1e-4, err_msg=k)


def test_body_head_without_mean_files(tmp_path):
    """Paths that name no file are ignored, as the JAX package ignores
    them: the identity 6D body-pose mean and zero betas."""
    cfg = _cfg("SMPLXRegressor", tmp_path, with_means=False)
    cfg["body_model"]["smplx"]["mean_pose_path"] = str(tmp_path / "no.pkl")
    data = make_synthetic_model_data("smplx", subdivisions=1, seed=2)
    reg = build_body_head(cfg, body_model=MODEL_CLASSES["smplx"](data))
    jreg = jbuild_body_head(cfg, body_model=jbody.SMPLX(model_data=data))
    np.testing.assert_array_equal(reg.param_mean.numpy(),
                                  np.asarray(jreg.params["param_mean"]))
    assert reg.body_measurements is None


def test_body_head_builds_its_body_model(tmp_path):
    """Without a ``body_model`` the head builds it from the config's
    ``model_folder`` (release files written here); keys the body class
    does not take (``betas``, the pose spaces) are ignored."""
    from shapy_tpu_torch.models.body.assets import MODEL_FILE_TEMPLATES

    data = make_synthetic_model_data("smpl", subdivisions=1, seed=2)
    np.savez(tmp_path / MODEL_FILE_TEMPLATES["smpl"].format(
        gender="NEUTRAL", ext="npz"), **data)
    cfg = _cfg("SMPLRegressor", tmp_path, with_means=False)
    cfg["body_model"]["model_folder"] = str(tmp_path)
    cfg["body_model"]["smpl"]["betas"] = {"num": 10}
    reg = build_body_head(cfg)
    assert isinstance(reg, SMPLRegressor)
    np.testing.assert_array_equal(reg.model.v_template.numpy(),
                                  data["v_template"].astype(np.float32))


@pytest.mark.parametrize("head,network,match", [
    ("SMPLHRegressor", {"predict_hands": True}, "predict_hands"),
    ("SMPLXRegressor", {"predict_face": True}, "predict_face"),
    ("SMPLXRegressor", {"pose_last_stage": False}, "pose_last_stage"),
    ("SMPLRegressor", {"mlp": {"layers": [32], "activation":
                               {"type": "relu"}}}, "activations"),
    ("SMPLRegressor", {"type": "iterative-rnn"}, "iterative-mlp"),
])
def test_body_head_refuses_options_not_ported(head, network, match,
                                              tmp_path):
    cfg = _cfg(head, tmp_path, with_means=False, **network)
    data = make_synthetic_model_data(HEADS[head][0], subdivisions=1, seed=2)
    with pytest.raises(ValueError, match=match):
        build_body_head(cfg, body_model=MODEL_CLASSES[HEADS[head][0]](data))


def test_smpl_head_ignores_hand_and_face_flags(tmp_path):
    """SMPL has no hands or face: its head takes the flags' defaults (on),
    as the JAX package's does; SMPL+H takes ``predict_face``."""
    data = make_synthetic_model_data("smpl", subdivisions=1, seed=2)
    cfg = _cfg("SMPLRegressor", tmp_path, with_means=False,
               predict_hands=True, predict_face=True)
    assert isinstance(build_body_head(
        cfg, body_model=MODEL_CLASSES["smpl"](data)), SMPLRegressor)
    data = make_synthetic_model_data("smplh", subdivisions=1, seed=2)
    cfg = _cfg("SMPLHRegressor", tmp_path, with_means=False,
               predict_face=True)
    assert isinstance(build_body_head(
        cfg, body_model=MODEL_CLASSES["smplh"](data)), SMPLHRegressor)
    with pytest.raises(ValueError, match="Unknown body head"):
        build_body_head({"network": {"type": "MANORegressor"}})
    assert issubclass(SMPLXRegressor, SMPLHRegressor)


def test_demo_builder(tmp_path, monkeypatch):
    """``build_demo_regressor`` on the synthetic body (the JAX package's
    environment variables); absent plugin checkpoints are ignored; a pair
    of real B2A checkpoints loads, its output that of the JAX builder's
    ``_load_pair``; a reference checkpoint that exists is imported (its
    ``regressor.mean_param`` lands in ``param_mean``)."""
    from shapy_tpu.cli.demo import build_demo_regressor as jbuild_demo
    from shapy_tpu_torch.cli.demo import build_demo_regressor
    from tests.test_torch_attr_plugins import write_plugin_checkpoints

    monkeypatch.setenv("SHAPY_TPU_SYNTHETIC_BODY", "1")
    monkeypatch.setenv("SHAPY_TPU_TEST_SUBDIV", "1")
    cfg = _cfg("SMPLXRegressor", tmp_path, with_means=False,
               use_b2a=True, b2a_males_checkpoint=str(tmp_path / "m.ckpt"),
               b2a_females_checkpoint=str(tmp_path / "f.ckpt"))
    reg = build_demo_regressor(cfg, str(tmp_path / "none.ckpt"), "cpu")
    assert isinstance(reg, SMPLXRegressor) and not reg.b2a_models
    assert reg.model.num_verts == 42 and not reg.body_measurements.has_subsets
    keys = write_plugin_checkpoints(tmp_path, n_train=40)
    cfg["network"]["smplx"].update(
        b2a_males_checkpoint=keys["b2a_males_checkpoint"],
        b2a_females_checkpoint=keys["b2a_females_checkpoint"])
    reg = build_demo_regressor(cfg, device="cpu")
    jreg = jbuild_demo(cfg)
    assert set(reg.b2a_models) == set(jreg.b2a_models) == {"male", "female"}
    betas = np.random.default_rng(0).normal(size=(3, 10)).astype(np.float32)
    for g in ("male", "female"):
        with torch.no_grad():
            got = reg.b2a_models[g](torch.from_numpy(betas)).numpy()
        np.testing.assert_allclose(
            got, np.asarray(jreg.b2a_models[g](jnp.asarray(betas))),
            rtol=1e-5, atol=1e-5)
    cfg["network"]["smplx"]["use_b2a"] = False
    mean = torch.arange(reg.param_mean.numel(), dtype=torch.float32)
    torch.save({"model": {"regressor.mean_param": mean}},
               tmp_path / "ref.ckpt")
    loaded = build_demo_regressor(cfg, str(tmp_path / "ref.ckpt"), "cpu")
    np.testing.assert_array_equal(loaded.param_mean.numpy().reshape(-1),
                                  mean.numpy())
    cfg["network"]["smplx"]["compute_dtype"] = "float16"
    with pytest.raises(ValueError, match="compute_dtype"):
        build_demo_regressor(cfg, device="cpu")
