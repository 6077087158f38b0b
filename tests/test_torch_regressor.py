"""The port's whole slice against the JAX package: full uint8 images +
crop affines -> crop/normalise -> HRNet-W48 -> 3-stage head -> SMPL-X ->
projection -> measurements (``apply_from_full_images``).

HRNet-W48 at full width on 64x64 crops, batch 2, synthetic SMPL-X at
``subdivisions=2``, ``mlp_layers=(64, 64)``, as ``tests/test_regressor.py``
builds it. The JAX params are drawn anew in numpy (He-scaled convs, BN
running stats, gammas and betas perturbed, a betas output layer that
varies with the image) so that a folding, layout or naming bug shows, then
handed to both sides; the port gets them through ``io/from_jax``.

Tolerances: rel 1e-4 on features, betas and measurements, atol 1e-5 m on
vertices: f32 on both sides, but ~100 conv layers summed in another
order (oneDNN vs XLA) drift by some 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.data.crop import crop_to_image_affine
from shapy_tpu.measure import BodyMeasurements as JBodyMeasurements
from shapy_tpu.measure import MeasurementAnchors as JAnchors
from shapy_tpu.models.body import SMPLX as JSMPLX
from shapy_tpu.models.heads import SMPLXRegressor as JRegressor
from shapy_tpu_torch.flagship import FLAGSHIP_BODY_CFG, FLAGSHIP_NETWORK_CFG
from shapy_tpu_torch.io.from_jax import load_regressor_from_jax
from shapy_tpu_torch.measure.measurements import (
    BodyMeasurements,
    MeasurementAnchors,
    candidate_faces,
)
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
from shapy_tpu_torch.models.body.model import SMPLX
from shapy_tpu_torch.models.heads.regressor import SMPLXRegressor

torch.set_num_threads(2)
NETWORK_CFG = dict(FLAGSHIP_NETWORK_CFG,
                   mlp={"layers": [64, 64], "dropout": 0.5})
SIZE = 64


def _perturbed_params(params, param_slices, seed=0):
    """Numpy copy of the JAX regressor's params with image-dependent
    weights and non-trivial BN statistics."""
    rng = np.random.default_rng(seed)
    bb = {}
    for name, w in params["backbone"].items():
        w = np.asarray(w)
        if w.ndim == 4:  # HWIO conv kernel
            std = np.sqrt(2.0 / np.prod(w.shape[:3]))
            if "fuse_layers" in name:
                std *= 0.25
            if name.endswith("conv3.weight") or (
                    "branches" in name and name.endswith("conv2.weight")):
                std *= 0.1
            w = rng.normal(size=w.shape) * std
        elif name.endswith("running_mean") or name.endswith(".bias"):
            w = w + rng.normal(size=w.shape) * 0.1
        elif name.endswith("running_var"):
            w = rng.uniform(0.5, 2.0, size=w.shape)
        elif name.endswith(".weight"):  # BN gamma
            w = rng.uniform(0.5, 1.5, size=w.shape)
        bb[name] = w.astype(np.float32)
    head = {k: np.array(v, np.float32) for k, v in params["head"].items()}
    out_w = head["output_layer.weight"]
    sl = param_slices["betas"]
    out_w[sl] = rng.normal(size=out_w[sl].shape) * 0.25 / np.sqrt(
        out_w.shape[1])
    return {"backbone": bb, "head": head,
            "param_mean": np.asarray(params["param_mean"], np.float32)}


@pytest.fixture(scope="module")
def slice_outputs():
    data = make_synthetic_model_data("smplx", subdivisions=2, seed=0)
    jmodel = JSMPLX(model_data=data)
    v_t = np.asarray(jmodel.params["v_template"])
    shapedirs = np.asarray(jmodel.params["shapedirs"])
    janchors = JAnchors.synthetic(jmodel.faces, v_t)
    anchors = MeasurementAnchors.synthetic(jmodel.faces, v_t)
    subsets = candidate_faces(v_t, shapedirs, jmodel.faces, anchors)
    jreg = JRegressor(
        body_model_cfg=FLAGSHIP_BODY_CFG, network_cfg=NETWORK_CFG,
        body_model=jmodel,
        measurements=JBodyMeasurements(anchors=janchors,
                                       num_hull_directions=256,
                                       face_subsets=subsets))
    params = _perturbed_params(jreg.params, jreg.param_slices)

    model = SMPLX(data)
    reg = SMPLXRegressor(
        model, BodyMeasurements(anchors, model.faces, 256,
                                face_subsets=subsets),
        FLAGSHIP_BODY_CFG, NETWORK_CFG)
    keys = (set(reg.backbone.state_dict()), set(reg.head.state_dict()))
    load_regressor_from_jax(reg, params)
    reg.prepare_for_eval_()

    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, size=(2, 80, 96, 3), dtype=np.uint8)
    affines = np.stack([
        crop_to_image_affine([48.0, 40.0], 0.35, (SIZE, SIZE), rot_deg=20.0),
        crop_to_image_affine([40.0, 45.0], 0.45, (SIZE, SIZE)),
    ]).astype(np.float32)
    want = jreg.apply_from_full_images(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(images),
        jnp.asarray(affines), crop_size=SIZE)
    with torch.inference_mode():
        got = reg.apply_from_full_images(torch.from_numpy(images),
                                         torch.from_numpy(affines),
                                         crop_size=SIZE)
    return got, want, keys, jreg.params


def test_state_dict_keys_are_jax_param_names(slice_outputs):
    _, _, (backbone_keys, head_keys), jparams = slice_outputs
    assert backbone_keys == set(jparams["backbone"])
    assert head_keys == set(jparams["head"])


def test_slice_matches_jax(slice_outputs):
    got, want, _, _ = slice_outputs
    last, jlast = got["stage_02"], want["stage_02"]
    np.testing.assert_allclose(got["features"].numpy(),
                               np.asarray(want["features"]), rtol=1e-4,
                               atol=1e-4)
    betas = last["betas"].numpy()
    assert np.abs(betas[0] - betas[1]).max() > 1e-3  # image-dependent
    np.testing.assert_allclose(betas, np.asarray(jlast["betas"]), rtol=1e-4,
                               atol=1e-5)
    for key in ("vertices", "joints", "v_shaped"):
        np.testing.assert_allclose(last[key].numpy(), np.asarray(jlast[key]),
                                   atol=1e-5, err_msg=key)
    np.testing.assert_allclose(got["proj_joints"].numpy(),
                               np.asarray(want["proj_joints"]), atol=1e-5)
    assert set(got["measurements"]) == set(want["measurements"])
    for k, v in got["measurements"].items():
        assert (v.numpy() > 0).all(), k
        np.testing.assert_allclose(v.numpy(),
                                   np.asarray(want["measurements"][k]),
                                   rtol=1e-4, err_msg=k)


def test_stage_outputs_and_camera(slice_outputs):
    got, want, _, _ = slice_outputs
    for i in range(3):
        np.testing.assert_allclose(
            got[f"stage_{i:02d}"]["raw_body_pose"].numpy(),
            np.asarray(want[f"stage_{i:02d}"]["raw_body_pose"]),
            rtol=1e-4, atol=1e-5)
    cam, jcam = got["camera_parameters"], want["camera_parameters"]
    assert (cam["scale"].numpy() > 0).all()
    np.testing.assert_allclose(cam["scale"].numpy(), np.asarray(jcam["scale"]),
                               rtol=1e-4)
