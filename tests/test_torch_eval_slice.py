"""The port's evaluation slice as a whole against the JAX package's:
normalised crops -> HRNet-W48 -> 3-stage head -> SMPL-X -> measurements
-> ``Evaluator`` metrics (v2v, v2v_t, p2p_t, mpjpe, mpjpe14, measurement
errors) -> streaming group means, through each package's
``eval/loop.make_eval_fn`` on the same weights and loader.

Sizes as ``tests/test_torch_regressor.py``: HRNet-W48 at full width on
64x64 crops, batch 2 (two batches), synthetic SMPL-X at
``subdivisions=2``, MLP (64, 64); the weights are that test's perturbed
JAX params, loaded into the port through ``io/from_jax``. The config is
the reference's metric set, with P2P (P=200, K=3 barycentric rows) and
J14 regressors read from files.

Tolerance: rel 1e-4 or atol 1e-5 m per mean: the forward drifts by some
1e-6 relative over ~100 f32 conv layers summed in another order (oneDNN
vs XLA), and the metrics add sums in another order.
"""

import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
import torch

from shapy_tpu.eval import loop as jloop
from shapy_tpu.measure import BodyMeasurements as JBodyMeasurements
from shapy_tpu.measure import MeasurementAnchors as JAnchors
from shapy_tpu.models.body import SMPLX as JSMPLX
from shapy_tpu.models.heads import SMPLXRegressor as JRegressor
from shapy_tpu_torch.eval import loop as tloop
from shapy_tpu_torch.flagship import FLAGSHIP_BODY_CFG
from shapy_tpu_torch.io.from_jax import load_regressor_from_jax
from shapy_tpu_torch.measure.measurements import (
    BodyMeasurements,
    MeasurementAnchors,
    candidate_faces,
)
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
from shapy_tpu_torch.models.body.model import SMPLX
from shapy_tpu_torch.models.heads.regressor import SMPLXRegressor
from tests.test_torch_regressor import NETWORK_CFG, SIZE, _perturbed_params

torch.set_num_threads(2)
B = 2


def _loader(jmodel, faces, rng):
    """Two collated batches of normalised crops and synthetic GT."""
    V = jmodel.num_verts
    batches = []
    for _ in range(2):
        betas = jnp.asarray(rng.normal(size=(B, 10)), jnp.float32)
        pose = jnp.asarray(rng.normal(size=(B, 21, 3)) * 0.2, jnp.float32)
        gt = jmodel(betas=betas, body_pose=pose)
        j14 = np.asarray(gt["vertices"])[:, :14]
        batches.append({
            "images": rng.normal(size=(B, SIZE, SIZE, 3)).astype(np.float32),
            "gt_v_shaped": np.asarray(gt["v_shaped"]),
            "gt_vertices": np.asarray(gt["vertices"]),
            "joints3d": np.concatenate(
                [np.asarray(gt["joints"])[:, :25],
                 np.ones((B, 25, 1), np.float32)], -1),
            "joints14": j14 + 0.01,
            "joints14_valid": np.asarray([1.0, 0.0], np.float32),
            "height_gt": rng.uniform(1.5, 1.9, B).astype(np.float32),
            "chest_gt": rng.uniform(0.8, 1.2, B).astype(np.float32),
            "waist_gt": rng.uniform(0.6, 1.1, B).astype(np.float32),
            "hips_gt": rng.uniform(0.8, 1.2, B).astype(np.float32),
            "mass_gt": rng.uniform(50, 110, B).astype(np.float32),
            "gender": np.asarray([0, 1], np.int32),
            "genders": ["female", "male"],
        })
    tri = faces[rng.integers(0, len(faces), size=200)]
    w = rng.dirichlet(np.ones(3), size=200)
    p2p = sp.csr_matrix((w.reshape(-1), (np.repeat(np.arange(200), 3),
                                         tri.reshape(-1))), shape=(200, V))
    j14 = rng.uniform(size=(14, V)).astype(np.float32)
    return batches, p2p, j14 / j14.sum(1, keepdims=True)


def test_eval_slice_matches_jax(tmp_path):
    data = make_synthetic_model_data("smplx", subdivisions=2, seed=0)
    jmodel = JSMPLX(model_data=data)
    v_t = np.asarray(jmodel.params["v_template"])
    anchors = MeasurementAnchors.synthetic(jmodel.faces, v_t)
    subsets = candidate_faces(v_t, np.asarray(jmodel.params["shapedirs"]),
                              jmodel.faces, anchors)
    jreg = JRegressor(
        body_model_cfg=FLAGSHIP_BODY_CFG, network_cfg=NETWORK_CFG,
        body_model=jmodel,
        measurements=JBodyMeasurements(
            anchors=JAnchors.synthetic(jmodel.faces, v_t),
            num_hull_directions=256, face_subsets=subsets))
    params = _perturbed_params(jreg.params, jreg.param_slices)
    model = SMPLX(data)
    reg = SMPLXRegressor(
        model, BodyMeasurements(anchors, model.faces, 256,
                                face_subsets=subsets),
        FLAGSHIP_BODY_CFG, NETWORK_CFG)
    load_regressor_from_jax(reg, params)
    reg.prepare_for_eval_()

    batches, p2p, j14 = _loader(jmodel, jmodel.faces,
                                np.random.default_rng(3))
    with open(tmp_path / "p2p.pkl", "wb") as f:
        pickle.dump(p2p, f)
    np.save(tmp_path / "j14.npy", j14)
    cfg = {"evaluation": {"body": {
        "v2v": ("procrustes", "scale", "translation"),
        "v2v_t": ("scale", "translation"),
        "mpjpe": {"alignments": ("root", "procrustes"),
                  "root_joints": ("left_hip", "right_hip")},
        "p2p_t": {"input_point_regressor_path": str(tmp_path / "p2p.pkl")},
    }}, "j14_regressor_path": str(tmp_path / "j14.npy")}

    state = SimpleNamespace(
        params=jax.tree_util.tree_map(jnp.asarray, params))
    want = jloop.make_eval_fn(jreg, {"hbw": batches}, cfg)(state)["hbw"]
    got = tloop.make_eval_fn(reg, {"hbw": batches}, cfg,
                             keypoint_names=jmodel.keypoint_names)()["hbw"]
    assert set(got) == set(want)
    for key in ("p2p_t", "v2v_procrustes", "v2v_t_scale", "mpjpe_root",
                "mpjpe14_procrustes", "mass_error", "chest_error/male/obese"):
        assert key in got and np.isfinite(got[key]), key
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-4, atol=1e-5,
                                   err_msg=key)
