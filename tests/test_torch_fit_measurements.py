"""The port's fit of shape to measurements, its two CLIs, the anchor YAMLs,
the model-file loader and a train step with measurement losses, against
the JAX package on the CPU (the kernels' plain versions).

Seeded numpy inputs go to both sides; each test states its tolerance.
Sizes are small: synthetic SMPL-X at ``subdivisions=2`` (the CLIs' fits
at 4, as the example builds them), K=64 hull directions for the fits.
"""

import io
import os
import pickle
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch
import yaml

from shapy_tpu.measure import BodyMeasurements as JBodyMeasurements
from shapy_tpu.measure import MeasurementAnchors as JAnchors
from shapy_tpu.measure.fit_measurements import (
    fit_betas_to_measurements as jfit,
)
from shapy_tpu.models.body import SMPLX as JSMPLX
from shapy_tpu.models.body.assets import load_model_data as jload_model_data
from shapy_tpu.models.body.assets import save_model_data as jsave_model_data
from shapy_tpu.models.heads import SMPLXRegressor as JRegressor
from shapy_tpu.render.ply import load_ply
from shapy_tpu.train import RegressorLosses as JRegressorLosses
from shapy_tpu.train.step import forward_with_stats
from shapy_tpu_torch.cli import fit_measurements as fit_cli
from shapy_tpu_torch.cli import virtual_measurements as vm_cli
from shapy_tpu_torch.flagship import (
    FLAGSHIP_BODY_CFG,
    FLAGSHIP_TRAIN_LOSS_CFG,
    synthetic_train_batches,
)
from shapy_tpu_torch.io.from_jax import (
    load_regressor_from_jax,
    state_dict_from_jax,
)
from shapy_tpu_torch.measure.fit_measurements import (
    fit_betas_to_measurements,
)
from shapy_tpu_torch.measure.measurements import (
    DEFAULT_DEFINITIONS,
    DEFAULT_VERTICES,
    BodyMeasurements,
    MeasurementAnchors,
    candidate_faces,
)
from shapy_tpu_torch.models.body.assets import (
    load_model_data,
    make_synthetic_model_data,
)
from shapy_tpu_torch.models.body.model import SMPL, SMPLX, build_body_model
from shapy_tpu_torch.models.heads.regressor import SMPLXRegressor
from shapy_tpu_torch.train.losses import RegressorLosses
from shapy_tpu_torch.utils import yaml_subset
from tests.test_torch_regressor import _perturbed_params
from tests.test_torch_train import NETWORK_CFG

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FITTED = ("height", "chest", "waist", "hips")


@pytest.fixture(scope="module")
def body():
    data = make_synthetic_model_data("smplx", subdivisions=2, seed=0)
    jmodel = JSMPLX(model_data=data)
    model = SMPLX(data)
    v_t = np.asarray(jmodel.params["v_template"])
    anchors = MeasurementAnchors.synthetic(model.faces, v_t)
    janchors = JAnchors.synthetic(jmodel.faces, v_t)
    return data, jmodel, model, anchors, janchors


def _targets(model, meas, value):
    betas = torch.full((1, 10), value)
    v = model.forward_shape(betas)["v_shaped"]
    m = meas.forward_from_vertices(v, use_face_subsets=False)
    return {k: float(m["measurements"][k]["tensor"][0]) for k in FITTED}


# -- the fit ---------------------------------------------------------------

def test_fit_matches_jax(body):
    """20 Adam steps at lr 0.05 from seeded betas (batch 2), both slice
    modes: the JAX package fits through the AoS ``forward``, the port
    through ``forward_from_vertices``. Losses rel 1e-4 and betas atol 1e-4
    (f32 on both sides; the gradients agree to ~1e-7 of their largest, and
    20 Adam steps of ~lr each carry that)."""
    _, jmodel, model, anchors, janchors = body
    init = np.random.default_rng(3).normal(size=(2, 10)).astype(
        np.float32) * 0.5
    for mode in ("reference", "exact"):
        meas = BodyMeasurements(anchors, model.faces, 64, slice_mode=mode)
        jm = JBodyMeasurements(anchors=janchors, num_hull_directions=64,
                               slice_mode=mode)
        targets = _targets(model, meas, 0.6)
        kwargs = dict(num_steps=20, learning_rate=0.05, batch_size=2)
        got = fit_betas_to_measurements(model, meas, targets,
                                        init_betas=torch.from_numpy(init),
                                        **kwargs)
        want = jfit(jmodel, jm, targets, init_betas=jnp.asarray(init),
                    **kwargs)
        assert got["losses"].shape == (20,)
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4,
                                   err_msg=mode)
        np.testing.assert_allclose(got["betas"].numpy(),
                                   np.asarray(want["betas"]), atol=1e-4,
                                   err_msg=mode)
        for k in FITTED + ("mass",):
            np.testing.assert_allclose(
                got["measurements"][k].numpy(),
                np.asarray(want["measurements"][k]), rtol=1e-4,
                err_msg=f"{mode} {k}")


def test_fit_converges(body):
    """The JAX package's convergence check (tests/test_components.py):
    the measurements of betas = 0.8 recovered within 1 cm in 150 steps."""
    _, _, model, anchors, _ = body
    meas = BodyMeasurements(anchors, model.faces, 64)
    target = _targets(model, meas, 0.8)
    result = fit_betas_to_measurements(model, meas, target, num_steps=150,
                                       learning_rate=0.1,
                                       shape_prior_weight=1e-5)
    for k, tgt in target.items():
        assert float(result["measurements"][k][0]) == pytest.approx(
            tgt, abs=0.01), k
    assert result["losses"][-1] < result["losses"][0]


# -- anchors and model files ----------------------------------------------

def test_yaml_subset_reads_the_anchor_files_as_pyyaml():
    paths = [DEFAULT_DEFINITIONS, *DEFAULT_VERTICES.values()]
    for path in paths:
        with open(path) as f:
            assert yaml_subset.load(path) == yaml.safe_load(f), path
    with pytest.raises(ValueError):
        yaml_subset.loads("a: {b: 1}\n")


@pytest.mark.parametrize("model_type", ["smplx", "smpl"])
def test_anchors_from_yaml_match_jax(model_type):
    got = MeasurementAnchors.from_yaml(model_type=model_type)
    want = JAnchors.from_yaml(model_type=model_type)
    for name in ("head_top", "left_heel", "chest", "waist", "hips"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g.face_idx, g.bary) == (w.face_idx, w.bary), name
    faces = np.zeros((21000, 3), np.int64)
    faces[:, 1:] = [1, 2]
    meas = BodyMeasurements(None, faces, model_type=model_type)
    assert meas.anchors == got


def test_load_model_data_matches_jax(tmp_path):
    """An npz written by the JAX package's ``save_model_data`` and a
    latin1 pickle with a scipy sparse regressor: the same arrays as the
    JAX loader gives; the ``model_folder`` route builds the same model."""
    data = make_synthetic_model_data("smplx", subdivisions=1, seed=2)
    jsave_model_data(data, str(tmp_path / "SMPLX_NEUTRAL.npz"))
    pkl = dict(data, J_regressor=scipy.sparse.csc_matrix(
        data["J_regressor"] * (data["J_regressor"] > 0.05)))
    with open(tmp_path / "SMPLX_FEMALE.pkl", "wb") as f:
        pickle.dump(pkl, f, protocol=2)
    for gender, ext in (("neutral", "npz"), ("female", "pkl")):
        got = load_model_data(str(tmp_path), "smplx", gender, ext)
        want = jload_model_data(str(tmp_path), "smplx", gender, ext)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    model = build_body_model("smplx", model_folder=str(tmp_path),
                             gender="female", ext="pkl")
    ref = SMPLX(load_model_data(str(tmp_path), gender="female", ext="pkl"))
    assert model.gender == "female"
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              ref.state_dict().items()):
        assert torch.equal(a, b), k
    smpl = build_body_model("smpl", model_data=make_synthetic_model_data(
        "smpl", subdivisions=1))
    assert type(smpl) is SMPL and smpl.num_betas == 10


# -- the CLIs ----------------------------------------------------------------

def _capture(fn, *args, **kwargs):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = fn(*args, **kwargs)
    return rc, buf.getvalue().splitlines()


def test_virtual_measurements_cli_matches_jax(tmp_path, monkeypatch):
    """Three seeded betas files through both CLIs (synthetic SMPL-X at
    subdivisions 2): the same output lines, which print 2 decimals."""
    from shapy_tpu.cli import virtual_measurements as jvm_cli

    monkeypatch.setenv("SHAPY_TPU_SYNTHETIC_BODY", "1")
    monkeypatch.setenv("SHAPY_TPU_TEST_SUBDIV", "2")
    rng = np.random.default_rng(4)
    for i in range(3):
        np.savez(tmp_path / f"body_{i}.npz",
                 betas=rng.normal(size=10).astype(np.float32))
    out = str(tmp_path / "out")
    rc, got = _capture(vm_cli.main, str(tmp_path), out, render=False,
                       device="cpu")
    _, want = _capture(jvm_cli.main, str(tmp_path), out, render=False)
    assert rc == 0 and len(got) == 6
    assert got == want
    with pytest.raises(NotImplementedError, match="renderer"):
        vm_cli.main(str(tmp_path), out, device="cpu")


def test_fit_measurements_cli_matches_jax(tmp_path, monkeypatch):
    """5 steps of both fit CLIs on the synthetic SMPL-X of the example
    (subdivisions 4, K=256): the targets line is the same, the fitted
    values within 1e-4 m (their 4 decimals may round apart), the betas
    within 1e-3 (3 decimals); the PLY holds the fitted mesh (read back
    by the JAX package's reader)."""
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import fit_measurements as jfit_cli
    finally:
        sys.path.pop(0)
    monkeypatch.setenv("SHAPY_TPU_SYNTHETIC_BODY", "1")
    argv = ["--height", "1.8", "--chest", "1.0", "--num-steps", "5"]
    ply = str(tmp_path / "fit.ply")
    rc, got = _capture(fit_cli.main, argv + ["--device", "cpu",
                                             "--output-ply", ply])
    monkeypatch.setattr(sys, "argv", ["fit_measurements.py"] + argv)
    _, want = _capture(jfit_cli.main)
    assert rc == 0 and len(got) == 4 and len(want) == 3
    assert got[0] == want[0]
    for g, w, tol in ((got[1], want[1], 1e-4), (got[2], want[2], 1e-3)):
        lhs, rhs = g.split(None, 1), w.split(None, 1)
        assert lhs[0] == rhs[0]
        gv, wv = eval(lhs[1]), eval(rhs[1])  # noqa: S307 (dict / list)
        gv = list(gv.values()) if isinstance(gv, dict) else gv
        wv = list(wv.values()) if isinstance(wv, dict) else wv
        np.testing.assert_allclose(gv, wv, atol=tol + 1e-9)
    assert got[3] == f"wrote {ply}"
    verts, faces = load_ply(ply)
    assert verts.shape == (2562, 3) and faces.shape == (5120, 3)
    assert fit_cli.main(["--height", "-1", "--device", "cpu"]) == 1


# -- a train step with measurement losses ----------------------------------

def test_train_step_with_measurement_losses_matches_jax():
    """The flagship's loss and its gradients from the features onward
    (as tests/test_torch_train.py compares them) with the height, chest,
    waist and hips weights at 1.0 and GT measurements in the batch: the
    measurements on all faces are differentiated on both sides. Losses
    rel 1e-5; gradients within 1e-5 of each tensor's largest."""
    data = make_synthetic_model_data("smplx", subdivisions=1, seed=0)
    jmodel = JSMPLX(model_data=data)
    v_t = np.asarray(jmodel.params["v_template"])
    janchors = JAnchors.synthetic(jmodel.faces, v_t)
    anchors = MeasurementAnchors.synthetic(jmodel.faces, v_t)
    subsets = candidate_faces(v_t, np.asarray(jmodel.params["shapedirs"]),
                              jmodel.faces, anchors)
    jreg = JRegressor(
        body_model_cfg=FLAGSHIP_BODY_CFG, network_cfg=NETWORK_CFG,
        body_model=jmodel,
        measurements=JBodyMeasurements(anchors=janchors,
                                       num_hull_directions=256,
                                       face_subsets=subsets))
    params = _perturbed_params(jreg.params, jreg.param_slices, seed=2)
    model = SMPLX(data)
    reg = SMPLXRegressor(model, BodyMeasurements(anchors, model.faces, 256,
                                                 face_subsets=subsets),
                         FLAGSHIP_BODY_CFG, NETWORK_CFG)
    load_regressor_from_jax(reg, params)
    reg.prepare_for_train_()
    batch = synthetic_train_batches(reg, 1, 2, 64, seed=3)[0]
    batch.pop("images")
    with torch.no_grad():  # GT measurements of the GT bodies, all faces
        gt = reg.body_measurements.forward_from_vertices(
            model.forward_shape(batch["gt_betas"])["v_shaped"],
            use_face_subsets=False)["measurements"]
    for k in FITTED:
        batch[k] = gt[k]["tensor"] * 1.05
    cfg = {"body": dict(FLAGSHIP_TRAIN_LOSS_CFG["body"],
                        **{k: {"weight": 1.0} for k in FITTED})}
    feats = np.random.default_rng(8).uniform(0, 1, size=(2, 2048)).astype(
        np.float32)

    jreg.compute_features = lambda p, images, *args: images
    jparams = jax.tree_util.tree_map(jnp.asarray,
                                     dict(params, backbone={}))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jlosses = JRegressorLosses(cfg)

    def compute(p, f):
        out, _ = forward_with_stats(jreg, p, f, jbatch, jax.random.PRNGKey(0),
                                    model_params=jmodel.params)
        loss = jlosses(out, jbatch)
        return loss["total"], loss

    (jgrads, jdfeats), jloss = jax.jit(jax.grad(
        compute, argnums=(0, 1), has_aux=True))(jparams, jnp.asarray(feats))

    reg.compute_features = lambda images: images
    tfeats = torch.from_numpy(feats).requires_grad_()
    out = reg.apply(tfeats, batch, train=True,
                    generator=torch.Generator().manual_seed(0))
    loss = RegressorLosses(cfg)(out, batch)
    loss["total"].backward()
    assert set(FITTED) <= set(loss) and set(loss) == set(jloss)
    for k, v in jloss.items():
        np.testing.assert_allclose(float(loss[k].detach()), float(v),
                                   rtol=1e-5, err_msg=k)
    want = state_dict_from_jax({"head": jgrads["head"]})
    grads = {k: p.grad for k, p in reg.named_parameters()
             if p.grad is not None}
    assert set(grads) == set(want)
    pairs = [(k, grads[k], w) for k, w in want.items()]
    pairs.append(("features", tfeats.grad,
                  torch.from_numpy(np.array(jdfeats))))
    for name, got, w in pairs:
        scale = float(w.abs().max())
        assert scale > 0, name
        torch.testing.assert_close(got, w, rtol=0, atol=1e-5 * scale,
                                   msg=name)
