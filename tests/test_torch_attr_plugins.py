"""The regressor's frozen attribute plugins (B2A: betas -> attributes,
A2B: ratings + height / weight + this forward's measured height and mass
-> ``betas_ref`` / ``v_shaped_ref``) against the JAX package's, on the
CPU, and the paths that reach them: the eval loop and the evaluation CLI
(each batch's ``gender``) and a train step with the ``attributes`` loss.

The regressor is the evaluation CLI test's tiny one (ResNet-18 head
widths, 2 stages, MLP (32,), synthetic SMPL-X at ``subdivisions`` 1, 64
hull directions), compared from the features onward as
``tests/test_torch_train.py`` compares its step; the plugins are the
polynomials of ``configs/s2a.yaml`` and
``configs/a2s_variations/02b_ahw2s.yaml`` fitted on the synthetic
database for each gender, written as reference Lightning checkpoints and
loaded by both packages.

Tolerances, the heads': attributes and ``betas_ref`` rel 1e-4 (atol
1e-5), ``v_shaped_ref`` atol 1e-5 m; the train step's losses rel 1e-5 and
its gradients within 1e-5 of each tensor's largest.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.measure import BodyMeasurements as JBodyMeasurements
from shapy_tpu.measure import MeasurementAnchors as JAnchors
from shapy_tpu.models.attributes.a2b import A2B as JA2B
from shapy_tpu.models.attributes.b2a import B2A as JB2A
from shapy_tpu.models.body import SMPLX as JSMPLX
from shapy_tpu.models.heads import build_body_head as jbuild_body_head
from shapy_tpu.train import RegressorLosses as JRegressorLosses
from shapy_tpu.train.step import forward_with_stats
from shapy_tpu_torch.cli.demo import load_attribute_plugins
from shapy_tpu_torch.eval.loop import make_eval_fn
from shapy_tpu_torch.flagship import (
    FLAGSHIP_OPTIM_CFG,
    FLAGSHIP_TRAIN_LOSS_CFG,
    synthetic_train_batches,
)
from shapy_tpu_torch.io.from_jax import (
    load_regressor_from_jax,
    state_dict_from_jax,
)
from shapy_tpu_torch.measure.measurements import (
    BodyMeasurements,
    MeasurementAnchors,
)
from shapy_tpu_torch.models.attributes.build import build
from shapy_tpu_torch.models.attributes.regression_data import (
    RegressionDataset,
)
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
from shapy_tpu_torch.models.body.model import SMPLX
from shapy_tpu_torch.models.heads.regressor import build_body_head
from shapy_tpu_torch.train.losses import RegressorLosses
from shapy_tpu_torch.train.step import init_train_state, make_train_step
from shapy_tpu_torch.utils.config import load_config
from tests.test_torch_regressor import _perturbed_params

torch.set_num_threads(2)
REPO = __import__("pathlib").Path(__file__).resolve().parents[1]
NETWORK = {"num_stages": 2, "predict_hands": False, "predict_face": False,
           "backbone": {"type": "resnet", "depth": 18},
           "mlp": {"layers": [32], "dropout": 0.0}}
FEAT_DIM = 512
PLUGIN_CONFIGS = {"b2a": "configs/s2a.yaml",
                  "a2b": "configs/a2s_variations/02b_ahw2s.yaml"}
LOSS_CFG = copy.deepcopy(FLAGSHIP_TRAIN_LOSS_CFG)
LOSS_CFG["body"]["attributes"] = {"weight": 10.0}


def write_plugin_checkpoints(root, n_train=80):
    """Both plugins for both genders, fitted on the synthetic database and
    written as reference Lightning checkpoints; returns the network
    section's keys that name them."""
    keys = {}
    for kind, path in PLUGIN_CONFIGS.items():
        keys[f"use_{kind}"] = True
        for gender in ("male", "female"):
            cfg = load_config({}, [str(REPO / path)], [
                f"ds_gender={gender}", f"model_gender={gender}"])
            model = build(cfg)
            model.fit(RegressionDataset.synthetic(
                n_train=n_train, n_eval=8, ds_gender=gender,
                model_gender=gender).db)
            ckpt = root / f"{kind}_{gender}.ckpt"
            torch.save({"state_dict": model.state_dict(),
                        "hyper_parameters": {"cfg": cfg}}, ckpt)
            keys[f"{kind}_{gender}s_checkpoint"] = str(ckpt)
    return keys


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("plugins")
    keys = write_plugin_checkpoints(root)
    data = make_synthetic_model_data("smplx", subdivisions=1, seed=0)
    jmodel, body = JSMPLX(model_data=data), SMPLX(data)
    v_t = body.v_template.numpy()
    cfg = {"network": {"type": "SMPLXRegressor",
                       "smplx": dict(NETWORK, **keys)},
           "body_model": {"type": "smplx", "model_folder": "",
                          "smplx": {"betas": {"num": 10}}}}
    jplugins = [{g: cls.load_from_checkpoint(keys[f"{k}_{g}s_checkpoint"])
                 for g in ("male", "female")}
                for k, cls in (("b2a", JB2A), ("a2b", JA2B))]
    jreg = jbuild_body_head(
        cfg, body_model=jmodel,
        measurements=JBodyMeasurements(
            anchors=JAnchors.synthetic(jmodel.faces, v_t),
            num_hull_directions=64),
        b2a_models=jplugins[0], a2b_models=jplugins[1])
    params = _perturbed_params(jreg.params, jreg.param_slices, seed=8)
    b2a, a2b = load_attribute_plugins(cfg["network"]["smplx"])
    assert set(b2a) == set(a2b) == {"male", "female"}
    reg = build_body_head(
        cfg, body_model=body,
        measurements=BodyMeasurements(
            MeasurementAnchors.synthetic(body.faces, v_t), body.faces,
            num_hull_directions=64),
        b2a_models=b2a, a2b_models=a2b)
    load_regressor_from_jax(reg, params)
    jreg.compute_features = lambda p, images, *args, **kw: images
    reg.compute_features = lambda images: images
    feats = np.random.default_rng(4).uniform(
        0, 1, size=(3, FEAT_DIM)).astype(np.float32)
    return {"jreg": jreg, "reg": reg, "params": params, "cfg": cfg,
            "feats": feats, "jmodel": jmodel, "keys": keys}


BATCHES = {
    "given": {"gender": np.array([1, 2, 0], np.int32),
              "attributes": np.random.default_rng(1).uniform(
                  1, 5, (3, 15)).astype(np.float32),
              "height": np.array([1.8, 1.6, 1.7], np.float32),
              "weight": np.array([80.0, 55.0, 70.0], np.float32)},
    "defaults": {"gender": np.array([2, 1, 1], np.int32)},
}


@pytest.mark.parametrize("which", sorted(BATCHES))
def test_plugins_match_jax(pair, which):
    """Eval-mode forward with the batch's gender (and ratings, height,
    weight, or their defaults): the plugins' outputs as the JAX
    regressor's; a row of another gender gets zeros; without ``gender``
    no plugin runs."""
    jreg, reg = pair["jreg"], pair["reg"].eval()
    batch = BATCHES[which]
    want = jax.jit(lambda p, f, b: jreg.apply(p, f, batch=b))(
        jax.tree_util.tree_map(jnp.asarray, pair["params"]),
        jnp.asarray(pair["feats"]),
        {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = reg.apply(torch.from_numpy(pair["feats"]),
                        batch={k: torch.from_numpy(v)
                               for k, v in batch.items()})
        plain = reg.apply(torch.from_numpy(pair["feats"]))
    last = "stage_01"
    np.testing.assert_allclose(got["attributes"].numpy(),
                               np.asarray(want["attributes"]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got[last]["betas_ref"].numpy(),
                               np.asarray(want[last]["betas_ref"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[last]["v_shaped_ref"].numpy(),
                               np.asarray(want[last]["v_shaped_ref"]),
                               atol=1e-5)
    other = batch["gender"] == 0
    assert (got["attributes"][other] == 0).all()
    assert got["attributes"].abs()[~other].min() > 0
    assert "attributes" not in plain and "betas_ref" not in plain[last]
    assert torch.equal(plain[last]["vertices"], got[last]["vertices"])


def test_plugins_are_frozen_and_move_with_the_regressor(pair):
    """Not in the state dict or the parameters, eval mode after
    ``train()``, moved by ``.to``."""
    reg = copy.deepcopy(pair["reg"])
    assert not any(k.startswith(("b2a", "a2b")) for k in reg.state_dict())
    plugin_params = [p for m in reg._plugins() for p in m.parameters()]
    assert plugin_params and not any(p.requires_grad for p in plugin_params)
    ids = {id(p) for p in reg.parameters()}
    assert not any(id(p) in ids for p in plugin_params)
    reg.train()
    assert not any(m.training for m in reg._plugins())
    reg.to(torch.float64)
    assert all(p.dtype == torch.float64 for p in plugin_params)


def test_train_step_with_attributes_loss(pair):
    """One train step from the features onward with the ``attributes``
    loss (weight 10, ``configs/train_shapy.yaml``'s) and the batch's
    gender: every loss term and the gradients to the head and the
    features as the JAX step's; the B2A weights take no optimizer state
    and stay bit-unchanged."""
    jreg, params = pair["jreg"], pair["params"]
    reg = copy.deepcopy(pair["reg"])
    reg.compute_features = lambda images: images
    reg.prepare_for_train_()
    batch = synthetic_train_batches(reg, 1, 3, 64, seed=3)[0]
    batch.pop("images")
    batch["gender"] = torch.tensor([1, 2, 1], dtype=torch.int32)
    batch["attributes"] = torch.from_numpy(BATCHES["given"]["attributes"])
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jparams = jax.tree_util.tree_map(jnp.asarray, dict(params, backbone={}))
    jlosses = JRegressorLosses(LOSS_CFG)

    def compute(p, f):
        out, _ = forward_with_stats(jreg, p, f, jbatch,
                                    jax.random.PRNGKey(0),
                                    model_params=pair["jmodel"].params)
        loss = jlosses(out, jbatch)
        return loss["total"], loss

    feats = pair["feats"]
    (jgrads, jdfeats), jloss = jax.jit(jax.grad(
        compute, argnums=(0, 1), has_aux=True))(jparams, jnp.asarray(feats))
    before = {id(m): {k: v.clone() for k, v in m.state_dict().items()}
              for m in reg._plugins()}
    state = init_train_state(reg, FLAGSHIP_OPTIM_CFG)
    step = make_train_step(reg, RegressorLosses(LOSS_CFG), state)
    tfeats = torch.from_numpy(feats).requires_grad_()
    loss = step.forward(tfeats, batch)
    step.backward(loss)
    assert set(loss) == set(jloss) and "attributes" in loss
    assert float(loss["attributes"].detach()) > 0
    for k, v in jloss.items():
        np.testing.assert_allclose(float(loss[k].detach()), float(v),
                                   rtol=1e-5, err_msg=k)
    want = state_dict_from_jax({"head": jgrads["head"]})
    pairs = [(k, dict(reg.named_parameters())[k].grad, w)
             for k, w in want.items()]
    pairs.append(("features", tfeats.grad,
                  torch.from_numpy(np.array(jdfeats))))
    for name, got, w in pairs:
        scale = float(w.abs().max())
        torch.testing.assert_close(got, w, rtol=0, atol=1e-5 * scale,
                                   msg=name)
    step.update()
    owned = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    for m in reg._plugins():
        assert not any(id(p) in owned for p in m.parameters())
        for k, v in m.state_dict().items():
            assert torch.equal(v, before[id(m)][k]), k


class _Loader:
    """Two collate-like batches whose ``images`` are the features."""

    def __init__(self, feats, body):
        g = np.random.default_rng(5)
        self.batches = []
        for gender in ([1, 2, 0], [2, 2, 1]):
            betas = torch.from_numpy(g.normal(size=(3, 10)).astype(
                np.float32))
            with torch.no_grad():
                v = body.forward_shape(betas)["v_shaped"]
            self.batches.append({
                "images": torch.from_numpy(feats),
                "gender": np.array(gender, np.int32),
                "genders": [("neutral", "male", "female")[i]
                            for i in gender],
                "gt_v_shaped": v.numpy()})

    def __iter__(self):
        return iter(self.batches)


def _recording(reg, seen):
    apply = reg.apply

    def recorded(images, batch=None, **kw):
        out = apply(images, batch=batch, **kw)
        seen.append((batch, out))
        return out
    reg.apply = recorded
    return reg


def test_eval_loop_passes_gender(pair):
    """``make_eval_fn``'s model function gives the regressor each batch's
    gender: the plugins run, and the metrics are bit-equal to a run
    without them (they change no stage output the evaluator reads)."""
    reg = pair["reg"]
    loaders = {"shape": _Loader(pair["feats"], reg.model)}
    cfg = {"evaluation": {"body": {"v2v_t": ["scale", "translation"]}}}
    results = []
    for plugins in (True, False):
        r = copy.deepcopy(reg)
        r.compute_features = lambda images: images
        if not plugins:
            r.b2a_models, r.a2b_models = {}, {}
        seen = []
        _recording(r, seen)
        results.append(make_eval_fn(r, loaders, cfg)(0))
        assert len(seen) == 2
        for (batch, out), want in zip(seen, loaders["shape"].batches):
            np.testing.assert_array_equal(batch["gender"].numpy(),
                                          want["gender"])
            assert ("attributes" in out) == plugins
            assert ("betas_ref" in out["stage_01"]) == plugins
    assert results[0] == results[1] and results[0]["shape"]


def test_evaluate_cli_runs_the_plugins(pair, tmp_path, monkeypatch, capsys):
    """``cli.evaluate.main`` on a synthetic HBW folder with the plugin
    checkpoints in its config: the regressor is built with them, each
    batch's gender reaches them, and the printed metrics equal a run
    without them."""
    import shapy_tpu_torch.cli.demo as demo_mod
    from shapy_tpu_torch.cli import evaluate
    from shapy_tpu_torch.data import build as data_build
    from shapy_tpu_torch.data.datasets.hbw import HBWDataset
    from tests.test_torch_datasets import write_hbw_tree

    reg = pair["reg"]
    root = str(tmp_path / "hbw")
    write_hbw_tree(root, reg.model, np.random.default_rng(11), subjects=2,
                   images=2)
    meas = reg.body_measurements

    class HBW(HBWDataset):
        def __init__(self, **kwargs):
            super().__init__(measurements_module=meas,
                             body_model_faces=reg.model.faces, **kwargs)

    if not data_build.DATASET_REGISTRY:
        data_build._populate_registry()
    monkeypatch.setitem(data_build.DATASET_REGISTRY, "hbw", HBW)
    real = demo_mod.build_demo_regressor
    built, lines = [], []
    for plugins in (True, False):
        net = dict(pair["cfg"]["network"]["smplx"], use_b2a=plugins,
                   use_a2b=plugins)
        cfg = {"network": {"type": "SMPLXRegressor", "smplx": net},
               "body_model": pair["cfg"]["body_model"],
               "datasets": {"batch_size": 2, "pose_shape_ratio": 0.0,
                            "shape": {"splits": {"val": ["hbw"]},
                                      "transforms": {"crop_size": 64},
                                      "hbw": {"data_folder": root}}},
               "evaluation": {"body": {"v2v_t": ["scale", "translation"]}}}

        def builder(exp_cfg, checkpoint_path="", device="cuda"):
            b2a, a2b = load_attribute_plugins(exp_cfg["network"]["smplx"])
            r = build_body_head(exp_cfg, body_model=reg.model,
                                measurements=meas, b2a_models=b2a,
                                a2b_models=a2b)
            load_regressor_from_jax(r, pair["params"])
            seen = []
            built.append(seen)
            return _recording(r, seen)

        monkeypatch.setattr(demo_mod, "build_demo_regressor", builder)
        capsys.readouterr()
        assert evaluate.main(cfg, output_folder=str(tmp_path / "out"),
                             device="cpu") == 0
        lines.append(capsys.readouterr().out.splitlines())
    monkeypatch.setattr(demo_mod, "build_demo_regressor", real)
    assert lines[0] == lines[1] and len(lines[0]) > 3
    with_plugins, without = built
    assert len(with_plugins) == 2
    for batch, out in with_plugins:
        assert set(batch["gender"].tolist()) <= {1, 2}
        assert "attributes" in out and "betas_ref" in out["stage_01"]
    assert all("attributes" not in out for _, out in without)
