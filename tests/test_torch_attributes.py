"""The attribute models of the port (``shapy_tpu_torch.models.attributes``)
against the JAX package's, on the CPU: the same numpy inputs, the JAX
weights carried over through ``io.from_jax``.

Tolerances: constants, features and the synthetic databases identical;
the polynomial expansion and forward 1e-6, its ridge coefficients 1e-9
relative (float64 on the host on both sides); every network of
``build_network`` 1e-5 (forward, one ``fit`` step, one ``fit_nn`` step);
the probabilistic heads (log-prob, the flow both ways on the same noise,
NLL, the reference-architecture twins) 1e-5; ``A2B.validate`` through
K1's plain version 1e-5 relative. Small sizes: 6-12 features, hidden
widths 8-16, 3-7 rows.
"""

import copy
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.models.attributes import a2b as ja2b
from shapy_tpu.models.attributes import b2a as jb2a
from shapy_tpu.models.attributes import ckpt_import as jckpt
from shapy_tpu.models.attributes import constants as jconst
from shapy_tpu.models.attributes import features as jfeat
from shapy_tpu.models.attributes import networks as jnet
from shapy_tpu.models.attributes import polynomial as jpoly
from shapy_tpu.models.attributes import prob as jprob
from shapy_tpu.models.attributes import regression_data as jdata
from shapy_tpu.models.attributes import utils as jutils
from shapy_tpu_torch.io.from_jax import (
    attribute_network_state_dict,
    load_attribute_network_from_jax,
    prob_head_state_dict,
)
from shapy_tpu_torch.models.attributes import a2b as ta2b
from shapy_tpu_torch.models.attributes import b2a as tb2a
from shapy_tpu_torch.models.attributes import constants as tconst
from shapy_tpu_torch.models.attributes import features as tfeat
from shapy_tpu_torch.models.attributes import networks as tnet
from shapy_tpu_torch.models.attributes import polynomial as tpoly
from shapy_tpu_torch.models.attributes import prob as tprob
from shapy_tpu_torch.models.attributes import prob_import as tprob_import
from shapy_tpu_torch.models.attributes import regression_data as tdata
from shapy_tpu_torch.models.attributes import utils as tutils

REPO = Path(__file__).resolve().parents[1]
RELU = {"type": "relu"}
BN = {"type": "bn"}
TOL = 1e-5

S2A_FEATURES = {
    "use_attributes": True, "use_measurements": False,
    "female_attributes": {"big": True, "tall": True, "petite": True,
                          "long_legs": True, "slim_waist": True},
}
A2S_FEATURES = {
    "use_attributes": True, "use_measurements": True,
    "female_attributes": {"big": True, "tall": True, "short": True},
    "measurements": {"height_gt": True, "weight_gt": True},
}

# (network cfg) for every network type of build_network
NETWORKS = {
    "mlp": {"type": "mlp", "mlp": {"layers": [16, 8], "activation": RELU}},
    "mlp_bn": {"type": "mlp", "mlp": {"layers": [16, 8], "activation": RELU,
                                      "normalization": BN}},
    "mlp_dropout": {"type": "mlp", "mlp": {"layers": [12],
                                           "activation": {"type": "elu"},
                                           "dropout": 0.3}},
    "resnet_relu": {"type": "resnet", "resnet": {"layers": [12, 8],
                                                 "activation": RELU}},
    "resnet_lrelu": {"type": "resnet", "resnet": {
        "layers": [12, 8], "activation": {"type": "leaky-relu"}}},
    "resnet_prelu": {"type": "resnet", "resnet": {
        "layers": [12, 8], "activation": {"type": "prelu"}}},
    "resnet_bn": {"type": "resnet", "resnet": {
        "layers": [12, 8], "activation": RELU, "normalization": BN}},
    "mlp_prelu": {"type": "mlp", "mlp": {"layers": [12, 8],
                                         "activation": {"type": "prelu"}}},
    "moe": {"type": "moe", "moe": {"num_experts": 3, "network": {
        "type": "mlp", "mlp": {"layers": [8], "activation": RELU}}}},
    "imoe": {"type": "imoe", "imoe": {"network": {
        "type": "mlp", "mlp": {"layers": [8], "activation": RELU}}}},
    "imoe_linear": {"type": "imoe", "imoe": {"network": {"type": "linear"}}},
    "linear": {"type": "linear"},
    "simple": {"type": "simple"},
    "iterative_gru": {"type": "iterative", "iterative": {
        "num_stages": 3, "network": {"rnn": {"type": "gru",
                                             "layer_dims": [16]}}}},
    "iterative_lstm": {"type": "iterative", "iterative": {
        "num_stages": 2, "network": {"rnn": {
            "type": "lstm", "layer_dims": [12, 8], "dropout": 0.2}}}},
    # learned initial states: one layer, as the reference's importer
    # names them (hidden_state.{n} of layer 0)
    "iterative_lstm_state": {"type": "iterative", "iterative": {
        "num_stages": 2, "append_params": False, "network": {"rnn": {
            "type": "lstm", "layer_dims": [8], "learn_state": True}}}},
}
D_IN, D_OUT = 6, 4


_JAX_NETS = {}


def _jax_net(cfg, seed=0, d_in=D_IN, d_out=D_OUT):
    """The JAX network with its random init perturbed (biases, PReLU
    slopes, learned RNN states and the param mean non-zero); a shallow
    copy of one built once per config (flax's init is the slow part), so
    that a test may replace its ``variables``."""
    key = (repr(cfg), seed, d_in, d_out)
    if key not in _JAX_NETS:
        net = jnet.build_network(cfg, d_in, d_out)
        rng = np.random.default_rng(seed)
        net.variables = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a) + rng.normal(
                size=np.shape(a)).astype(np.float32) * 0.1), net.variables)
        _JAX_NETS[key] = net
    return copy.copy(_JAX_NETS[key])


def _port_net(cfg, jax_net, d_in=D_IN, d_out=D_OUT, batch_norm=None):
    net = tnet.build_network(cfg, d_in, d_out, batch_norm=batch_norm)
    if batch_norm or (batch_norm is None and "bn" in str(cfg)):
        return net
    return load_attribute_network_from_jax(net, jax_net.variables)


def _x(n=7, d=D_IN, seed=1):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


# -- constants, utils, features, databases ----------------------------------

def test_constants_and_utils_identical():
    assert tconst.ATTRIBUTE_NAMES == jconst.ATTRIBUTE_NAMES
    assert tconst.SELF_REPORT_BIAS == jconst.SELF_REPORT_BIAS
    assert tconst.NUM_ATTRIBUTES == jconst.NUM_ATTRIBUTES
    a = tutils.sample_in_sphere(np.random.default_rng(3), 9, 10, 2.0)
    b = jutils.sample_in_sphere(np.random.default_rng(3), 9, 10, 2.0)
    np.testing.assert_array_equal(a, b)
    X, Y = _x(20, 5, 4).astype(np.float64), _x(20, 3, 5)
    for fit_intercept in (True, False):
        wt, bt = tutils.ridge_fit(X, Y, 0.5, fit_intercept)
        wj, bj = jutils.ridge_fit(X, Y, 0.5, fit_intercept)
        np.testing.assert_array_equal(wt, wj)
        np.testing.assert_array_equal(bt, bj)
        np.testing.assert_array_equal(tutils.ridge_predict(X, wt, bt),
                                      jutils.ridge_predict(X, wj, bj))


@pytest.mark.parametrize("gender", ["female", "male"])
def test_synthetic_database_identical(gender):
    t = tdata.RegressionDataset.synthetic(seed=4, n_train=30, n_eval=9,
                                          ds_gender=gender,
                                          model_gender=gender)
    j = jdata.RegressionDataset.synthetic(seed=4, n_train=30, n_eval=9,
                                          ds_gender=gender,
                                          model_gender=gender)
    assert t.db["labels"] == j.db["labels"] and t.betas_key == j.betas_key
    for split in ("train", "val", "test"):
        assert t.db[split].keys() == j.db[split].keys()
        for k, v in j.db[split].items():
            assert t.db[split][k].dtype == v.dtype
            np.testing.assert_array_equal(t.db[split][k], v)


@pytest.mark.parametrize("bodytalk", [False, True])
def test_features_identical(bodytalk):
    cfg = dict(A2S_FEATURES, measurements={"height_gt": True,
                                           "weight_gt": True,
                                           "chest": True})
    assert tfeat.select_features(cfg)[0] == jfeat.select_features(cfg)[0]
    names, idx, mmts = tfeat.select_features(cfg)
    np.testing.assert_array_equal(idx, jfeat.select_features(cfg)[1])
    db = tdata.RegressionDataset.synthetic(n_train=8, n_eval=4).db["train"]
    got = tfeat.build_feature_vector(db, idx, mmts, bodytalk)
    want = jfeat.build_feature_vector(db, idx, mmts, bodytalk)
    np.testing.assert_array_equal(got, want)
    names = names + mmts
    noise = _x(8, len(names), 6).astype(np.float64)
    np.testing.assert_array_equal(tfeat.to_whw2s(got, names),
                                  jfeat.to_whw2s(want, names))
    np.testing.assert_array_equal(tfeat.to_whw2s(got, names, noise),
                                  jfeat.to_whw2s(want, names, noise))
    # the in-forward twin: the bodytalk preprocessing, no whw2s
    cfg = dict(cfg, bodytalk_meas_preprocess=bodytalk)
    jm = ja2b.A2B(cfg)
    tm = ta2b.A2B(cfg)
    batch = {k: v for k, v in db.items()}
    want = np.asarray(jm.create_input_feature_vec_jax(
        {k: jnp.asarray(v) for k, v in batch.items()}))
    got = tm.create_input_feature_vec_tensor(
        {k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="not annotated"):
        tfeat.select_features({"female_attributes": {"masculine": True}})


# -- polynomial ---------------------------------------------------------------

@pytest.mark.parametrize("degree", [1, 2, 3])
def test_polynomial(degree, tmp_path):
    x = _x(5, 4, 2)
    jp = jpoly.Polynomial(4, 3, degree, alpha=0.1)
    tp = tpoly.Polynomial(4, 3, degree, alpha=0.1)
    assert tp.coeff_size == jp.coeff_size
    np.testing.assert_allclose(
        tp.expand(torch.from_numpy(x)).numpy(),
        np.asarray(jp.expand(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    X, Y = _x(40, 4, 3).astype(np.float64), _x(40, 3, 4).astype(np.float64)
    jp.fit(X, Y)
    tp.fit(X, Y)
    np.testing.assert_array_equal(tp.linear.weight.detach().numpy(),
                                  np.asarray(jp.params["weight"]))
    np.testing.assert_array_equal(tp.linear.bias.detach().numpy(),
                                  np.asarray(jp.params["bias"]))
    np.testing.assert_allclose(tp.predict(x), jp.predict(x), rtol=1e-6,
                               atol=1e-6)
    # the ridge coefficients in f64: the same host solve
    A = np.concatenate([np.ones((40, 1)), tp.expand_np(X)], 1)
    np.testing.assert_allclose(A, np.concatenate(
        [np.ones((40, 1)), jp.expand_np(X)], 1), rtol=1e-9)
    # both checkpoint formats
    tp.save_checkpoint(str(tmp_path / "p.npz"))
    jl = jpoly.Polynomial.load_checkpoint(str(tmp_path / "p.npz"))
    np.testing.assert_array_equal(np.asarray(jl.params["weight"]),
                                  tp.linear.weight.detach().numpy())
    torch.save({"model": tp.state_dict(),
                "hparams": {"input_dim": 4, "output_dim": 3,
                            "degree": degree, "alpha": 0.1}},
               tmp_path / "p.pt")
    for path in ("p.npz", "p.pt"):
        tl = tpoly.Polynomial.load_checkpoint(str(tmp_path / path))
        np.testing.assert_array_equal(tl.predict(x), tp.predict(x))


# -- the network zoo ------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_network_forward_and_reference_names(name):
    """Forward within 1e-5 of the JAX network on its weights; then the
    port's own state dict (``a2b.``-prefixed) through the JAX importer
    gives the port's forward (the names are the reference's)."""
    cfg = NETWORKS[name]
    x = _x()
    jn = _jax_net(cfg)
    tn = _port_net(cfg, jn)
    if "bn" in name:
        # BN kept in eval mode: non-trivial statistics, checked through
        # the JAX importer's folding below
        g = torch.Generator().manual_seed(2)
        for m in tn.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                for b in (m.running_mean, m.weight, m.bias):
                    b.data = torch.randn(b.shape, generator=g) * 0.3
                m.running_var.data = torch.rand(m.running_var.shape,
                                                generator=g) + 0.5
    else:
        np.testing.assert_allclose(tn.predict(x), jn.predict(x), rtol=TOL,
                                   atol=TOL)
    sd = {"a2b." + k: v.numpy() for k, v in tn.state_dict().items()}
    jckpt.import_network(jn, sd, "a2b.")
    np.testing.assert_allclose(np.asarray(jn.predict(x)), tn.predict(x),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["mlp", "resnet_prelu", "moe",
                                  "iterative_gru", "simple"])
def test_network_fit_step(name):
    """One Adam step on the same mini-batch from the same weights."""
    import optax

    cfg = NETWORKS[name]
    jn = _jax_net(cfg)
    tn = _port_net(cfg, jn)
    xb, yb = _x(5, D_IN, 7), _x(5, D_OUT, 8)
    tx = optax.adam(1e-3)
    params = jn.variables["params"]
    buffers = {k: v for k, v in jn.variables.items() if k != "params"}

    def loss_fn(p):
        pred = jn.module.apply({"params": p, **buffers}, jnp.asarray(xb))
        return jnp.mean((pred - jnp.asarray(yb)) ** 2)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    jn.variables = {"params": optax.apply_updates(params, updates),
                    **buffers}
    got = tn.fit_step(tn.make_optimizer(), torch.from_numpy(xb),
                      torch.from_numpy(yb))
    np.testing.assert_allclose(got.item(), float(loss), rtol=TOL)
    want = attribute_network_state_dict(tn, jn.variables)
    for k, v in tn.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=TOL,
                                   atol=TOL, err_msg=k)


def test_network_fit_runs_and_refuses_layernorm(tmp_path):
    """``fit`` reduces the error from an explicit generator and is
    repeatable; a LayerNorm block is refused with the JAX importer's
    message."""
    from shapy_tpu_torch.models.attributes.ckpt_import import (
        network_from_state_dict)

    cfg = {"type": "mlp", "mlp": {"layers": [16], "activation": RELU,
                                  "num_steps": 60, "learning_rate": 1e-2}}
    X = _x(64, D_IN, 1)
    Y = X[:, :D_OUT] * 2.0 + 0.5
    nets = []
    for _ in range(2):
        net = tnet.build_network(cfg, D_IN, D_OUT)
        before = np.mean((net.predict(X) - Y) ** 2)
        net.fit(X, Y, generator=torch.Generator().manual_seed(5))
        nets.append(net.predict(X))
    assert np.mean((nets[0] - Y) ** 2) < 0.5 * before
    np.testing.assert_array_equal(nets[0], nets[1])
    sd = {"a2b.layers.0.fc.weight": np.zeros((16, D_IN)),
          "a2b.layers.0.norm_layer.weight": np.ones(16),
          "a2b.layers.0.norm_layer.bias": np.zeros(16)}
    with pytest.raises(ValueError, match="cannot be folded"):
        network_from_state_dict(cfg, D_IN, D_OUT, sd, "a2b.")
    with pytest.raises(ValueError, match="cannot be folded"):
        jckpt.import_network(jnet.build_network(cfg, D_IN, D_OUT), sd)


def test_per_feature_prelu_loads():
    """A per-feature PReLU slope (C,) loads over the shared (1,) one and
    acts as the JAX package's ``_prelu`` with that slope."""
    cfg = NETWORKS["mlp_prelu"]
    tn = _port_net(cfg, _jax_net(cfg))
    slope = np.linspace(-0.5, 0.5, 12, dtype=np.float32)
    sd = dict(tn.state_dict(), **{"layers.0.activ.weight":
                                  torch.from_numpy(slope)})
    tn.load_state_dict(sd)
    assert tuple(tn.layers[0].activ.weight.shape) == (12,)
    h = _x(7, 12, 3) * 2.0
    got = tn.layers[0].activ(torch.from_numpy(h)).detach().numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jnet._prelu(jnp.asarray(h), jnp.asarray(slope))))


# -- B2A / A2B ------------------------------------------------------------------

def _db(gender="female", n_train=60, n_eval=12):
    return tdata.RegressionDataset.synthetic(
        seed=2, n_train=n_train, n_eval=n_eval, ds_gender=gender,
        model_gender=gender).db


@pytest.mark.parametrize("network", ["polynomial", "linear"])
def test_b2a_fit_and_checkpoint(tmp_path, network):
    """S2A: the polynomial's closed-form fit gives the JAX report; a
    reference-layout Lightning checkpoint of the port's model loads
    into both packages with the same predictions."""
    cfg = dict(S2A_FEATURES, num_shape_comps=10, model_gender="female",
               network={"type": network,
                        "polynomial": {"degree": 2, "alpha": 0.01}})
    db = _db()
    jm, tm = jb2a.B2A(cfg), tb2a.B2A(cfg)
    assert tm.output_names == jm.output_names
    if network == "polynomial":
        jr, tr = jm.fit(db), tm.fit(db)
        for split in ("val", "test"):
            for k, v in jr[split].items():
                np.testing.assert_allclose(tr[split][k], v, rtol=TOL,
                                           atol=TOL, err_msg=k)
    else:
        load_attribute_network_from_jax(tm.b2a, _jax_net(
            cfg["network"], d_in=10, d_out=5).variables)
    path = tmp_path / "b2a.ckpt"
    torch.save({"state_dict": {"b2a." + k: v
                               for k, v in tm.b2a.state_dict().items()},
                "hyper_parameters": {"cfg": cfg}}, path)
    betas = _x(4, 10, 9)
    tl = tb2a.B2A.load_from_checkpoint(str(path))
    jl = jb2a.B2A.load_from_checkpoint(str(path))
    np.testing.assert_array_equal(tl.predict(betas), tm.predict(betas))
    np.testing.assert_allclose(tl.predict(betas), jl.predict(betas),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        tl(torch.from_numpy(betas)).detach().numpy(),
        np.asarray(jl(jnp.asarray(betas))), rtol=TOL, atol=TOL)


def test_a2b_bn_checkpoint_loads(tmp_path):
    """A BN ResNet A2B checkpoint (the reference's default normalization)
    loads with BN kept in eval mode; the JAX package folds it; the same
    predictions."""
    cfg = dict(A2S_FEATURES, num_shape_comps=10,
               network={"type": "resnet", "resnet": {
                   "layers": [12, 8], "activation": RELU}})
    net = tnet.build_network(cfg["network"], 5, 10, batch_norm=True)
    g = torch.Generator().manual_seed(4)
    sd = {}
    for k, v in net.state_dict().items():
        if k.endswith("running_var"):
            v = torch.rand(v.shape, generator=g) + 0.5
        elif v.is_floating_point():
            v = torch.randn(v.shape, generator=g) * 0.3
        if k.endswith(("linear1.bias", "linear2.bias")):
            continue  # the reference drops a linear's bias before BN
        sd["a2b." + k] = v
    torch.save({"state_dict": sd, "hyper_parameters": {"cfg": cfg}},
               tmp_path / "a2b.ckpt")
    tl = ta2b.A2B.load_from_checkpoint(str(tmp_path / "a2b.ckpt"))
    jl = ja2b.A2B.load_from_checkpoint(str(tmp_path / "a2b.ckpt"))
    assert any(isinstance(m, torch.nn.BatchNorm1d) for m in tl.modules())
    feats = _x(6, 5, 3) + 3.0
    np.testing.assert_allclose(tl.predict(feats), jl.predict(feats),
                               rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def shape_body():
    from shapy_tpu.measure import BodyMeasurements as JBodyMeasurements
    from shapy_tpu.measure import MeasurementAnchors as JAnchors
    from shapy_tpu.models.body import SMPLX as JSMPLX
    from shapy_tpu_torch.measure.measurements import (
        BodyMeasurements, MeasurementAnchors)
    from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
    from shapy_tpu_torch.models.body.model import SMPLX

    data = make_synthetic_model_data("smplx", subdivisions=1, seed=0)
    jmodel, model = JSMPLX(model_data=data), SMPLX(data)
    v_t = np.asarray(jmodel.params["v_template"])
    meas = BodyMeasurements(MeasurementAnchors.synthetic(model.faces, v_t),
                            model.faces, num_hull_directions=64)
    jmeas = JBodyMeasurements(anchors=JAnchors.synthetic(jmodel.faces, v_t),
                              num_hull_directions=64)
    return jmodel, model, jmeas, meas


def test_a2b_fit_and_validate(shape_body):
    """A2S with whw2s: the polynomial fit's report (betas L1, v2v, the
    measurement MAEs through K1's plain version) within 1e-5 of the JAX
    report; ``predict_shape`` gives the body model's meshes."""
    jmodel, model, jmeas, meas = shape_body
    cfg = dict(A2S_FEATURES, num_shape_comps=10, model_gender="female",
               regression={"use_whw2s_setting": True},
               network={"type": "polynomial",
                        "polynomial": {"degree": 2, "alpha": 1.0}})
    db = _db(n_train=50, n_eval=6)
    jm = ja2b.A2B(cfg, body_model=jmodel, meas_module=jmeas)
    tm = ta2b.A2B(cfg, body_model=model, meas_module=meas)
    jr, tr = jm.fit(db), tm.fit(db)
    for split in ("val", "test"):
        assert tr[split].keys() == jr[split].keys()
        for k, v in jr[split].items():
            np.testing.assert_allclose(tr[split][k], v, rtol=TOL, atol=1e-6,
                                       err_msg=f"{split}/{k}")
    feats = tm.create_input_feature_vec(db["val"])
    betas, v = tm.predict_shape(feats)
    jbetas, jv = jm.predict_shape(feats)
    np.testing.assert_allclose(betas, np.asarray(jbetas), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=TOL)


def test_a2b_fit_loo():
    cfg = dict(A2S_FEATURES, num_shape_comps=10, model_gender="female",
               network={"type": "polynomial",
                        "polynomial": {"degree": 1, "alpha": 0.5}})
    db = _db(n_train=12, n_eval=2)["train"]
    feats = jfeat.build_feature_vector(db, *jfeat.select_features(cfg)[1:])
    betas = db["betas_smplx_female"]
    got = ta2b.A2B(cfg).fit_loo(feats, betas)
    want = ja2b.A2B(cfg).fit_loo(feats, betas)
    np.testing.assert_allclose(got["betas_l1"], want["betas_l1"], rtol=TOL)


def test_a2b_fit_nn_step(shape_body):
    """One ``fit_nn`` step (v2v, betas, edge and the four measurement
    losses) from the same weights on the same batch: the loss and the
    updated weights within 1e-5 of the JAX step's (its loss written out
    as ``A2B.fit_nn``'s closure computes it)."""
    import optax

    from shapy_tpu.core.geometry import faces_to_edges
    from shapy_tpu.losses.losses import vertex_edge_loss

    jmodel, model, jmeas, meas = shape_body
    cfg = dict(A2S_FEATURES, num_shape_comps=10, model_gender="female",
               network=NETWORKS["mlp"])
    jm = ja2b.A2B(cfg, body_model=jmodel, meas_module=jmeas)
    jm.a2b = _jax_net(cfg["network"], d_in=5, d_out=10)
    tm = ta2b.A2B(cfg, body_model=model, meas_module=meas)
    load_attribute_network_from_jax(tm.a2b, jm.a2b.variables)
    db = _db(n_train=8, n_eval=4)["train"]
    xb = jm.create_input_feature_vec(db).astype(np.float32)[:5]
    yb = db["betas_smplx_female"][:5]
    w = dict(v2v_weight=1.0, betas_weight=0.5, edge_weight=2.0,
             meas_weights={"height": 1.0, "chest": 0.5, "waist": 0.5,
                           "hips": 0.5})
    edges = faces_to_edges(jmodel.faces)

    def loss_fn(variables):
        pred_betas = jm.a2b.module.apply(variables, jnp.asarray(xb))
        po = jmodel.forward_shape(pred_betas)["v_shaped"]
        go = jmodel.forward_shape(jnp.asarray(yb))["v_shaped"]
        loss = w["v2v_weight"] * jnp.mean(jnp.linalg.norm(po - go, axis=-1))
        loss += w["betas_weight"] * jnp.mean((pred_betas - yb) ** 2)
        loss += w["edge_weight"] * vertex_edge_loss(po, go, edges)
        pm = jmeas.forward_from_vertices(po, jmodel.faces)["measurements"]
        gm = jmeas.forward_from_vertices(go, jmodel.faces)["measurements"]
        for k, wk in w["meas_weights"].items():
            loss += wk * jnp.mean(jnp.abs(pm[k]["tensor"]
                                          - gm[k]["tensor"]))
        return loss

    tx = optax.adam(1e-3)
    v = jm.a2b.variables
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(v)
    updates, _ = tx.update(grads, tx.init(v), v)
    v = optax.apply_updates(v, updates)
    opt = torch.optim.Adam(tm.a2b.parameters(), lr=1e-3)
    from shapy_tpu_torch.core.geometry import faces_to_edges as tedges

    got = tm.fit_nn_step(opt, torch.from_numpy(xb), torch.from_numpy(yb),
                         edges=tedges(model.faces), **w)
    np.testing.assert_allclose(got.item(), float(loss), rtol=TOL)
    want = attribute_network_state_dict(tm.a2b, v)
    for k, val in tm.a2b.state_dict().items():
        np.testing.assert_allclose(val.numpy(), want[k].numpy(), rtol=TOL,
                                   atol=TOL, err_msg=k)


def test_a2b_fit_nn_runs(shape_body):
    """``fit_nn`` end to end: the loss falls from an explicit generator
    and the report has the validation metrics."""
    _, model, _, meas = shape_body
    cfg = dict(A2S_FEATURES, num_shape_comps=10, model_gender="female",
               network=NETWORKS["mlp"])
    tm = ta2b.A2B(cfg, body_model=model, meas_module=meas)
    losses = []
    rep = tm.fit_nn(_db(n_train=16, n_eval=4), meas_weights={"height": 1.0},
                    num_steps=30, learning_rate=1e-2, batch_size=8,
                    on_step=lambda s, loss: losses.append(loss.item()))
    assert len(losses) == 30 and np.mean(losses[-5:]) < np.mean(losses[:5])
    assert {"betas_l1", "v2v_mm", "height_mae_mm",
            "mass_mae_kg"} <= set(rep["val"])


# -- the probabilistic heads ---------------------------------------------------

@pytest.mark.parametrize("head", ["mvn", "flow"])
def test_probabilistic_heads(head):
    """log-prob, the point estimate, the flow both ways on the same noise
    (sampling), the NLL and one NLL step, within 1e-5 of the JAX heads on
    their weights."""
    import optax

    cfg = dict(A2S_FEATURES, num_shape_comps=6,
               probabilistic={"type": head, "hidden_dims": [16],
                              "num_layers": 3, "hidden": 16})
    jm, tm = jprob.A2BProbabilistic(cfg), tprob.A2BProbabilistic(cfg)
    rng = np.random.default_rng(0)
    jm.variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + rng.normal(
            size=np.shape(a)).astype(np.float32) * 0.1), jm.variables)
    tm.module.load_state_dict(prob_head_state_dict(
        tm.module, jm.variables["params"]))
    x, y = _x(5, 5, 1), _x(5, 6, 2)
    np.testing.assert_allclose(
        tm.log_prob(y, x).detach().numpy(),
        np.asarray(jm.log_prob(jnp.asarray(y), jnp.asarray(x))),
        rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tm.predict(x), jm.predict(x), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(
        tm.neg_log_likelihood(x, y).detach().numpy(),
        np.asarray(jm.neg_log_likelihood(jnp.asarray(x), jnp.asarray(y))),
        rtol=TOL, atol=TOL)
    z = _x(5, 6, 3)
    if head == "flow":
        fwd = jm.module.apply(jm.variables, jnp.asarray(z), jnp.asarray(x),
                              method=jm.module.forward)
        inv = jm.module.apply(jm.variables, jnp.asarray(y), jnp.asarray(x),
                              method=jm.module.inverse)
        for (got, gld), (want, wld) in (
                (tm.module.to_data(torch.from_numpy(z), torch.from_numpy(x)),
                 fwd),
                (tm.module.to_base(torch.from_numpy(y), torch.from_numpy(x)),
                 inv)):
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), rtol=TOL, atol=TOL)
            np.testing.assert_allclose(gld.detach().numpy(),
                                       np.asarray(wld), rtol=TOL, atol=TOL)
    s = tm.sample(x, torch.Generator().manual_seed(0), num_samples=3)
    assert s.shape == (3, 5, 6) and torch.isfinite(s).all()
    tx = optax.adam(1e-3)
    v = jm.variables

    def nll(variables):
        if head == "mvn":
            mean, tril = jm.module.apply(variables, jnp.asarray(x))
            return -jnp.mean(jprob.mvn_log_prob(jnp.asarray(y), mean, tril))
        return -jnp.mean(jm.module.apply(variables, jnp.asarray(y),
                                         jnp.asarray(x)))

    loss, grads = jax.jit(jax.value_and_grad(nll))(v)
    updates, _ = tx.update(grads, tx.init(v), v)
    v = optax.apply_updates(v, updates)
    opt = torch.optim.Adam(tm.module.parameters(), lr=1e-3)
    got = tm.nll_step(opt, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.item(), float(loss), rtol=TOL)
    want = prob_head_state_dict(tm.module, v["params"])
    for k, val in tm.module.state_dict().items():
        np.testing.assert_allclose(val.numpy(), want[k].numpy(), rtol=TOL,
                                   atol=TOL, err_msg=k)


@pytest.mark.parametrize("kind", ["diagonal", "tril", "flow"])
def test_prob_import_heads(tmp_path, kind):
    """The reference-architecture twins: a port-written ``a2b.`` state dict
    loads into both packages' ``load_from_checkpoint``; NLL and the point
    estimate within 1e-5, samples of the interface's shape."""
    net = {"type": "mlp", "mlp": {"layers": [16], "activation": RELU}}
    if kind == "flow":
        prob = {"type": "flow", "flow": {"num_blocks": 2}}
    else:
        prob = {"type": "gaussian", "gaussian": {"covariance": kind}}
    cfg = dict(A2S_FEATURES, num_shape_comps=6, network=net,
               probabilistic=prob)
    head = tprob_import.build_distr_regressor(cfg, 5, 6)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in head.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
        if kind == "tril":  # a positive Cholesky diagonal
            head.net.output_layer.bias[6:] += 2.0
    torch.save({"state_dict": {"a2b." + k: v
                               for k, v in head.state_dict().items()},
                "hyper_parameters": {"cfg": cfg}}, tmp_path / "p.ckpt")
    tm = tprob.A2BProbabilistic.load_from_checkpoint(str(tmp_path / "p.ckpt"))
    jm = jprob.A2BProbabilistic.load_from_checkpoint(str(tmp_path / "p.ckpt"))
    x, y = _x(5, 5, 4), _x(5, 6, 5)
    np.testing.assert_allclose(
        tm.neg_log_likelihood(x, y).detach().numpy(),
        np.asarray(jm.neg_log_likelihood(x, y)), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tm.predict(x), jm.predict(x), rtol=TOL,
                               atol=TOL)
    s = tm.sample(x, torch.Generator().manual_seed(0), num_samples=3)
    assert s.shape == (3, 5, 6) and torch.isfinite(s).all()


# -- the joblib-free reader -----------------------------------------------------

READER = textwrap.dedent("""
    import pickle, sys
    sys.modules["joblib"] = None  # importing joblib raises
    from shapy_tpu_torch.io.pickles import load_pickle
    from shapy_tpu_torch.models.attributes.regression_data import (
        RegressionDataset)
    folder = sys.argv[1]
    out = {name: load_pickle(f"{folder}/{name}.pt")
           for name in ("dumped", "pickled")}
    ds = RegressionDataset(ds_name="db", ds_gender="female",
                           db_folder=folder)
    out["db"] = {s: ds.db[s] for s in ("train", "val", "test")}
    try:
        load_pickle(f"{folder}/compressed.pt")
    except ValueError as exc:
        out["compressed"] = str(exc)
    with open(f"{folder}/read.pkl", "wb") as f:
        pickle.dump(out, f)
""")


def test_joblib_free_reader(tmp_path):
    """Files that ``joblib.dump`` (uncompressed, its arrays C, Fortran,
    big-endian and object) and ``pickle.dump`` wrote read the same with
    ``joblib`` blocked; a compressed file raises naming joblib."""
    import joblib

    rng = np.random.default_rng(0)
    obj = {"rating": rng.normal(size=(7, 15)).astype(np.float32),
           "fortran": np.asfortranarray(rng.normal(size=(4, 3))),
           "big": np.arange(6, dtype=">i4").reshape(2, 3),
           "ids": np.array(["a", "b"], dtype=object),
           "names": ["x", "y"], "n": 3}
    joblib.dump(obj, tmp_path / "dumped.pt")
    with open(tmp_path / "pickled.pt", "wb") as f:
        pickle.dump(obj, f)
    joblib.dump(obj, tmp_path / "compressed.pt", compress=3)
    db = jdata.RegressionDataset.synthetic(n_train=9, n_eval=3).db
    for split in ("train", "val", "test"):
        joblib.dump(db[split], tmp_path / f"db_female_{split}.pt")
    subprocess.run([sys.executable, "-c", READER, str(tmp_path)], check=True,
                   cwd=REPO, timeout=120)
    with open(tmp_path / "read.pkl", "rb") as f:
        read = pickle.load(f)
    for name in ("dumped", "pickled"):
        got = read[name]
        assert got.keys() == obj.keys()
        for k, v in obj.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got[k], v)
                assert got[k].dtype.newbyteorder("=") == v.dtype.newbyteorder(
                    "=")
            else:
                assert got[k] == v
    for split in ("train", "val", "test"):
        for k, v in db[split].items():
            np.testing.assert_array_equal(read["db"][split][k], v)
    assert "joblib" in read["compressed"]
