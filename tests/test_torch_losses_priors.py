"""The port's losses (``losses/losses.py``) and priors
(``losses/priors.py``) against the JAX package's on the same seeded
inputs, each loss and prior as its own case and through the factories
``build_loss`` / ``build_prior`` by every name they take. f32 on both
sides: values rel 1e-5 (atol 1e-6), and each prior's gradient within
1e-5 of its largest element."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.losses import losses as jlosses
from shapy_tpu.losses import priors as jpriors
from shapy_tpu_torch.losses import losses, priors

G = np.random.default_rng(0)
PRED = G.normal(size=(3, 12, 3)).astype(np.float32)
GT = G.normal(size=(3, 12, 3)).astype(np.float32)
CONF = G.uniform(0, 1, size=(3, 12)).astype(np.float32)
CONF[0, 3] = 0.0
EDGES = np.array([[0, 1], [1, 2], [2, 5], [5, 11], [3, 7]])
LOGITS = G.normal(size=(5, 4)).astype(np.float32)
PROBS = G.uniform(0, 1, size=(5, 4)).astype(np.float32)
LABELS = np.array([0, 3, -100, 2, 1])


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


LOSS_CASES = {
    "keypoint_edge_l1": ("keypoint_edge_loss", (PRED, GT, EDGES, CONF),
                         {"norm_type": "l1"}),
    "keypoint_edge_l2_noconf": ("keypoint_edge_loss", (PRED, GT, EDGES),
                                {"norm_type": "l2"}),
    "vertex_edge_l2": ("vertex_edge_loss", (PRED, GT, EDGES), {}),
    "vertex_edge_l1": ("vertex_edge_loss", (PRED, GT, EDGES),
                       {"norm_type": "l1"}),
    "bce": ("bce_loss", (LOGITS, PROBS), {}),
    "bce_logits": ("bce_logits_loss", (LOGITS, PROBS), {}),
    "mse": ("mse_loss", (PRED, GT), {}),
    "l1": ("l1_loss", (PRED, GT), {}),
    "cross_entropy": ("cross_entropy_loss", (LOGITS, LABELS), {}),
    "cross_entropy_all_ignored": ("cross_entropy_loss",
                                  (LOGITS, np.full(5, -100)), {}),
}


def _port_args(args):
    return [a if a is EDGES else torch.from_numpy(np.array(a))
            for a in args]


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_matches_jax(case):
    name, args, kw = LOSS_CASES[case]
    want = getattr(jlosses, name)(*[a if a is EDGES else jnp.asarray(a)
                                    for a in args], **kw)
    _close(getattr(losses, name)(*_port_args(args), **kw), want)


BUILD_CASES = {
    "keypoints": ((PRED, GT, CONF), {"norm_type": "l2", "weight": 2.0}),
    "gmof": ((PRED, GT, CONF), {"rho": 0.5}),
    "l2": ((PRED, GT), {}),
    "weighted-l1": ((PRED, GT, CONF), {"type": "weighted-l1"}),
    "keypoint-edge": ((PRED, GT, EDGES), {"norm_type": "l2"}),
    "vertex-edge": ((PRED, GT, EDGES), {"norm_type": "l1"}),
    "rotation": ((np.linalg.qr(G.normal(size=(2, 4, 3, 3)))[0].astype(
        np.float32), np.linalg.qr(G.normal(size=(2, 4, 3, 3)))[0].astype(
        np.float32)), {}),
    "bce": ((LOGITS, PROBS), {}),
    "bce-logits": ((LOGITS, PROBS), {}),
    "cross-entropy": ((LOGITS, np.array([0, 3, 1, 2, 3])),
                      {"ignore_index": 3}),
    "l1": ((PRED, GT), {}),
    "mse": ((PRED, GT), {}),
}


@pytest.mark.parametrize("loss_type", list(BUILD_CASES))
def test_build_loss_matches_jax(loss_type):
    """Every factory name, with config keys bound (and the ones the loss
    does not take dropped)."""
    assert set(BUILD_CASES) == set(jlosses.LOSS_FACTORY) == set(
        losses.LOSS_FACTORY)
    args, kw = BUILD_CASES[loss_type]
    want = jlosses.build_loss(loss_type, **kw)(
        *[a if a is EDGES else jnp.asarray(a) for a in args])
    _close(losses.build_loss(loss_type, **kw)(*_port_args(args)), want)


def test_build_loss_refuses_unknown_names():
    with pytest.raises(ValueError):
        losses.build_loss("nope")


X = (G.normal(size=(4, 9)) * 0.6).astype(np.float32)


@pytest.fixture(scope="module")
def gmm_path(tmp_path_factory):
    """A 3-component GMM over 6 dims, pickled as a dict."""
    g = np.random.default_rng(1)
    a = g.normal(size=(3, 6, 6))
    gmm = {"means": g.normal(size=(3, 6)) * 0.3,
           "covars": a @ a.transpose(0, 2, 1) + np.eye(6),
           "weights": np.array([0.5, 0.3, 0.2])}
    path = tmp_path_factory.mktemp("gmm") / "gmm.pkl"
    with open(path, "wb") as f:
        pickle.dump(gmm, f, protocol=2)
    return str(path)


PRIOR_CASES = {
    "l2": {},
    "l1": {},
    "identity": {},
    "mean": {"mean": np.linspace(-0.5, 0.5, 9).astype(np.float32)},
    "threshold": {"margin": 0.5},
    "threshold_l1": {"margin": 0.5, "norm": "l1"},
    "penalty": {"margin": 1.2},
    "penalty_l1": {"margin": 2.0, "norm": "l1"},
    "penalty_entries": {"margin": 0.5, "use_vector": False},
    "penalty_entries_l1": {"margin": 0.5, "use_vector": False,
                           "norm": "l1"},
    "barrier": {"margin": 3.0},
    "barrier_one_sided": {"margin": 3.0, "symmetric": False},
    "barrier_inverse": {"margin": 3.0, "barrier": "inverse"},
    "gmm": {},
    "gmm_max": {"use_max": True},
}


@pytest.mark.parametrize("case", list(PRIOR_CASES))
def test_build_prior_matches_jax(case, gmm_path):
    """Every prior through ``build_prior``: value and gradient."""
    kw = dict(PRIOR_CASES[case])
    prior_type = case.split("_")[0]
    if prior_type == "gmm":
        kw["path"] = gmm_path
    jp = jpriors.build_prior(prior_type, **kw)
    tp = priors.build_prior(prior_type, **kw)
    want, jgrad = jax.value_and_grad(jp)(jnp.asarray(X))
    x = torch.from_numpy(X.copy()).requires_grad_()
    got = tp(x)
    got.backward()
    _close(got, want)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(x.grad.numpy(), jgrad, rtol=0,
                               atol=1e-5 * np.abs(jgrad).max())


def test_gender_shape_prior_through_build_prior(tmp_path):
    """'gender-shape' with its stats files: per-gender Mahalanobis rows,
    neutral rows the squared norm; a prior type other than 'normal'
    raises on both sides."""
    g = np.random.default_rng(3)
    paths = {}
    for gender in ("female", "male"):
        a = g.normal(size=(10, 10))
        paths[gender] = str(tmp_path / f"{gender}.npz")
        np.savez(paths[gender], mean=g.normal(size=10) * 0.2,
                 covariance=a @ a.T + np.eye(10))
    cfg = {"gender_shape": {"female_stats_path": paths["female"],
                            "male_stats_path": paths["male"]}}
    betas = g.normal(size=(5, 10)).astype(np.float32)
    genders = np.array([0, 1, 2, 2, 1], np.int32)
    want = jpriors.build_prior("gender-shape", **cfg)(
        jnp.asarray(betas), jnp.asarray(genders))
    got = priors.build_prior("gender-shape", **cfg)(
        torch.from_numpy(betas), torch.from_numpy(genders))
    _close(got, want)
    for mod in (jpriors, priors):
        with pytest.raises(NotImplementedError):
            mod.GenderShapePrior(paths["female"], paths["male"],
                                 prior_type="l2")
    with pytest.raises(ValueError):
        priors.build_prior("nope")
