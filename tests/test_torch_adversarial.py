"""The port's adversarial training against the JAX package, on the CPU:
both discriminators (logits and the spectral-norm ``u`` refresh, weights
carried by ``io.from_jax``), LSGAN's and WGAN-GP's losses and gradients
(one shared tau), and one adversarial train step of the flagship's head
from the features onward against ``make_adversarial_train_step``: both
sides' losses and parameters after the step. Seeded numpy inputs go to
both sides; each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.losses.adversarial import build_adv_loss as jbuild_adv_loss
from shapy_tpu.models.body import SMPLX as JSMPLX
from shapy_tpu.models.discriminator import (
    build_discriminator as jbuild_discriminator,
)
from shapy_tpu.models.heads import SMPLXRegressor as JRegressor
from shapy_tpu.train import RegressorLosses as JRegressorLosses
from shapy_tpu.train import TrainState as JTrainState
from shapy_tpu.train import build_optimizer as jbuild_optimizer
from shapy_tpu.train.step import (
    make_adversarial_train_step as jmake_adversarial_train_step,
)
from shapy_tpu_torch.flagship import (
    FLAGSHIP_BODY_CFG,
    FLAGSHIP_NETWORK_CFG,
    FLAGSHIP_OPTIM_CFG,
    FLAGSHIP_TRAIN_LOSS_CFG,
    synthetic_train_batches,
)
from shapy_tpu_torch.io.from_jax import (
    load_discriminator_from_jax,
    load_regressor_from_jax,
    state_dict_from_jax,
)
from shapy_tpu_torch.losses.adversarial import build_adv_loss
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
from shapy_tpu_torch.models.body.model import SMPLX
from shapy_tpu_torch.models.discriminator import build_discriminator
from shapy_tpu_torch.models.heads.regressor import SMPLXRegressor
from shapy_tpu_torch.train.losses import RegressorLosses
from shapy_tpu_torch.train.step import (
    TrainState,
    build_optimizer,
    init_train_state,
    make_adversarial_train_step,
)
from tests.test_torch_regressor import _perturbed_params

torch.set_num_threads(2)

DISC_CFGS = {
    "hmr": {"type": "hmr", "nzfeat": 64},
    "hmr-no-sn": {"type": "hmr", "nzfeat": 64, "use_spectral_norm": False},
    "per-joint": {"type": "per-joint", "hidden": 8},
}
# The discriminator's Adam without weight decay: the JAX step keeps the
# spectral-norm u among the optimizer's params, and coupled decay moves
# it before its refresh (ROADMAP, queue 3); the port's u is a buffer.
DISC_OPTIM_CFG = {"type": "adam", "lr": 1e-4}


def _rotations(g, shape):
    q, _ = np.linalg.qr(g.normal(size=shape + (3, 3)))
    return q.astype(np.float32)


def _pair(name):
    """A JAX discriminator and the port's with its weights."""
    jdisc = jbuild_discriminator(DISC_CFGS[name])
    params = jax.tree_util.tree_map(np.asarray, jdisc.params)
    disc = load_discriminator_from_jax(build_discriminator(DISC_CFGS[name]),
                                       params)
    return jdisc, params, disc


def _jlogits(jdisc, params, x):
    out = jdisc.apply(params, jnp.asarray(x))
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("name", list(DISC_CFGS))
def test_discriminator_logits_match_jax(name):
    """Logits of both discriminator types (and the per-joint one's betas
    branch): rel 1e-5 / atol 1e-6."""
    jdisc, params, disc = _pair(name)
    g = np.random.default_rng(0)
    rot = _rotations(g, (3, 21))
    want = np.asarray(_jlogits(jdisc, params, rot))
    got = disc(torch.from_numpy(rot)).detach().numpy()
    assert got.shape == want.shape == (3, 22)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if name == "per-joint":
        betas = g.normal(size=(3, 10)).astype(np.float32)
        want = np.asarray(jdisc.apply(params, jnp.asarray(rot),
                                      jnp.asarray(betas)))
        got = disc(torch.from_numpy(rot), torch.from_numpy(betas))
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-6)


def test_spectral_norm_u_refresh_matches_jax():
    """``refresh_u_`` moves every ``u`` as the JAX apply's u updates
    (atol 1e-6); a forward leaves ``u`` as it is, and ``u`` takes no
    gradient."""
    jdisc, params, disc = _pair("hmr")
    rot = _rotations(np.random.default_rng(1), (2, 21))
    _, upd = jdisc.apply(params, jnp.asarray(rot), train=True)
    before = {k: v.clone() for k, v in disc.state_dict().items()}
    disc(torch.from_numpy(rot)).sum().backward()
    for k, v in disc.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert not any(b.requires_grad for b in disc.buffers())
    disc.refresh_u_()
    assert set(upd) == set(disc.LAYERS)
    for layer in disc.LAYERS:
        np.testing.assert_allclose(getattr(disc, layer).u.numpy(),
                                   np.asarray(upd[layer]), atol=1e-6,
                                   err_msg=layer)


def _tree_close(got: dict, want, atol_rel: float, msg: str):
    """Each tensor within ``atol_rel`` of its largest element, or of 1e-3
    of 1e-2 of the largest over all tensors where that is more (a gradient that
    cancels to rounding noise, as WGAN's last biases': their score terms
    enter the fake and the real means alike)."""
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, want))
    want = {k: v for k, v in want.items() if not k.endswith(".u")}
    assert set(got) == set(want), set(got) ^ set(want)
    top = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-2 * top)
        torch.testing.assert_close(got[k], w, rtol=0, atol=atol_rel * scale,
                                   msg=f"{msg} {k}")


@pytest.mark.parametrize("loss_type", ["lsgan", "wgan-gp"])
def test_adversarial_losses_and_gradients_match_jax(loss_type):
    """Generator and discriminator losses of LSGAN and WGAN-GP (weight,
    gp_weight and gamma set off their defaults), and their gradients to
    the discriminator's weights and to the fake rotations, with the same
    tau on both sides (the JAX key's draw): losses rel 1e-5, gradients
    within 1e-5 of each tensor's largest."""
    cfg = {"type": loss_type, "weight": 0.7,
           "wgan_gp": {"gp_weight": 2.0, "gamma": 1.5}}
    jdisc, params, disc = _pair("hmr")
    jadv = jbuild_adv_loss(lambda p, x: jdisc.apply(p, x)[0], cfg)
    adv = build_adv_loss(disc, cfg)
    g = np.random.default_rng(2)
    fake, real = _rotations(g, (4, 21)), _rotations(g, (4, 21))
    rng = jax.random.PRNGKey(5)
    tau = np.array(jax.random.uniform(rng, (4, 1, 1, 1)))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)

    # Jitted: eagerly JAX compiles each op of the discriminator alone.
    (jd, jaux), jdgrad = jax.jit(jax.value_and_grad(
        lambda p: jadv.discriminator_loss(p, jnp.asarray(fake),
                                          jnp.asarray(real), rng=rng),
        has_aux=True))(jparams)
    jg, jfgrad = jax.jit(jax.value_and_grad(
        lambda f: jadv.generator_loss(jparams, f)))(jnp.asarray(fake))

    d, aux = adv.discriminator_loss(torch.from_numpy(fake),
                                    torch.from_numpy(real),
                                    tau=torch.from_numpy(tau))
    d.backward()
    np.testing.assert_allclose(float(d.detach()), float(jd), rtol=1e-5)
    for k, v in jaux.items():
        np.testing.assert_allclose(aux[k].detach().numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    _tree_close({k: p.grad for k, p in disc.named_parameters()}, jdgrad,
                1e-5, "d loss gradient")

    disc.zero_grad()
    f = torch.from_numpy(fake).requires_grad_()
    gl = adv.generator_loss(f)
    gl.backward()
    np.testing.assert_allclose(float(gl.detach()), float(jg), rtol=1e-5)
    scale = float(np.abs(np.asarray(jfgrad)).max())
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(jfgrad), rtol=0,
                               atol=1e-5 * scale)


def test_wgan_gp_needs_a_draw():
    disc = build_discriminator(DISC_CFGS["hmr"])
    adv = build_adv_loss(disc, {"type": "wgan-gp"})
    x = torch.from_numpy(_rotations(np.random.default_rng(3), (2, 21)))
    with pytest.raises(ValueError, match="generator or tau"):
        adv.discriminator_loss(x, x)
    gen = torch.Generator().manual_seed(0)
    a = adv.discriminator_loss(x, x.flip(0), generator=gen)[0]
    b = adv.discriminator_loss(x, x.flip(0),
                               generator=torch.Generator().manual_seed(0))[0]
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        build_adv_loss(disc, {"type": "nope"})
    with pytest.raises(ValueError):
        build_discriminator({"type": "nope"})


NETWORK_CFG = dict(FLAGSHIP_NETWORK_CFG,
                   mlp={"layers": [64, 64], "dropout": 0.0})


@pytest.fixture(scope="module", params=["wgan-gp"])
def adversarial_step_pair(request):
    """One adversarial train step of the flagship from the features
    onward on both sides (as ``tests/test_torch_train.py``'s plain step:
    the W48 flagship's head, MLP (64, 64), dropout 0, batch 2, synthetic
    SMPL-X at subdivisions 1, seeded features; no measurement module, as
    the losses take no measurement term), with an HMR discriminator
    (nzfeat 64) whose weights the port takes from the JAX one, its Adam at
    lr 1e-4 without decay, and the JAX step's WGAN-GP tau given to the
    port's loss. WGAN-GP, whose penalty is the gradient of a gradient;
    LSGAN's losses and gradients are held above. The JAX step is jitted:
    eagerly it compiles each of its ~1000 ops on its own (~100 s)."""
    loss_type = request.param
    adv_cfg = {"type": loss_type, "weight": 0.5}
    data = make_synthetic_model_data("smplx", subdivisions=1, seed=0)
    jmodel = JSMPLX(model_data=data)
    jreg = JRegressor(body_model_cfg=FLAGSHIP_BODY_CFG,
                      network_cfg=NETWORK_CFG, body_model=jmodel)
    params = _perturbed_params(jreg.params, jreg.param_slices, seed=2)
    reg = SMPLXRegressor(SMPLX(data), None, FLAGSHIP_BODY_CFG, NETWORK_CFG)
    load_regressor_from_jax(reg, params)
    reg.prepare_for_train_()
    batch = synthetic_train_batches(reg, 1, 2, 64, seed=3)[0]
    batch.pop("images")
    batch["real_body_pose"] = torch.from_numpy(
        _rotations(np.random.default_rng(4), (2, 21)))
    feats = np.random.default_rng(8).uniform(
        0, 1, size=(2, 2048)).astype(np.float32)
    jdisc, dparams, disc = _pair("hmr")

    jreg.compute_features = lambda p, images, *args: images
    params = dict(params, backbone={})
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jdparams = jax.tree_util.tree_map(jnp.asarray, dparams)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jlosses = JRegressorLosses(FLAGSHIP_TRAIN_LOSS_CFG)
    jadv = jbuild_adv_loss(lambda p, x: jdisc.apply(p, x)[0], adv_cfg)
    rng = jax.random.PRNGKey(0)
    _, gp_rng = jax.random.split(rng)
    tau = np.array(jax.random.uniform(gp_rng, (2, 1, 1, 1)))
    tx = jbuild_optimizer(FLAGSHIP_OPTIM_CFG)
    tx_disc = jbuild_optimizer(DISC_OPTIM_CFG)
    jstep = jmake_adversarial_train_step(jreg, jlosses, jadv, jdisc, tx,
                                         tx_disc)
    jstate = JTrainState(params=jparams, opt_state=tx.init(jparams),
                         step=jnp.asarray(0, jnp.int32))
    jdstate = JTrainState(params=jdparams, opt_state=tx_disc.init(jdparams),
                          step=jnp.asarray(0, jnp.int32))
    jstate, jdstate, jmetrics = jax.jit(jstep)(
        jstate, jdstate, jnp.asarray(feats), jbatch, rng, jmodel.params)

    reg.compute_features = lambda images: images
    adv = build_adv_loss(disc, adv_cfg)
    if loss_type == "wgan-gp":
        d_loss = adv.discriminator_loss
        adv.discriminator_loss = lambda f, r, generator=None: d_loss(
            f, r, tau=torch.from_numpy(tau))
    step = make_adversarial_train_step(
        reg, RegressorLosses(FLAGSHIP_TRAIN_LOSS_CFG),
        init_train_state(reg, FLAGSHIP_OPTIM_CFG), disc, adv,
        TrainState(*build_optimizer(disc.named_parameters(),
                                    DISC_OPTIM_CFG)))
    metrics = step(torch.from_numpy(feats), batch)
    return {"jmetrics": jmetrics, "metrics": metrics, "jstate": jstate,
            "jdstate": jdstate, "jparams": params, "jdparams": dparams,
            "reg": reg, "disc": disc, "step": step}


def test_adversarial_step_losses_match_jax(adversarial_step_pair):
    """Every loss term, ``adv_gen``, ``adv_disc`` and the adversarial
    loss's scalars: rel 1e-5 (atol 1e-6)."""
    p = adversarial_step_pair
    assert set(p["metrics"]) == set(p["jmetrics"])
    assert {"adv_gen", "adv_disc"} <= set(p["metrics"])
    for k, v in p["jmetrics"].items():
        np.testing.assert_allclose(float(p["metrics"][k]), float(v),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert p["step"].state.step == 1 and p["step"].disc_state.step == 1


def _updates_close(module, new, old, lr: float, wd: float, what: str):
    """Adam's first step moves each element by ~lr x sign(g + wd p), g the
    step's gradient (the port's, which the gradient tests hold to the JAX
    package's): within 2e-6 where it is above 1e-5 of the tensor's largest
    (or of 1e-2 of the largest over all tensors, where that is more),
    unmoved where it is exactly 0 (a ReLU that no row passes), the two
    together over 90% of each tensor whose gradient is not rounding noise;
    every element within 2 lr."""
    new, old = (state_dict_from_jax(jax.tree_util.tree_map(np.asarray, t))
                for t in (new, old))
    params = dict(module.named_parameters())
    top = max(float(params[k].grad.abs().max()) for k in new
              if not k.endswith(".u"))
    for name, want in new.items():
        if name.endswith(".u"):
            continue
        got, grad = params[name].detach(), params[name].grad
        decay = 0.0 if "bias" in name else wd * old[name]
        g = grad + decay
        floor = 1e-5 * max(float(grad.abs().max()), 1e-2 * top)
        held, still = g.abs() > floor, g == 0
        if float(grad.abs().max()) > 1e-2 * top:
            assert float((held | still).float().mean()) > 0.9, (what, name)
        torch.testing.assert_close(got[held], want[held], rtol=0,
                                   atol=2e-6, msg=f"{what} {name}")
        assert torch.equal(got[still], old[name][still]), (what, name)
        torch.testing.assert_close(got, want, rtol=0, atol=2 * lr + 1e-6,
                                   msg=f"{what} {name}")


def test_adversarial_step_updates_match_jax(adversarial_step_pair):
    """Both sides' parameters after the step: the head's (Adam, coupled
    decay 1e-4) and the discriminator's (Adam, no decay), as
    :func:`_updates_close`; the discriminator's ``u`` refreshed at its new
    weights within 1e-6 of the JAX step's."""
    p = adversarial_step_pair
    _updates_close(p["reg"], {"head": p["jstate"].params["head"]},
                   {"head": p["jparams"]["head"]}, FLAGSHIP_OPTIM_CFG["lr"],
                   FLAGSHIP_OPTIM_CFG["weight_decay"], "head")
    _updates_close(p["disc"], p["jdstate"].params, p["jdparams"],
                   DISC_OPTIM_CFG["lr"], 0.0, "discriminator")
    for layer in p["disc"].LAYERS:
        np.testing.assert_allclose(
            getattr(p["disc"], layer).u.numpy(),
            np.asarray(p["jdstate"].params[layer]["u"]), atol=1e-6,
            err_msg=layer)
