"""The port's training path against the JAX package, on the CPU (the
kernels' plain versions): train-mode BatchNorm (K4's oracle), one
Bottleneck and one BasicBlock in train mode, ``RegressorLosses``,
``build_optimizer`` and its schedules, the flagship's train step from
the features onward, one ResNet-18 train step from the images, and
``Trainer.fit``.

The flagship's train step is compared from the features onward, not from
the images: an eager JAX train step through HRNet-W48 takes minutes on a
CPU (and a jitted one as long to compile), more than this file's share
of the test run. ResNet-18's step is small enough to compare whole. The backbone's train mode is held instead by the BN test
and by one Bottleneck and one BasicBlock against the JAX
``bottleneck_block`` / ``basic_block``. The step runs the W48 flagship's
head (MLP (64, 64), dropout 0) on seeded features, batch 2, synthetic
SMPL-X at ``subdivisions=1``, the losses of ``configs/train_shapy.yaml``
that need no files and Adam at lr 1e-4 with weight decay 1e-4. Seeded
numpy inputs and weights go to both sides; each test states its
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shapy_tpu.losses.priors import GenderShapePrior as JGenderShapePrior
from shapy_tpu.losses.priors import NormalShapePrior as JNormalShapePrior
from shapy_tpu.measure import BodyMeasurements as JBodyMeasurements
from shapy_tpu.measure import MeasurementAnchors as JAnchors
from shapy_tpu.models.backbones import layers as jlayers
from shapy_tpu.models.body import SMPLX as JSMPLX
from shapy_tpu.models.heads import SMPLXRegressor as JRegressor
from shapy_tpu.train import RegressorLosses as JRegressorLosses
from shapy_tpu.train import TrainState as JTrainState
from shapy_tpu.train import build_optimizer as jbuild_optimizer
from shapy_tpu.train import make_train_step as jmake_train_step
from shapy_tpu.train.losses import center_keypoints as jcenter_keypoints
from shapy_tpu.train.step import forward_with_stats
from shapy_tpu_torch.flagship import (
    FLAGSHIP_BODY_CFG,
    FLAGSHIP_NETWORK_CFG,
    FLAGSHIP_OPTIM_CFG,
    FLAGSHIP_TRAIN_LOSS_CFG,
    build_flagship,
    synthetic_train_batches,
)
from shapy_tpu_torch.io.from_jax import (
    load_regressor_from_jax,
    state_dict_from_jax,
)
from shapy_tpu_torch.losses.priors import GenderShapePrior, NormalShapePrior
from shapy_tpu_torch.measure.measurements import (
    BodyMeasurements,
    MeasurementAnchors,
    candidate_faces,
)
from shapy_tpu_torch.models.backbones.layers import (
    BasicBlock,
    Bottleneck,
    batch_norm_train,
    batch_norm_train_backward_plain,
    batch_norm_train_plain,
)
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
from shapy_tpu_torch.models.body.model import SMPLX
from shapy_tpu_torch.models.heads.mlp import MLP
from shapy_tpu_torch.models.heads.regressor import SMPLXRegressor
from shapy_tpu_torch.train.losses import RegressorLosses, center_keypoints
from shapy_tpu_torch.train.step import (
    build_optimizer,
    init_train_state,
    make_train_step,
)
from shapy_tpu_torch.train.trainer import (
    Trainer,
    _stream_from,
    merge_stream_batches,
)
from tests.test_torch_regressor import _perturbed_params

torch.set_num_threads(2)

LOSS_CFG, OPTIM_CFG = FLAGSHIP_TRAIN_LOSS_CFG, FLAGSHIP_OPTIM_CFG
NETWORK_CFG = dict(FLAGSHIP_NETWORK_CFG,
                   mlp={"layers": [64, 64], "dropout": 0.0})


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> an NCHW channels-last tensor over the same data."""
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


# -- K4: train-mode BatchNorm ----------------------------------------------

def test_batch_norm_train_matches_jax():
    """Forward, VJP (the JAX custom VJP vs the autograd.Function's
    backward) and the running-stat EMA, f32: rel 1e-5 (reductions over
    the 90 rows in another order)."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, 9, 7)) * 2 + 0.5).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, size=7).astype(np.float32)
    beta = rng.normal(size=7).astype(np.float32)
    rmean = rng.normal(size=7).astype(np.float32)
    rvar = rng.uniform(0.5, 2.0, size=7).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)

    (want, _, _), vjp = jax.vjp(
        lambda a, g, b: jlayers.bn_train_core(a, g, b, 1e-5, None),
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    zeros = jnp.zeros(7, jnp.float32)
    want_dx, want_dg, want_db = vjp((jnp.asarray(dy), zeros, zeros))
    store = jlayers.ParamStore({"bn.weight": gamma, "bn.bias": beta,
                                "bn.running_mean": rmean,
                                "bn.running_var": rvar})
    jlayers.batch_norm(store, "bn", jnp.asarray(x), train=True)

    xt = _nchw(x).requires_grad_()
    g = torch.from_numpy(gamma).requires_grad_()
    b = torch.from_numpy(beta).requires_grad_()
    rm, rv = torch.from_numpy(rmean.copy()), torch.from_numpy(rvar.copy())
    y = batch_norm_train(xt, g, b, rm, rv)
    y.backward(_nchw(dy))
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_nhwc(y), np.asarray(want), **tol)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(want_dx), **tol)
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(want_dg), **tol)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(want_db), **tol)
    np.testing.assert_allclose(
        rm.numpy(), np.asarray(store.stat_updates["bn.running_mean"]), **tol)
    np.testing.assert_allclose(
        rv.numpy(), np.asarray(store.stat_updates["bn.running_var"]), **tol)


def test_batch_norm_fused_backward_is_the_gradient():
    """The fused two-reduction formula (K4's backward and its plain
    version) equals autograd through the plain forward's moments, in f64
    (atol 1e-10: the same math in another order)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(3, 4, 5, 6)) * 3 + 1)
    gamma = torch.from_numpy(rng.uniform(0.5, 1.5, size=4))
    beta = torch.from_numpy(rng.normal(size=4))
    dy = torch.from_numpy(rng.normal(size=x.shape))
    xs, gs, bs = (t.clone().requires_grad_() for t in (x, gamma, beta))
    y, mean, var = batch_norm_train_plain(xs, gs, bs)
    y.backward(dy)
    dx, dg, db = batch_norm_train_backward_plain(
        dy, x, gamma, mean.detach(), torch.rsqrt(var.detach() + 1e-5))
    for got, want in ((dx, xs.grad), (dg, gs.grad), (db, bs.grad)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-10)


def test_batch_norm_train_bf16_plain():
    """bf16 activations: moments in f32, y in bf16 (one bf16 step of the
    f32 result), f32 parameter gradients."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 3, 4, 4)).astype(np.float32))
    gamma = torch.ones(3, requires_grad=True)
    beta = torch.zeros(3, requires_grad=True)
    xb = x.to(torch.bfloat16).requires_grad_()
    y = batch_norm_train(xb, gamma, beta)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert xb.grad.dtype == torch.bfloat16
    assert gamma.grad.dtype == torch.float32
    ref = batch_norm_train(xb.detach().float(), gamma.detach(), beta.detach())
    torch.testing.assert_close(y.float(), ref, rtol=2 ** -7, atol=2 ** -7)


def _block_params(rng, module):
    """Seeded numpy weights for every parameter and BN buffer of a
    torch block, keyed by its state_dict names (OIHW convs)."""
    out = {}
    for name, t in module.state_dict().items():
        if name.endswith("running_var"):
            v = rng.uniform(0.5, 2.0, size=t.shape)
        elif t.dim() == 4:
            v = rng.normal(size=t.shape) * np.sqrt(2.0 / t[0].numel())
        elif name.endswith("weight"):
            v = rng.uniform(0.5, 1.5, size=t.shape)
        else:
            v = rng.normal(size=t.shape) * 0.1
        out[name] = v.astype(np.float32)
    return out


@pytest.mark.parametrize("kind", ["bottleneck", "basic"])
def test_train_block_matches_jax(kind):
    """One Bottleneck (with a BN downsample) and one BasicBlock in train
    mode against the JAX ``bottleneck_block`` / ``basic_block``: output,
    VJP to the input and every parameter, and the running stats. rtol
    1e-4, atol 1e-5: 3x3 convs summed in another order (oneDNN vs
    XLA)."""
    rng = np.random.default_rng(4)
    if kind == "bottleneck":
        block = Bottleneck(32, 16, 1, downsample=True)
        jfn, planes, cin = jlayers.bottleneck_block, 16, 32
    else:
        block = BasicBlock(24, 16, 2, downsample=True)
        jfn, planes, cin = jlayers.basic_block, 16, 24
    params = _block_params(rng, block)
    stride = 1 if kind == "bottleneck" else 2
    x = rng.normal(size=(2, 8, 8, cin)).astype(np.float32)
    jparams = {f"b.{k}": (v.transpose(2, 3, 1, 0) if v.ndim == 4 else v)
               for k, v in params.items()}
    trainable = {k: v for k, v in jparams.items() if "running" not in k}

    def run(xj, tp):
        store = jlayers.ParamStore({**jparams, **tp})
        y = jfn(store, "b", xj, planes, stride, True, train=True)
        return y, store.stat_updates

    (want, stats), vjp = jax.vjp(run, jnp.asarray(x), trainable)
    dy = rng.normal(size=want.shape).astype(np.float32)
    want_dx, want_dp = vjp((jnp.asarray(dy), jax.tree_util.tree_map(
        jnp.zeros_like, stats)))

    block.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    block.train()
    xt = _nchw(x).contiguous(memory_format=torch.channels_last)
    xt.requires_grad_()
    y = block(xt)
    y.backward(_nchw(dy))
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_nhwc(y), np.asarray(want), **tol)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(want_dx), **tol)
    grads = dict(block.named_parameters())
    for name, g in want_dp.items():
        g = np.asarray(g)
        got = grads[name[2:]].grad.numpy()
        if g.ndim == 4:
            g = g.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(got, g, err_msg=name, **tol)
    buffers = dict(block.named_buffers())
    for name, v in stats.items():
        np.testing.assert_allclose(buffers[name[2:]].numpy(), np.asarray(v),
                                   err_msg=name, **tol)


# -- losses ------------------------------------------------------------------

def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def _rotations(rng, shape):
    q, _ = np.linalg.qr(rng.normal(size=shape + (3, 3)))
    return (q * np.sign(np.linalg.det(q))[..., None, None]).astype(np.float32)


@pytest.mark.parametrize("stages", [["stage_02"], ["stage_01", "stage_02"]],
                         ids=["last-stage", "two-stages"])
def test_regressor_losses_match_jax(stages):
    """Every term of ``RegressorLosses`` (keypoints 2D / 3D, shape, both
    rotations with pose validity, the gender-shape prior, the five
    measurements with and without validity masks, identity, refined
    betas and vertices, attributes) and the gradient of the total to the
    betas and joints, on the same outputs and batch. rel 1e-5 (f32)."""
    rng = np.random.default_rng(5)
    B = 4
    f32 = np.float32

    def stage():
        return {
            "joints": rng.normal(size=(B, 12, 3)).astype(f32),
            "betas": rng.normal(size=(B, 10)).astype(f32),
            "global_rot": _rotations(rng, (B, 1)),
            "body_pose": _rotations(rng, (B, 21)),
            "v_shaped": rng.normal(size=(B, 20, 3)).astype(f32),
            "betas_ref": rng.normal(size=(B, 10)).astype(f32),
            "v_shaped_ref": rng.normal(size=(B, 20, 3)).astype(f32),
            "measurements": {k: rng.uniform(0.5, 2, size=B).astype(f32)
                             for k in ("mass", "height", "chest", "waist",
                                       "hips")},
        }

    out = {s: stage() for s in stages}
    out["proj_joints"] = rng.normal(size=(B, 12, 2)).astype(f32)
    out["attributes"] = rng.normal(size=(B, 15)).astype(f32)
    kp = rng.normal(size=(B, 10, 3)).astype(f32)
    kp[..., 2] = rng.uniform(size=(B, 10)) > 0.3
    j3 = rng.normal(size=(B, 9, 4)).astype(f32)
    j3[..., 3] = rng.uniform(size=(B, 9)) > 0.3
    batch = {
        "target_keypoints2d": kp, "joints3d": j3,
        "gt_betas": rng.normal(size=(B, 10)).astype(f32),
        "gt_betas_valid": np.array([1, 0, 1, 1], f32),
        "gt_global_rot": _rotations(rng, (B, 1)),
        "gt_body_pose": _rotations(rng, (B, 21)),
        "gt_pose_valid": np.array([1, 1, 0, 1], f32),
        "gender": np.array([0, 1, 2, 2]),
        "identity": np.array([3, 3, -1, 3]),
        "attributes": rng.normal(size=(B, 15)).astype(f32),
        "attributes_valid": np.array([1, 1, 0, 1], f32),
        **{k: rng.uniform(0.5, 2, size=B).astype(f32)
           for k in ("mass", "height", "chest", "waist", "hips")},
        "height_valid": np.array([1, 0, 1, 1], f32),
        "hips_valid": np.array([0, 1, 1, 1], f32),
    }
    cfg = {"body": {
        "stages_to_penalize": stages,
        "shape": {"weight": 1e-3, "prior": {"weight": 1e-2}},
        **{k: {"weight": w} for k, w in (
            ("body_joints_2d", 1.0), ("body_joints_3d", 0.5),
            ("global_rot", 1.0), ("body_pose", 2.0), ("attributes", 10.0),
            ("mass", 0.1), ("height", 1.0), ("chest", 2.0), ("waist", 0.5),
            ("hips", 1.5), ("identity", 0.3), ("beta_refined", 0.7),
            ("vertex_refined", 0.2))}}}
    mean, cov = rng.normal(size=10) * 0.1, np.eye(10) * 2 + 0.1
    jprior = JGenderShapePrior(
        female_prior=JNormalShapePrior(mean=mean, covariance=cov),
        male_prior=JNormalShapePrior(mean=-mean, covariance=cov * 2))
    tprior = GenderShapePrior(
        female_prior=NormalShapePrior(mean=mean, covariance=cov),
        male_prior=NormalShapePrior(mean=-mean, covariance=cov * 2))

    def jtotal(betas, joints):
        o = jax.tree_util.tree_map(jnp.asarray, out)
        o[stages[-1]] = dict(o[stages[-1]], betas=betas, joints=joints)
        res = JRegressorLosses(cfg, gender_shape_prior=jprior)(
            o, jax.tree_util.tree_map(jnp.asarray, batch))
        return res["total"], res

    last = out[stages[-1]]
    (_, want), want_g = jax.value_and_grad(jtotal, argnums=(0, 1),
                                           has_aux=True)(
        jnp.asarray(last["betas"]), jnp.asarray(last["joints"]))

    t_out = _to_torch(out)
    betas = t_out[stages[-1]]["betas"].requires_grad_()
    joints = t_out[stages[-1]]["joints"].requires_grad_()
    got = RegressorLosses(cfg, gender_shape_prior=tprior)(
        t_out, {k: torch.from_numpy(v) for k, v in batch.items()})
    got["total"].backward()
    assert set(got) == set(want) and len(got) == 14 * len(stages) + 2
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(betas.grad.numpy(), np.asarray(want_g[0]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(joints.grad.numpy(), np.asarray(want_g[1]),
                               rtol=1e-5, atol=1e-7)


def test_center_keypoints_matches_jax():
    rng = np.random.default_rng(6)
    kp = rng.normal(size=(3, 8, 2)).astype(np.float32)
    conf = (rng.uniform(size=(3, 8)) > 0.3).astype(np.float32)
    conf[0, [2, 5]] = 1.0
    want = jcenter_keypoints(jnp.asarray(kp), jnp.asarray(conf), [2, 5])
    got = center_keypoints(torch.from_numpy(kp), torch.from_numpy(conf),
                           [2, 5])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)


# -- optimizers --------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    {"type": "adam", "lr": 1e-2, "weight_decay": 1e-2,
     "weight_decay_bias": 1e-3, "bias_lr_factor": 2.0,
     "scheduler": {"type": "multi-step-lr", "gamma": 0.1,
                   "milestones": [1, 2]}},
    {"type": "adamw", "lr": 1e-2, "bias_lr_factor": 0.5,
     "scheduler": {"type": "step-lr", "step_size": 2, "gamma": 0.5}},
    {"type": "sgd", "lr": 1e-1, "weight_decay": 1e-2,
     "sgd": {"momentum": 0.8, "nesterov": True},
     "scheduler": {"type": "exponential", "decay_steps": 2, "gamma": 0.5}},
    {"type": "sgd", "lr": 1e-1, "sgd": {"momentum": 0.9}},
    {"type": "rmsprop", "lr": 1e-2, "weight_decay": 1e-3,
     "bias_lr_factor": 3.0, "rmsprop": {"alpha": 0.9, "eps": 1e-3,
                                        "momentum": 0.5}},
], ids=["adam-multistep-biasgroup", "adamw-default-decay-steplr",
        "sgd-nesterov-exp", "sgd-momentum", "rmsprop-momentum"])
def test_build_optimizer_matches_optax(cfg):
    """3 updates of each optimizer and schedule, with a bias group,
    against the JAX package's optax chain on the same gradients. rel
    1e-5 (f32 updates in another order)."""
    rng = np.random.default_rng(7)
    shapes = {"lin.weight": (3, 4), "lin.bias": (3,), "bn.weight": (5,),
              "bn.bias": (5,)}
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]

    tx = jbuild_optimizer(cfg)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, params)
        params = optax.apply_updates(params, updates)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in init.items()}
    opt, sched = build_optimizer(tparams.items(), cfg)
    for g in grads:
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        sched.step()
    for k in shapes:
        np.testing.assert_allclose(tparams[k].detach().numpy(),
                                   np.asarray(params[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_mlp_dropout_draws_from_the_generator():
    mlp = MLP(6, 3, (200,), generator=torch.Generator().manual_seed(0),
              dropout=0.5)
    x = torch.ones(4, 6)
    hidden = mlp.layer_000(x)
    mlp.train()
    with pytest.raises(ValueError, match="generator"):
        mlp(x)
    a = mlp(x, torch.Generator().manual_seed(1))
    b = mlp(x, torch.Generator().manual_seed(1))
    c = mlp(x, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the mask: kept units scaled by 1 / (1 - p), the rest 0
    keep = torch.rand(hidden.shape, generator=torch.Generator().manual_seed(1))
    want = mlp.output_layer(torch.where(keep < 0.5, hidden / 0.5,
                                        torch.zeros_like(hidden)))
    torch.testing.assert_close(a, want)
    mlp.eval()
    torch.testing.assert_close(mlp(x), mlp.output_layer(hidden))


# -- the train step from the features onward ----------------------------------

STEPS = 3


@pytest.fixture(scope="module")
def train_step_pair():
    """Three train steps of the flagship from the features onward on both
    sides, from the same weights (``io.from_jax``), the same seeded
    features (B, 2048) and the same batch: the head, pose decode, SMPL-X
    (skinning and the chain), the camera, the measurements on all faces,
    the losses and Adam. Each side's ``compute_features`` is replaced by
    the identity, so the step's images are the features. The JAX side
    (eager) gives the first step's gradients (its loss's ``jax.grad``) and
    the state after ``STEPS`` calls of its ``make_train_step``."""
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
    feats = np.random.default_rng(8).uniform(
        0, 1, size=(2, 2048)).astype(np.float32)

    jreg.compute_features = lambda p, images, *args: images
    params = dict(params, backbone={})
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jfeats = jnp.asarray(feats)
    jlosses = JRegressorLosses(LOSS_CFG)
    rng = jax.random.PRNGKey(0)

    def compute(p, f):
        out, _ = forward_with_stats(jreg, p, f, jbatch, rng,
                                    model_params=jmodel.params)
        loss = jlosses(out, jbatch)
        return loss["total"], loss

    (jgrads, jdfeats), jloss = jax.grad(compute, argnums=(0, 1),
                                        has_aux=True)(jparams, jfeats)
    tx = jbuild_optimizer(OPTIM_CFG)
    jstep = jmake_train_step(jreg, jlosses, tx)
    jstate = JTrainState(params=jparams, opt_state=tx.init(jparams),
                         step=jnp.asarray(0, jnp.int32))
    for _ in range(STEPS):
        jstate, jmetrics = jstep(jstate, jfeats, jbatch, rng, jmodel.params)

    reg.compute_features = lambda images: images
    mean_before = reg.param_mean.clone()
    step = make_train_step(reg, RegressorLosses(LOSS_CFG),
                           init_train_state(reg, OPTIM_CFG))
    tfeats = torch.from_numpy(feats).requires_grad_()
    loss = step.forward(tfeats, batch)
    step.backward(loss)
    grads = {k: p.grad.clone() for k, p in reg.named_parameters()
             if p.grad is not None}
    step.update()
    for _ in range(STEPS - 1):
        metrics = step(tfeats.detach(), batch)
    return {"jgrads": jgrads, "jdfeats": jdfeats, "jloss": jloss,
            "jparams": params, "jstate": jstate, "jmetrics": jmetrics,
            "loss": loss, "metrics": metrics, "grads": grads,
            "dfeats": tfeats.grad, "reg": reg, "mean_before": mean_before}


def test_train_step_losses_match_jax(train_step_pair):
    """Every loss term of the first and of the last step, f32 on both
    sides: rel 1e-5."""
    p = train_step_pair
    assert set(p["loss"]) == set(p["jloss"]) == set(p["jmetrics"]) == {
        "joints2d", "joints3d", "shape", "global_rot", "body_pose", "total"}
    for got, want in ((p["loss"], p["jloss"]), (p["metrics"], p["jmetrics"])):
        for k, v in want.items():
            np.testing.assert_allclose(float(got[k].detach()), float(v),
                                       rtol=1e-5, err_msg=k)


def test_train_step_gradients_match_jax(train_step_pair):
    """The first step's gradients to every head parameter and to the
    features, elementwise within 1e-5 of each tensor's largest; the
    backbone gets none (its train-mode VJP is held by the BN and block
    tests above)."""
    p = train_step_pair
    want = state_dict_from_jax({"head": p["jgrads"]["head"]})
    assert set(p["grads"]) == set(want)
    pairs = [(name, p["grads"][name], w) for name, w in want.items()]
    pairs.append(("features", p["dfeats"],
                  torch.from_numpy(np.array(p["jdfeats"]))))
    for name, got, w in pairs:
        scale = float(w.abs().max())
        assert scale > 0, name
        torch.testing.assert_close(got, w, rtol=0, atol=1e-5 * scale,
                                   msg=name)


def test_train_step_updates_match_jax(train_step_pair):
    """The head's parameters after three Adam steps (lr 1e-4, coupled
    weight decay 1e-4, no decay on biases). Where the first step's
    decayed gradient g + wd p has the same sign on both sides and a
    magnitude above 1e-5 of the tensor's largest gradient (the gradient
    test's tolerance), within 2e-6 (2% of a step; measured: up to 7.1e-7);
    that holds over 90% of each tensor's elements. Every element within
    2 x 3 lr: Adam's steps are about lr x sign, and a gradient at the
    level of f32 noise may turn its sign over. ``param_mean`` stays fixed
    in the port and is left out of the comparison: the JAX step moves it
    by weight decay (ROADMAP F4)."""
    p = train_step_pair
    reg = p["reg"]
    new = state_dict_from_jax({"head": p["jstate"].params["head"]})
    old = state_dict_from_jax({"head": p["jparams"]["head"]})
    jgrads = state_dict_from_jax({"head": p["jgrads"]["head"]})
    params = dict(reg.named_parameters())
    lr, wd = OPTIM_CFG["lr"], OPTIM_CFG["weight_decay"]
    for name, want in new.items():
        got = params[name].detach()
        assert not torch.equal(got, old[name]), name
        decay = 0.0 if "bias" in name else wd * old[name]
        gj, gt = jgrads[name] + decay, p["grads"][name] + decay
        floor = 1e-5 * float(jgrads[name].abs().max())
        held = (torch.sign(gj) == torch.sign(gt)) & (gj.abs() > floor) & (
            gt.abs() > floor)
        assert float(held.float().mean()) > 0.9, name
        torch.testing.assert_close(got[held], want[held], rtol=0, atol=2e-6,
                                   msg=name)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=2 * STEPS * lr + 1e-6, msg=name)
    assert torch.equal(reg.param_mean, p["mean_before"])
    assert not np.array_equal(np.asarray(p["jstate"].params["param_mean"]),
                              p["jparams"]["param_mean"])  # F4


# -- one ResNet-18 train step from the images --------------------------------

@pytest.fixture(scope="module")
def resnet_step_pair():
    """One train step of the flagship on ResNet-18 from the images (64^2,
    batch 2) on both sides, from the same perturbed weights
    (``io.from_jax``) and batch: the whole network, backbone included, in
    train mode (batch-moment BN, the 7x7 stem, the max pool). At this size
    the eager JAX step takes seconds, unlike W48's."""
    cfg = dict(NETWORK_CFG, backbone={"type": "resnet", "depth": 18})
    data = make_synthetic_model_data("smplx", subdivisions=1, seed=0)
    jmodel = JSMPLX(model_data=data)
    v_t = np.asarray(jmodel.params["v_template"])
    anchors = MeasurementAnchors.synthetic(jmodel.faces, v_t)
    subsets = candidate_faces(v_t, np.asarray(jmodel.params["shapedirs"]),
                              jmodel.faces, anchors)
    jreg = JRegressor(
        body_model_cfg=FLAGSHIP_BODY_CFG, network_cfg=cfg, body_model=jmodel,
        measurements=JBodyMeasurements(
            anchors=JAnchors.synthetic(jmodel.faces, v_t),
            num_hull_directions=256, face_subsets=subsets))
    params = _perturbed_params(jreg.params, jreg.param_slices, seed=6)
    model = SMPLX(data)
    reg = SMPLXRegressor(model, BodyMeasurements(anchors, model.faces, 256,
                                                 face_subsets=subsets),
                         FLAGSHIP_BODY_CFG, cfg)
    load_regressor_from_jax(reg, params)
    reg.prepare_for_train_()
    batch = synthetic_train_batches(reg, 1, 2, 64, seed=11)[0]
    images = batch.pop("images")

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jlosses = JRegressorLosses(LOSS_CFG)

    def compute(p):
        out, _ = forward_with_stats(jreg, p, jnp.asarray(images.numpy()),
                                    jbatch, jax.random.PRNGKey(0),
                                    model_params=jmodel.params)
        loss = jlosses(out, jbatch)
        return loss["total"], loss

    jgrads, jloss = jax.jit(jax.grad(compute, has_aux=True))(jparams)
    step = make_train_step(reg, RegressorLosses(LOSS_CFG),
                           init_train_state(reg, OPTIM_CFG))
    loss = step.forward(images, batch)
    step.backward(loss)
    grads = {k: p.grad.clone() for k, p in reg.named_parameters()
             if p.grad is not None}
    return {"loss": loss, "jloss": jloss, "grads": grads, "jgrads": jgrads}


def test_resnet18_train_step_losses_match_jax(resnet_step_pair):
    """Every loss term of the step, f32 on both sides: rel 1e-5."""
    p = resnet_step_pair
    assert set(p["loss"]) == set(p["jloss"])
    for k, v in p["jloss"].items():
        np.testing.assert_allclose(float(p["loss"][k].detach()), float(v),
                                   rtol=1e-5, err_msg=k)


def test_resnet18_train_step_gradients_match_jax(resnet_step_pair):
    """The gradient of every parameter of the network, the backbone's
    convs (the 7x7 stem among them) and BNs and the head's: rtol 1e-4,
    atol 1e-4 of each tensor's largest. f32 on both sides, summed in other
    orders (oneDNN, XLA) through ~20 train-mode BNs at batch 2, whose
    backward amplifies rounding: a one-ulp change of the images alone
    moves the port's gradients by up to 2.8e-5 of a tensor's largest; the
    two sides differ by at most ~6e-5."""
    p = resnet_step_pair
    want = state_dict_from_jax({k: p["jgrads"][k]
                                for k in ("backbone", "head")})
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 20  # the BN buffers take no gradient
    for k in stats:
        assert not want.pop(k).any(), k
    assert set(p["grads"]) == set(want)
    assert "backbone.conv1.weight" in want and "backbone.bn1.weight" in want
    for name, w in want.items():
        scale = float(w.abs().max())
        assert scale > 0, name
        torch.testing.assert_close(p["grads"][name], w, rtol=1e-4,
                                   atol=1e-4 * scale, msg=name)


# -- the trainer -------------------------------------------------------------

def _split_streams(batches):
    """Pose-like and shape-like streams with disjoint supervision."""
    pose_keys = ("images", "target_keypoints2d", "joints3d",
                 "gt_global_rot", "gt_body_pose")
    shape_keys = ("images", "target_keypoints2d", "gt_betas",
                  "gt_betas_valid", "gender")
    return ([{k: b[k].numpy() for k in pose_keys} for b in batches],
            [{k: b[k].numpy() for k in shape_keys} for b in batches])


def test_trainer_fit_on_cpu():
    """``Trainer.fit`` for 3 steps on the CPU over two merged streams:
    finite losses with every term, BN running stats moved, param_mean
    fixed, and dropout from a per-step generator (the same seed repeats
    the same losses)."""
    runs = []
    for _ in range(2):
        reg = build_flagship(subdivisions=1, mlp_layers=(64, 64),
                             device="cpu")
        pose, shape = _split_streams(
            synthetic_train_batches(reg, 2, 1, 64, seed=4))
        mean = reg.param_mean.clone()
        rvar = reg.backbone.bn1.running_var.clone()
        trainer = Trainer(reg, RegressorLosses(LOSS_CFG), OPTIM_CFG,
                          summary_steps=1, device="cpu")
        seen = []
        last = trainer.fit({"pose": pose, "shape": shape}, 3, seed=7,
                           on_step=lambda s, m: seen.append(
                               float(m["total"])))
        runs.append(seen)
        assert trainer.state.step == 3
        assert set(last) == {"joints2d", "joints3d", "shape", "global_rot",
                             "body_pose", "total"}
        assert all(np.isfinite(v) for v in last.values())
        assert torch.equal(reg.param_mean, mean)
        assert not torch.equal(reg.backbone.bn1.running_var, rvar)
    assert runs[0] == runs[1] and len(runs[0]) == 3


def test_merge_stream_batches_key_union():
    a = {"images": torch.ones(2, 3), "gt_betas": torch.ones(2, 10)}
    b = {"images": torch.zeros(1, 3), "gt_body_pose": torch.ones(1, 4, 3, 3)}
    merged = merge_stream_batches([a, b])
    assert set(merged) == {"images", "gt_betas", "gt_body_pose"}
    assert merged["gt_betas"].shape == (3, 10)
    assert float(merged["gt_betas"][2].abs().sum()) == 0.0
    assert float(merged["gt_body_pose"][:2].abs().sum()) == 0.0
    with pytest.raises(ValueError):
        merge_stream_batches([])


def test_merge_stream_batches_pads_full_images():
    """Full-image streams: the images zero-padded to the larger height
    and width before the concatenation (a crop reads zeros outside an
    image, so each crops as before), and a stream without channel noise
    fills its rows with factors of 1."""
    a = {"full_images": torch.full((2, 5, 7, 3), 9, dtype=torch.uint8),
         "crop_to_image_affines": torch.eye(3).repeat(2, 1, 1),
         "channel_noise": torch.full((2, 3), 1.2)}
    b = {"full_images": torch.full((1, 6, 4, 3), 3, dtype=torch.uint8),
         "crop_to_image_affines": torch.eye(3)[None]}
    m = merge_stream_batches([a, b])
    assert m["full_images"].shape == (3, 6, 7, 3)
    assert torch.equal(m["full_images"][:2, :5], a["full_images"])
    assert int(m["full_images"][:2, 5:].sum()) == 0
    assert torch.equal(m["full_images"][2, :, :4], b["full_images"][0])
    assert int(m["full_images"][2, :, 4:].sum()) == 0
    assert torch.equal(m["channel_noise"][2], torch.ones(3))


def test_stream_from_empty_loader_raises():
    with pytest.raises(ValueError, match="no batches"):
        next(_stream_from([]))


def test_trainer_refuses_what_is_not_ported():
    """The adversarial trainer is ported: ``use_adv_training`` builds the
    discriminator, its loss and its optimizer; what it refuses is an
    unknown discriminator or loss type, and a batch with neither
    ``real_body_pose`` nor GT pose rotations. A train-mode regressor
    still refuses an eval ``apply``."""
    reg = build_flagship(subdivisions=1, mlp_layers=(8,), device="cpu")
    trainer = Trainer(reg, RegressorLosses(LOSS_CFG), device="cpu",
                      use_adv_training=True,
                      disc_cfg={"type": "hmr", "nzfeat": 16})
    assert trainer.disc is not None and trainer.disc_state.step == 0
    with pytest.raises(ValueError, match="discriminator"):
        Trainer(reg, RegressorLosses(LOSS_CFG), device="cpu",
                use_adv_training=True, disc_cfg={"type": "nope"})
    with pytest.raises(ValueError, match="adversarial"):
        Trainer(reg, RegressorLosses(LOSS_CFG), device="cpu",
                use_adv_training=True, adv_loss_cfg={"type": "nope"})
    batch = {"images": np.zeros((1, 64, 64, 3), np.float32)}
    with pytest.raises(ValueError, match="real_body_pose"):
        trainer.fit({"train": [batch]}, 1)
    with pytest.raises(ValueError, match="train"):
        reg.train().apply(torch.zeros(1, 64, 64, 3))
