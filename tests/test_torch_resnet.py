"""Parity of the port's ResNet path with the JAX package's, on the CPU
(the kernels' plain versions): the 3x3 / stride-2 max pool (K11's plain
versions) against ``jax.lax.reduce_window`` and its VJP, the 7x7 stem
conv (K10's oracle) against ``layers.conv2d`` and its VJP, the eval
ResNet-18 / ResNet-50 (BN folded) against ``resnet_forward``, the
regressor's whole slice on ResNet-18 against the JAX ``SMPLXRegressor``,
the weights' carriage (``io/from_jax``, ``import_resnet_state_dict``),
and the regressor's config keys (ROADMAP F9).

Seeded numpy inputs and weights go to both sides; the JAX functions run
eagerly on the CPU. Tolerances: the max pool exact (the same maxima, the
same ties, the same f32 sums in the same order); the stem 1e-5 absolute
(one conv summed in another order); the backbones' features rel 1e-4 of
the largest (~50 convs deep, as HRNet's test); the slice as
``test_torch_regressor.py``.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.data.crop import crop_to_image_affine
from shapy_tpu.measure import BodyMeasurements as JBodyMeasurements
from shapy_tpu.measure import MeasurementAnchors as JAnchors
from shapy_tpu.models.backbones import layers as jlayers
from shapy_tpu.models.backbones import resnet as jresnet
from shapy_tpu.models.body import SMPLX as JSMPLX
from shapy_tpu.models.heads import SMPLXRegressor as JRegressor
from shapy_tpu_torch.flagship import (
    FLAGSHIP_BODY_CFG,
    FLAGSHIP_NETWORK_CFG,
    backbone_cfg,
    build_flagship,
)
from shapy_tpu_torch.io.from_jax import (
    load_regressor_from_jax,
    state_dict_from_jax,
)
from shapy_tpu_torch.measure.measurements import (
    BodyMeasurements,
    MeasurementAnchors,
    candidate_faces,
)
from shapy_tpu_torch.models.backbones import layers
from shapy_tpu_torch.models.backbones.layers import (
    BatchNorm2d,
    conv2d_act,
    fold_bn_,
    max_pool2d,
    max_pool2d_backward_plain,
    max_pool2d_plain,
)
from shapy_tpu_torch.models.backbones.resnet import (
    RESNET_FEAT_DIM,
    RESNET_LAYERS,
    ResNet,
    import_resnet_state_dict,
)
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
from shapy_tpu_torch.models.body.model import SMPLX
from shapy_tpu_torch.models.heads.regressor import SMPLXRegressor
from shapy_tpu_torch.utils import yaml_subset
from tests.test_torch_backbone import _jax_params, _nchw, _nhwc, _randomize_
from tests.test_torch_regressor import _perturbed_params

torch.set_num_threads(2)
SIZE = 64
ASSETS = Path(__file__).resolve().parents[1] / "assets" / "measurements"


def _jax_pool(x):
    return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                 (1, 2, 2, 1),
                                 [(0, 0), (1, 1), (1, 1), (0, 0)])


# -- K11: the max pool --------------------------------------------------------

@pytest.mark.parametrize("side", [(8, 8), (9, 7), (5, 10), (1, 3)])
def test_max_pool2d_plain_matches_jax(side):
    """Forward and VJP against ``reduce_window`` max and ``jax.vjp``,
    bit-equal in f32, on small integers (ties in most windows), an
    all-zero corner (whole windows of zeros, as after the stem's ReLU), a
    tie planted across the overlap of two windows, even and odd sides;
    ``max_pool2d`` on CPU tensors (its autograd Function) gives the same
    output and gradient."""
    H, W = side
    rng = np.random.default_rng(H * 10 + W)
    x = rng.integers(-2, 3, size=(2, H, W, 8)).astype(np.float32)
    x[0, :5, :5] = 0.0
    x[1, :3, :3] = 4.0  # a tie that two windows share
    Ho, Wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    dy = rng.normal(size=(2, Ho, Wo, 8)).astype(np.float32)
    want, vjp = jax.vjp(_jax_pool, jnp.asarray(x))
    want_dx = np.asarray(vjp(jnp.asarray(dy))[0])

    xt, dyt = _nchw(x), _nchw(dy)
    got = max_pool2d_plain(xt)
    assert got.shape == (2, 8, Ho, Wo)
    assert np.array_equal(_nhwc(got), np.asarray(want))
    dx = max_pool2d_backward_plain(dyt, xt)
    assert np.array_equal(_nhwc(dx), want_dx)
    assert (want_dx != 0).any()

    xr = xt.clone().requires_grad_()
    y = max_pool2d(xr)
    assert y.grad_fn is not None and torch.equal(y, got)
    y.backward(dyt)
    assert torch.equal(xr.grad, dx)


def test_max_pool2d_backward_plain_rounds_once_in_bf16():
    """bf16: the contributions are summed in f32 and rounded once, equal
    to the f32 sums rounded (the card's K11 backward is held to this)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 3, size=(2, 8, 9, 9)).astype(
        np.float32))
    dy = torch.from_numpy(rng.normal(size=(2, 8, 5, 5)).astype(np.float32))
    got = max_pool2d_backward_plain(dy.bfloat16(), x.bfloat16())
    want = max_pool2d_backward_plain(dy.bfloat16().float(), x)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())


# -- K10: the 7x7 stem --------------------------------------------------------

@pytest.mark.parametrize("epilogue", ["none", "bias-relu"])
def test_stem_conv_matches_jax(epilogue):
    """The 7x7 / stride-2 / pad-3 conv on 3 channels (``conv2d_act``, the
    plain versions through its autograd Function) against JAX
    ``layers.conv2d`` (with a bias) + ReLU and ``jax.vjp``: output and dw
    within 1e-5 absolute (both O(1)), dbias within 1e-5 of sum |dy (y >
    0)|. The images take no gradient."""
    full = epilogue != "none"
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 17, 15, 3)).astype(np.float32)
    w = (rng.normal(size=(7, 7, 3, 16)) / np.sqrt(147)).astype(np.float32)
    b = (rng.normal(size=16) * 0.3).astype(np.float32)
    # dy / sqrt(N Ho Wo): dw, a sum of 144 products, is O(1) as y is.
    dy = (rng.normal(size=(2, 9, 8, 16)) / 12.0).astype(np.float32)

    def run(w, b):
        store = jlayers.ParamStore({"c.weight": w, "c.bias": b})
        y = jlayers.conv2d(store, "c", jnp.asarray(x), 16, 7, 2, 3,
                           bias=full)
        return jax.nn.relu(y) if full else y

    want, vjp = jax.vjp(run, jnp.asarray(w), jnp.asarray(b))
    want_dw, want_db = vjp(jnp.asarray(dy))

    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = conv2d_act(_nchw(x), wt, bt if full else None, None, full, 2)
    assert y.shape == (2, 16, 9, 8)
    np.testing.assert_allclose(_nhwc(y.detach()), np.asarray(want),
                               atol=1e-5, rtol=0)
    y.backward(_nchw(dy))
    np.testing.assert_allclose(wt.grad.numpy().transpose(2, 3, 1, 0),
                               np.asarray(want_dw), atol=1e-5, rtol=0)
    if full:
        masked = np.where(np.asarray(want) > 0, dy, 0.0)
        assert np.abs(bt.grad.numpy() - np.asarray(want_db)).max() <= (
            1e-5 * np.abs(masked).sum())


def _stem_runs(n: int, ho: int, wo: int, p: int, per: int):
    """The (image, output row, first pixel, last pixel + 1) of the runs
    partition p of ``stem7_wgrad_kernel`` sums, in its order."""
    wruns = -(-wo // layers._STEM_RUN)
    for run in range(p * per, min(n * ho * wruns, (p + 1) * per)):
        w0 = run % wruns * layers._STEM_RUN
        yield (run // wruns // ho, run // wruns % ho, w0,
               min(wo, w0 + layers._STEM_RUN))


@pytest.mark.parametrize("n,side", [(48, 256), (3, 300), (4, 64), (1, 7),
                                    (2, 255)],
                         ids=["resnet-b48", "wo150", "wo32", "wo4", "wo128"])
def test_stem_wgrad_parts_cover_every_pixel_once(n, side):
    """K10's weight-gradient partitions (``_stem_wgrad_parts``): runs of
    at most 128 output pixels of one row, consecutive runs a partition,
    every output pixel in one run of one partition, at most
    ``_STEM_WGRAD_PARTS`` partitions and none empty; from the shape alone
    (the cache holds what the function gives)."""
    ho = wo = (side - 1) // 2 + 1
    parts, per = layers._stem_wgrad_parts(n, ho, wo)
    assert (parts, per) == layers._stem_wgrad_parts.__wrapped__(n, ho, wo)
    assert 1 <= parts <= layers._STEM_WGRAD_PARTS
    seen = np.zeros((n, ho, wo), dtype=int)
    for p in range(parts):
        runs = list(_stem_runs(n, ho, wo, p, per))
        assert runs
        for i, h, w0, w1 in runs:
            assert 0 < w1 - w0 <= layers._STEM_RUN
            seen[i, h, w0:w1] += 1
    assert (seen == 1).all()


def stem_wgrad_replay(x, dy, parts, per, bias: bool):
    """``stem7_wgrad_kernel``'s sums, f32 NCHW x (N, 3, H, W) and dy (N,
    64, Ho, Wo): per partition in order its runs in order, each run's
    16-pixel steps in order (one product of dy^T and the steps' im2col
    columns, K in the OHWI weight's order, a column of ones for dbias);
    then the partitions in order. Returns (dw (Cout, 7, 7, 3), dbias)."""
    N, _, Ho, Wo = dy.shape
    xp = torch.nn.functional.pad(x, (3, 3, 3, 3))
    cols = xp.unfold(2, 7, 2).unfold(3, 7, 2)[:, :, :Ho, :Wo]
    cols = cols.permute(0, 2, 3, 4, 5, 1).reshape(N, Ho, Wo, 147)
    cols = torch.cat([cols, torch.ones(N, Ho, Wo, 1)], dim=-1)
    d = dy.permute(0, 2, 3, 1)
    total = torch.zeros(dy.shape[1], 148)
    for p in range(parts):
        acc = torch.zeros_like(total)
        for i, h, w0, w1 in _stem_runs(N, Ho, Wo, p, per):
            for k in range(w0, w1, 16):
                k1 = min(w1, k + 16)
                acc = acc + d[i, h, k:k1].T @ cols[i, h, k:k1]
        total = total + acc
    dw = total[:, :147].reshape(-1, 7, 7, 3)
    return dw, (total[:, 147] if bias else None)


@pytest.mark.parametrize("epilogue", ["none", "bias-relu"])
def test_stem_wgrad_replay_matches_jax(epilogue, monkeypatch):
    """The replay of K10's weight-gradient sum order at a ragged width
    (Wo 150: a row in two runs, the second of 22 pixels) and 5 partitions
    of consecutive runs, against ``jax.vjp`` of JAX ``layers.conv2d`` (7x7
    / stride 2 / pad 3, with a bias and the ReLU, or bare): dw within 1e-5
    absolute (O(1), as ``test_stem_conv_matches_jax`` holds it), dbias
    within 1e-5 of sum |dy (y > 0)|."""
    full = epilogue != "none"
    monkeypatch.setattr(layers, "_STEM_WGRAD_PARTS", 5)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 11, 300, 3)).astype(np.float32)
    w = (rng.normal(size=(7, 7, 3, 64)) / np.sqrt(147)).astype(np.float32)
    b = (rng.normal(size=64) * 0.3).astype(np.float32)
    N, Ho, Wo = 2, 6, 150
    dy = (rng.normal(size=(N, Ho, Wo, 64)) / np.sqrt(N * Ho * Wo)).astype(
        np.float32)

    def run(w, b):
        store = jlayers.ParamStore({"c.weight": w, "c.bias": b})
        y = jlayers.conv2d(store, "c", jnp.asarray(x), 64, 7, 2, 3,
                           bias=full)
        return jax.nn.relu(y) if full else y

    want, vjp = jax.vjp(run, jnp.asarray(w), jnp.asarray(b))
    want_dw, want_db = vjp(jnp.asarray(dy))
    g = np.where(np.asarray(want) > 0, dy, 0.0) if full else dy
    parts, per = layers._stem_wgrad_parts.__wrapped__(N, Ho, Wo)
    assert (parts, per) == (5, 5)
    dw, db = stem_wgrad_replay(_nchw(x), _nchw(g.astype(np.float32)), parts,
                               per, full)
    np.testing.assert_allclose(dw.numpy().transpose(1, 2, 3, 0),
                               np.asarray(want_dw), atol=1e-5, rtol=0)
    if full:
        assert np.abs(db.numpy() - np.asarray(want_db)).max() <= (
            1e-5 * np.abs(g).sum())


def test_conv2d_act_takes_7x7_only_on_the_images():
    x = torch.zeros((1, 8, 16, 16))
    with pytest.raises(ValueError, match="7x7"):
        conv2d_act(x, torch.zeros((8, 8, 7, 7)))
    with pytest.raises(ValueError, match="7x7"):
        conv2d_act(torch.zeros((1, 3, 16, 16)), torch.zeros((8, 3, 7, 7)),
                   residual=torch.zeros((1, 8, 16, 16)))


# -- the backbone -------------------------------------------------------------

@pytest.mark.parametrize("depth", [18, 50])
def test_eval_resnet_matches_jax(depth):
    """The eval ResNet (BN folded, every BN of it: none is left) against
    ``resnet_forward(train=False)`` (fold_bn) at 64^2, batch 2: every
    stage's map and ``avg_pooling`` within 1e-4 of the largest; one
    forward makes 53 (ResNet-50) or 20 (ResNet-18) ``conv2d_act`` calls
    and one max pool, the counts of K5-conv + K10 and K11 launches on the
    card."""
    net = ResNet(depth)
    _randomize_(net, seed=depth)
    jparams = _jax_params(net)
    images = np.random.default_rng(depth + 1).normal(
        size=(2, SIZE, SIZE, 3)).astype(np.float32)
    want = jresnet.resnet_forward(jparams, jnp.asarray(images), depth,
                                  train=False)
    fold_bn_(net)
    assert not any(isinstance(m, BatchNorm2d) for m in net.modules())
    net.eval().to(memory_format=torch.channels_last)
    calls = {"conv": 0, "pool": 0}
    conv_plain, pool_plain = layers.conv2d_act_plain, layers.max_pool2d_plain

    def counted_conv(*a):
        calls["conv"] += 1
        return conv_plain(*a)

    def counted_pool(*a):
        calls["pool"] += 1
        return pool_plain(*a)

    mp = pytest.MonkeyPatch()
    mp.setattr(layers, "conv2d_act_plain", counted_conv)
    mp.setattr(layers, "max_pool2d_plain", counted_pool)
    try:
        with torch.no_grad():
            got = net(_nchw(images))
    finally:
        mp.undo()
    kind, blocks = RESNET_LAYERS[depth]
    per_block = 2 if kind == "basic" else 3
    assert calls == {"conv": 1 + per_block * sum(blocks) + 3
                     + (kind == "bottleneck"), "pool": 1}
    assert calls["conv"] == {18: 20, 50: 53}[depth]
    assert got["avg_pooling"].shape == (2, RESNET_FEAT_DIM[depth])
    for key in ("layer1", "layer2", "layer3", "layer4", "avg_pooling"):
        w = np.asarray(want[key])
        g = got[key].numpy()
        if g.ndim == 4:
            g = _nhwc(got[key])
        assert np.abs(w).max() > 1e-3, key
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), key
    assert torch.equal(got["concat"], got["avg_pooling"])


def test_resnet_keys_and_torchvision_import():
    """The port's keys are the JAX package's param names; a torchvision
    ``state_dict`` (with ``fc.*`` and ``num_batches_tracked``) loads
    through ``import_resnet_state_dict`` exactly as the JAX package's
    ``import_resnet_state_dict`` converts it; a dict that lacks keys
    raises."""
    jparams = jresnet.resnet_init(18, seed=0)
    net = ResNet(18)
    assert set(net.state_dict()) == set(jparams)
    _randomize_(net, seed=4)
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    sd["fc.weight"] = torch.zeros(1000, 512)
    sd["fc.bias"] = torch.zeros(1000)
    sd["bn1.num_batches_tracked"] = torch.tensor(7)
    fresh = import_resnet_state_dict(ResNet(18), sd)
    for k, v in net.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    converted = jresnet.import_resnet_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    back = state_dict_from_jax(converted)
    assert set(back) == set(net.state_dict())
    for k, v in back.items():
        assert torch.equal(v, net.state_dict()[k]), k
    with pytest.raises(RuntimeError):
        import_resnet_state_dict(ResNet(18), {"conv1.weight": sd[
            "conv1.weight"]})


# -- the regressor ------------------------------------------------------------

def _tiny_regressor(cfg_backbone, **network):
    model = SMPLX(make_synthetic_model_data("smplx", subdivisions=1, seed=0))
    return SMPLXRegressor(model, None, FLAGSHIP_BODY_CFG, dict(
        FLAGSHIP_NETWORK_CFG, mlp={"layers": [8]}, backbone=cfg_backbone,
        **network))


@pytest.mark.parametrize("depth", sorted(RESNET_LAYERS))
def test_regressor_runs_every_resnet_depth(depth):
    """``backbone: {type: resnet, depth: d}`` builds the ResNet of that
    depth and its features feed the head: an eval forward at 64^2."""
    reg = _tiny_regressor({"type": "resnet", "depth": depth})
    assert isinstance(reg.backbone, ResNet) and reg.backbone.depth == depth
    assert reg.feat_dim == RESNET_FEAT_DIM[depth]
    assert reg.head.layer_000[0].in_features == (
        RESNET_FEAT_DIM[depth] + reg.param_dim)
    reg.prepare_for_eval_()
    with torch.inference_mode():
        out = reg.apply(torch.zeros((1, SIZE, SIZE, 3)))
    assert out["features"].shape == (1, RESNET_FEAT_DIM[depth])
    assert torch.isfinite(out["stage_02"]["vertices"]).all()


@pytest.fixture(scope="module")
def resnet_slice():
    """The whole slice on ResNet-18 at 64^2, batch 2, both sides from the
    same perturbed params (as ``test_torch_regressor.py`` on HRNet)."""
    cfg = dict(FLAGSHIP_NETWORK_CFG, mlp={"layers": [64, 64],
                                          "dropout": 0.5},
               backbone=backbone_cfg("resnet18"))
    data = make_synthetic_model_data("smplx", subdivisions=2, seed=0)
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
    params = _perturbed_params(jreg.params, jreg.param_slices, seed=5)
    model = SMPLX(data)
    reg = SMPLXRegressor(model, BodyMeasurements(anchors, model.faces, 256,
                                                 face_subsets=subsets),
                         FLAGSHIP_BODY_CFG, cfg)
    keys = set(reg.backbone.state_dict())
    load_regressor_from_jax(reg, params)
    loaded = {k: v.clone() for k, v in reg.state_dict().items()}
    reg.prepare_for_eval_()
    rng = np.random.default_rng(6)
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
    return {"got": got, "want": want, "keys": keys, "jparams": jreg.params,
            "params": params, "loaded": loaded}


def test_resnet_from_jax_round_trip(resnet_slice):
    """The JAX ResNet regressor's params land on the port's keys through
    ``load_regressor_from_jax`` (convs HWIO -> OIHW, the rest as they
    are), every backbone key once."""
    s = resnet_slice
    assert s["keys"] == set(s["jparams"]["backbone"])
    for name, value in s["params"]["backbone"].items():
        got = s["loaded"][f"backbone.{name}"].numpy()
        want = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value
        assert np.array_equal(got, want), name


def test_resnet_slice_matches_jax(resnet_slice):
    """Features, betas, the last stage's meshes, the projection and the
    measurements, at ``test_torch_regressor.py``'s tolerances."""
    got, want = resnet_slice["got"], resnet_slice["want"]
    np.testing.assert_allclose(got["features"].numpy(),
                               np.asarray(want["features"]), rtol=1e-4,
                               atol=1e-4)
    last, jlast = got["stage_02"], want["stage_02"]
    betas = last["betas"].numpy()
    assert np.abs(betas[0] - betas[1]).max() > 1e-3  # image-dependent
    np.testing.assert_allclose(betas, np.asarray(jlast["betas"]), rtol=1e-4,
                               atol=1e-5)
    for key in ("vertices", "joints", "v_shaped"):
        np.testing.assert_allclose(last[key].numpy(), np.asarray(jlast[key]),
                                   atol=1e-5, err_msg=key)
    np.testing.assert_allclose(got["proj_joints"].numpy(),
                               np.asarray(want["proj_joints"]), atol=1e-5)
    for k, v in got["measurements"].items():
        np.testing.assert_allclose(v.numpy(),
                                   np.asarray(want["measurements"][k]),
                                   rtol=1e-4, err_msg=k)


def test_build_flagship_backbones():
    reg = build_flagship(subdivisions=1, mlp_layers=(8,), device="cpu",
                         backbone="resnet18")
    assert isinstance(reg.backbone, ResNet) and reg.feat_dim == 512
    assert backbone_cfg("hrnet") == {"type": "hrnet"}
    assert backbone_cfg("resnet50") == {"type": "resnet", "depth": 50}
    with pytest.raises(ValueError, match="backbone"):
        backbone_cfg("vgg16")


# -- F9: the config keys the JAX regressor honours ----------------------------

NET_CFG = dict(FLAGSHIP_NETWORK_CFG, mlp={"layers": [8]},
               backbone=backbone_cfg("resnet18"))

@pytest.mark.parametrize("where", ["backbone", "backbone.hrnet"])
def test_regressor_refuses_use_old_impl(where):
    cfg = ({"type": "hrnet", "use_old_impl": True} if where == "backbone"
           else {"type": "hrnet", "hrnet": {"use_old_impl": True}})
    with pytest.raises(ValueError, match="use_old_impl"):
        _tiny_regressor(cfg)


def test_regressor_refuses_other_backbones():
    with pytest.raises(ValueError, match="backbone"):
        _tiny_regressor({"type": "vgg"})


def test_regressor_compute_measurements_builds_them(tmp_path):
    """``compute_measurements: true`` without measurements builds
    ``BodyMeasurements`` from ``meas_definition_path`` /
    ``meas_vertices_path`` for the body model's type, as the JAX
    regressor does: the same anchors as the JAX package reads from those
    files (the vertex file here is the reference's, its face ids taken
    modulo the small synthetic mesh's faces)."""
    model = SMPLX(make_synthetic_model_data("smplx", subdivisions=1, seed=0))
    F = len(model.faces)
    verts = yaml_subset.load(f"{ASSETS}/smplx_measurements.yaml")
    lines = []
    for name, d in verts.items():
        lines += [f"{name}:", f"  face_idx: {int(d['face_idx']) % F}",
                  "  bc:", *(f"  - {float(v)}" for v in d["bc"])]
    path = tmp_path / "vertices.yaml"
    path.write_text("\n".join(lines) + "\n")
    defs = f"{ASSETS}/measurement_defitions.yaml"
    reg = SMPLXRegressor(model, None, FLAGSHIP_BODY_CFG, dict(
        NET_CFG, compute_measurements=True, meas_definition_path=defs,
        meas_vertices_path=str(path)))
    assert isinstance(reg.body_measurements, BodyMeasurements)
    want = JAnchors.from_yaml(defs, str(path), "smplx")
    got = reg.body_measurements.anchors
    names = ("head_top", "left_heel", "chest", "waist", "hips")
    for a, b in zip(got.ordered(), (getattr(want, n) for n in names)):
        assert a.face_idx == b.face_idx
        np.testing.assert_allclose(a.bary, b.bary)
    assert SMPLXRegressor(model, None, FLAGSHIP_BODY_CFG,
                          NET_CFG).body_measurements is None


@pytest.mark.parametrize("key", ["mean_pose_path", "shape_mean_path"])
def test_regressor_refuses_mean_files(key, tmp_path):
    """A ``mean_pose_path`` / ``shape_mean_path`` that names no file is
    ignored, as the JAX regressor ignores it; one that names a file is
    read into ``param_mean`` (the body pose's or the betas' slice). The
    name dates from when a present file was refused; it is kept so that
    the test's record carries on across the change."""
    import pickle

    model = SMPLX(make_synthetic_model_data("smplx", subdivisions=1, seed=0))
    body = {"smplx": dict(FLAGSHIP_BODY_CFG["smplx"],
                          **{key: str(tmp_path / "missing.pkl")})}
    default = SMPLXRegressor(model, None, body, NET_CFG).param_mean
    rng = np.random.default_rng(3)
    if key == "shape_mean_path":
        mean = rng.normal(size=10).astype(np.float32)
        present, space = tmp_path / "mean.npy", "betas"
        np.save(present, mean)
    else:
        mean = rng.normal(size=21 * 6).astype(np.float32)
        present, space = tmp_path / "mean.pkl", "body_pose"
        with open(present, "wb") as f:
            pickle.dump({"body_pose": {"cont_rot_repr": mean}}, f)
    body["smplx"][key] = str(present)
    reg = SMPLXRegressor(model, None, body, NET_CFG)
    sl = reg.param_slices[space]
    np.testing.assert_array_equal(reg.param_mean[0, sl].numpy(), mean)
    rest = torch.ones(reg.param_dim, dtype=torch.bool)
    rest[sl] = False
    assert torch.equal(reg.param_mean[0, rest], default[0, rest])
