"""Parity of the port's backbone (K5's plain versions: ``conv2d_act`` and
``hr_fuse`` on CPU tensors, through the same autograd Functions as on the
card) with the JAX package's HRNet-W48 layers: the eval forward with BN
folded, and the VJPs of the convs and of the train-mode fusion.

Weights are made with a numpy seed on the port's modules and carried to
the JAX functions with ``io/from_jax.py``'s layout (OIHW <-> HWIO);
activations are NHWC on the JAX side and channels_last NCHW on the port's.
The JAX functions run eagerly, on the CPU.

Tolerances: single convs and the fusion 1e-5 absolute in f32 (the same
conv, summed in another order, then the same eager adds); the whole
backbone's features 1e-4 relative (~100 convs deep); VJPs rtol 1e-4, atol
1e-5 (oneDNN's and XLA's sums in other orders).
"""

import copy


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.models.backbones import hrnet as jhrnet
from shapy_tpu.models.backbones import layers as jlayers
from shapy_tpu_torch.models.backbones import hrnet, layers
from shapy_tpu_torch.models.backbones.hrnet import (
    HighResolutionModule,
    HRNet,
    hr_fuse,
    hr_fuse_plain,
)
from shapy_tpu_torch.models.backbones.layers import (
    conv2d_act,
    conv2d_act_plain,
    conv_bn,
    fold_bn_,
)
from shapy_tpu_torch.models.backbones.hrnet import hr_fuse_backward_plain

torch.set_num_threads(2)
CL = torch.channels_last


def _randomize_(module: torch.nn.Module, seed: int, gain: float = 1.0):
    """Seeded weights that keep activations O(1) through the blocks, and
    non-trivial BN statistics."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if t.dim() == 4:
                std = gain * np.sqrt(2.0 / np.prod(t.shape[1:]))
                if "fuse_layers" in name:
                    std *= 0.25
                if name.endswith("conv3.weight") or (
                        "branches" in name and name.endswith("conv2.weight")):
                    std *= 0.1
                v = rng.normal(size=t.shape) * std
            elif name.endswith("running_var"):
                v = rng.uniform(0.5, 2.0, size=t.shape)
            elif name.endswith("running_mean") or name.endswith(".bias"):
                v = rng.normal(size=t.shape) * 0.1
            else:  # BN gamma
                v = rng.uniform(0.5, 1.5, size=t.shape)
            t.copy_(torch.from_numpy(v.astype(np.float32)))


def _jax_params(module: torch.nn.Module, prefix: str = "") -> dict:
    """The module's state_dict as the JAX package's params (HWIO)."""
    out = {}
    for name, t in module.state_dict().items():
        a = t.numpy()
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        out[prefix + name] = jnp.asarray(a)
    return out


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous(
        memory_format=CL)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


EPILOGUES = {  # (BN folded into a bias, residual, ReLU)
    "plain": (False, False, False),
    "bias": (True, False, False),
    "bias-relu": (True, False, True),
    "bias-residual-relu": (True, True, True),
    "residual": (False, True, False),
}


@pytest.mark.parametrize("epilogue", list(EPILOGUES))
@pytest.mark.parametrize("cin", [3, 48])
@pytest.mark.parametrize("kernel,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_conv2d_act_plain_matches_jax(kernel, stride, cin, epilogue):
    """``conv2d_act_plain`` against JAX ``layers.conv2d`` (``fold_bn`` on
    when the epilogue has a bias; a 3x3 stride-2 conv also has its own
    bias, as the head's subsample convs), then the residual add and ReLU
    as ``basic_block`` does them."""
    has_bias, has_res, relu = EPILOGUES[epilogue]
    cout, size = 48, 9
    rng = np.random.default_rng(kernel * 100 + stride * 10 + cin)
    conv_bias = has_bias and kernel == 3 and stride == 2
    seq = conv_bn(cin, cout, kernel, stride, relu=False, bias=conv_bias)
    _randomize_(seq, seed=cin + kernel)
    jparams = _jax_params(seq, "c.")
    x = rng.normal(size=(2, size, size, cin)).astype(np.float32)
    out_size = (size + 2 * (kernel // 2) - kernel) // stride + 1
    res = rng.normal(size=(2, out_size, out_size, cout)).astype(np.float32)

    store = jlayers.ParamStore(
        {k.replace("c.0.", "conv.").replace("c.1.", "bn."): v
         for k, v in jparams.items()}, fold_bn=has_bias)
    want = jlayers.conv2d(store, "conv", jnp.asarray(x), cout, kernel,
                          stride, kernel // 2, bias=conv_bias,
                          fold_bn="bn" if has_bias else None)
    if has_res:
        want = want + jnp.asarray(res)
    if relu:
        want = jax.nn.relu(want)

    if has_bias:
        fold_bn_(seq)
    cmod = seq[0]
    got = conv2d_act_plain(_nchw(x), cmod.weight.detach(),
                           None if cmod.bias is None else cmod.bias.detach(),
                           _nchw(res) if has_res else None, relu, stride)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5,
                               rtol=0)
    # conv2d_act takes the plain version for CPU tensors.
    routed = conv2d_act(_nchw(x), cmod.weight.detach(),
                        None if cmod.bias is None else cmod.bias.detach(),
                        _nchw(res) if has_res else None, relu, stride)
    assert torch.equal(routed, got)


@pytest.mark.parametrize("stage", ["stage3", "stage4"])
def test_fusion_matches_jax(stage):
    """The fuse layers' convs (1x1 to coarser targets, stride-2 chains to
    finer ones) and ``hr_fuse_plain`` (eval ``HighResolutionModule.fuse``)
    against JAX ``_fuse`` with BN folded, at the W48 widths, 16^2 down to
    2^2, batch 2."""
    module = HighResolutionModule(stage)
    _randomize_(module, seed=3)
    jparams = _jax_params(module, f"{stage}.0.")
    channels = hrnet._branch_channels(stage)
    rng = np.random.default_rng(4)
    xs = [rng.normal(size=(2, 16 >> b, 16 >> b, c)).astype(np.float32)
          for b, c in enumerate(channels)]
    store = jlayers.ParamStore(jparams, fold_bn=True)
    want = jhrnet._fuse(store, f"{stage}.0.fuse_layers",
                        [jnp.asarray(x) for x in xs], channels, False, None)
    fold_bn_(module)
    module.eval()
    with torch.no_grad():
        got = module.fuse([_nchw(x) for x in xs])
    assert len(got) == len(want) == len(channels)
    for g, w in zip(got, want):
        assert g.is_contiguous(memory_format=CL)
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=1e-5,
                                   rtol=0)


def test_hr_fuse_plain_upsamples_nearest():
    """Term ``(t, s)`` is read at ``(h >> s, w >> s)``, as nn.Upsample's
    nearest mode writes it, and the sum is taken in the terms' order."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 8, 8, 8)).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(2, 8, 2, 2)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(2, 8, 8, 8)).astype(np.float32))
    want = torch.relu(x + torch.nn.Upsample(scale_factor=4)(u) + d)
    got = hr_fuse_plain(x, [(u, 2), (d, 0)])
    assert torch.equal(got, want)
    assert torch.equal(hr_fuse(x, [(u, 2), (d, 0)]), got)
    idx = torch.arange(8) >> 2
    assert torch.equal(got, torch.relu(x + u[:, :, idx][:, :, :, idx] + d))


def test_eval_backbone_matches_jax():
    """The eval backbone's features (BN folded, K5's plain versions)
    against ``hrnet_forward(..., train=False)`` (fold_bn) at 64^2, batch
    2; and one eval forward makes 331 ``conv2d_act`` and 26 ``hr_fuse``
    calls, the counts of K5-conv and K5-fuse launches on the card."""
    net = HRNet()
    _randomize_(net, seed=11)
    jparams = _jax_params(net)
    images = np.random.default_rng(12).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jhrnet.hrnet_forward(jparams, jnp.asarray(images),
                                           train=False)["concat"])
    fold_bn_(net)
    net.eval().to(memory_format=CL)
    calls = {"conv": 0, "fuse": 0}
    conv_plain, fuse_plain = layers.conv2d_act_plain, hrnet.hr_fuse_plain

    def counted_conv(*a):
        calls["conv"] += 1
        return conv_plain(*a)

    def counted_fuse(*a):
        calls["fuse"] += 1
        return fuse_plain(*a)

    mp = pytest.MonkeyPatch()
    mp.setattr(layers, "conv2d_act_plain", counted_conv)
    mp.setattr(hrnet, "hr_fuse_plain", counted_fuse)
    try:
        with torch.no_grad():
            got = net(_nchw(images)).numpy()
    finally:
        mp.undo()
    assert calls == {"conv": 331, "fuse": 26}
    assert np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_k5_cpu_route_is_differentiable():
    """On CPU tensors ``conv2d_act`` and ``hr_fuse`` are their plain
    versions, eager ops that autograd differentiates: the gradients equal
    those of ``F.conv2d`` + bias + residual + ReLU and of the upsample,
    adds and ReLU written out."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 8, 6, 6), generator=gen, requires_grad=True)
    w = torch.randn((8, 8, 3, 3), generator=gen, requires_grad=True)
    b = torch.randn(8, generator=gen, requires_grad=True)
    r = torch.randn((2, 8, 6, 6), generator=gen, requires_grad=True)
    u = torch.randn((2, 8, 3, 3), generator=gen, requires_grad=True)
    g = torch.randn((2, 8, 6, 6), generator=gen)
    leaves = (x, w, b, r, u)
    got = torch.autograd.grad(
        (g * hr_fuse(conv2d_act(x, w, b, r, True), [(u, 1)])).sum(), leaves)
    y = torch.relu(torch.nn.functional.conv2d(x, w, b, 1, 1) + r)
    up = u.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    want = torch.autograd.grad((g * torch.relu(y + up)).sum(), leaves)
    for a, e in zip(got, want):
        assert torch.allclose(a, e, rtol=1e-5, atol=1e-5)


def test_train_mode_keeps_the_unfused_path():
    """In training the blocks run ``conv2d_act`` (K5-conv and its VJP on
    the card) without an epilogue, then train-mode BN and eager adds, and
    the fusion runs ``hr_fuse`` (K5-fuse and its VJP): a train forward
    calls both, and its gradient reaches the first conv; an eval forward
    of the unfolded backbone (BN in eval mode) equals the folded one."""
    block = conv_bn(8, 16, 3, 2)
    _randomize_(block, seed=2)
    block.train()
    x = torch.randn(2, 8, 6, 6)
    calls = {"conv": 0, "fuse": 0}
    conv_fn, fuse_fn = layers.conv2d_act, hrnet.hr_fuse

    def conv(x, w, bias=None, residual=None, relu=False, stride=1):
        assert residual is None and not relu  # BN follows in training
        calls["conv"] += 1
        return conv_fn(x, w, bias, residual, relu, stride)

    def fuse(x, terms):
        calls["fuse"] += 1
        return fuse_fn(x, terms)

    mp = pytest.MonkeyPatch()
    mp.setattr(layers, "conv2d_act", conv)
    mp.setattr(hrnet, "hr_fuse", fuse)
    try:
        block(x).sum().backward()
        assert calls == {"conv": 1, "fuse": 0}
        module = HighResolutionModule("stage2").train()
        xs = [torch.randn(2, c, 8 >> b, 8 >> b).contiguous(memory_format=CL)
              for b, c in enumerate(hrnet._branch_channels("stage2"))]
        module(xs)
        # 2 branches x 4 blocks x 2 convs, 2 fuse convs; 2 targets
        assert calls == {"conv": 1 + 18, "fuse": 2}
    finally:
        mp.undo()
    assert block[0].weight.grad is not None
    block.eval()
    with torch.no_grad():
        unfolded = block(x)
        fold_bn_(block)
        folded = block(x)
    assert isinstance(block[1], torch.nn.Identity)
    torch.testing.assert_close(folded, unfolded, rtol=1e-5, atol=1e-5)


VJP_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("epilogue", ["none", "bias-residual-relu"])
@pytest.mark.parametrize("cin", [3, 48])
@pytest.mark.parametrize("kernel,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_conv2d_act_vjp_matches_jax(kernel, stride, cin, epilogue):
    """The VJP of ``conv2d_act`` (its autograd Function with the plain
    versions, K5-dgrad's and K5-wgrad's oracles) against ``jax.vjp`` of
    the JAX ``conv2d`` (with its own bias) + residual + ReLU, f32, batch
    2 at 9^2: dx, dw, dresidual rtol 1e-4 / atol 1e-5; dbias, a sum over
    (N, H, W) that may cancel, within 1e-5 of sum |dy (y > 0)|."""
    full = epilogue != "none"
    cout, size = 48, 9
    rng = np.random.default_rng(kernel * 100 + stride * 10 + cin)
    out = (size + 2 * (kernel // 2) - kernel) // stride + 1
    x = rng.normal(size=(2, size, size, cin)).astype(np.float32)
    w = (rng.normal(size=(kernel, kernel, cin, cout))
         / np.sqrt(kernel * kernel * cin)).astype(np.float32)
    b = rng.normal(size=cout).astype(np.float32) * 0.3
    res = rng.normal(size=(2, out, out, cout)).astype(np.float32)
    dy = rng.normal(size=(2, out, out, cout)).astype(np.float32)

    def run(x, w, b, res):
        store = jlayers.ParamStore({"c.weight": w, "c.bias": b})
        y = jlayers.conv2d(store, "c", x, cout, kernel, stride, kernel // 2,
                           bias=full)
        return jax.nn.relu(y + res) if full else y

    want, vjp = jax.vjp(run, *map(jnp.asarray, (x, w, b, res)))
    want_grads = vjp(jnp.asarray(dy))

    xt = _nchw(x).requires_grad_()
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).contiguous(
        memory_format=CL).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    rt = _nchw(res).requires_grad_()
    y = conv2d_act(xt, wt, bt if full else None, rt if full else None, full,
                   stride)
    assert y.grad_fn is not None
    np.testing.assert_allclose(_nhwc(y.detach()), np.asarray(want),
                               **VJP_TOL)
    y.backward(_nchw(dy))
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(want_grads[0]),
                               **VJP_TOL)
    np.testing.assert_allclose(wt.grad.numpy().transpose(2, 3, 1, 0),
                               np.asarray(want_grads[1]), **VJP_TOL)
    if not full:
        assert bt.grad is None and rt.grad is None
        return
    masked = np.where(np.asarray(want) > 0, dy, 0.0)
    np.testing.assert_allclose(_nhwc(rt.grad), masked, rtol=0, atol=0)
    db_err = np.abs(bt.grad.numpy() - np.asarray(want_grads[2])).max()
    assert db_err <= 1e-5 * np.abs(masked).sum()


def test_fusion_train_vjp_matches_jax():
    """Stage 3's train-mode fusion (the fuse convs through ``conv2d_act``,
    K4's plain BN, ``hr_fuse``) against ``jax.vjp`` of the JAX
    ``_fuse(train=True)`` at the W48 widths, 16^2 down to 4^2, batch 2:
    outputs and running stats rtol 1e-4 / atol 1e-5; the gradients of the
    inputs and of every fuse parameter rtol 1e-4 / atol 1e-5 of each
    tensor's largest |value| (they pass through BN's backward, whose
    mean-subtracted sums cancel to well below their terms)."""
    module = HighResolutionModule("stage3")
    _randomize_(module, seed=13)
    jparams = _jax_params(module, "stage3.0.")
    channels = hrnet._branch_channels("stage3")
    rng = np.random.default_rng(14)
    xs = [rng.normal(size=(2, 16 >> b, 16 >> b, c)).astype(np.float32)
          for b, c in enumerate(channels)]
    outs = [rng.normal(size=x.shape).astype(np.float32) for x in xs]
    fuse_params = {k: v for k, v in jparams.items() if "fuse_layers" in k}
    trainable = {k: v for k, v in fuse_params.items() if "running" not in k}

    def run(xs, tp):
        store = jlayers.ParamStore({**jparams, **tp})
        ys = jhrnet._fuse(store, "stage3.0.fuse_layers", xs, channels, True,
                          None)
        return ys, store.stat_updates

    (want, stats), vjp = jax.vjp(run, [jnp.asarray(x) for x in xs],
                                 trainable)
    want_dxs, want_dp = vjp(([jnp.asarray(o) for o in outs],
                             jax.tree_util.tree_map(jnp.zeros_like, stats)))

    module.train()
    xt = [_nchw(x).requires_grad_() for x in xs]
    got = module.fuse(xt)
    torch.autograd.backward(got, [_nchw(o) for o in outs])
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g.detach()), np.asarray(w),
                                   **VJP_TOL)
    def close(got, want, name):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)

    for i, (g, w) in enumerate(zip(xt, want_dxs)):
        close(_nhwc(g.grad), np.asarray(w), f"x{i}")
    params = dict(module.named_parameters())
    assert len(want_dp) == sum("fuse_layers" in k for k in params)
    for name, g in want_dp.items():
        g = np.asarray(g)
        if g.ndim == 4:
            g = g.transpose(3, 2, 0, 1)
        close(params[name[len("stage3.0."):]].grad.numpy(), g, name)
    buffers = dict(module.named_buffers())
    assert stats
    for name, v in stats.items():
        np.testing.assert_allclose(buffers[name[len("stage3.0."):]],
                                   np.asarray(v), err_msg=name, **VJP_TOL)


def test_hr_fuse_backward_plain_is_the_vjp():
    """``hr_fuse_backward_plain`` (the box sums of the masked cotangent)
    equals autograd through ``hr_fuse_plain`` (upsample, adds, ReLU) in
    f64, for shifts 0-3."""
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((2, 8, 16, 16), generator=gen, dtype=torch.float64)
    ts = [torch.randn((2, 8, 16 >> s, 16 >> s), generator=gen,
                      dtype=torch.float64, requires_grad=True)
          for s in (1, 2, 3, 0)]
    x.requires_grad_()
    terms = list(zip(ts, (1, 2, 3, 0)))
    y = hr_fuse_plain(x, terms)
    dy = torch.randn(y.shape, generator=gen, dtype=torch.float64)
    want = torch.autograd.grad(y, [x] + ts, dy)
    dx, grads = hr_fuse_backward_plain(dy, y.detach(), (1, 2, 3, 0))
    for got, ref in zip([dx] + grads, want):
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


def test_train_backbone_gradient_matches_eager_autograd():
    """The whole W48 backbone in train mode at 64^2, batch 2, through the
    Function route (``conv2d_act`` / ``hr_fuse`` with their VJPs) against
    autograd of ``F.conv2d`` + eager adds and ``F.interpolate`` written out
    (the plain versions called directly): features, every parameter's
    gradient within 1e-5 of its tensor's largest, and the running stats;
    331 / 26 calls per forward."""
    net = HRNet()
    _randomize_(net, seed=17)
    net.train().to(memory_format=CL)
    ref = copy.deepcopy(net)
    images = torch.from_numpy(np.random.default_rng(18).normal(
        size=(2, 3, 64, 64)).astype(np.float32)).contiguous(memory_format=CL)
    g = torch.from_numpy(np.random.default_rng(19).normal(
        size=(2, 2048)).astype(np.float32))
    calls = {"conv": 0, "fuse": 0}
    conv_fn, fuse_fn = layers.conv2d_act, hrnet.hr_fuse

    def counted_conv(*a, **k):
        calls["conv"] += 1
        return conv_fn(*a, **k)

    def counted_fuse(*a):
        calls["fuse"] += 1
        return fuse_fn(*a)

    mp = pytest.MonkeyPatch()
    mp.setattr(layers, "conv2d_act", counted_conv)
    mp.setattr(hrnet, "hr_fuse", counted_fuse)
    try:
        feat = net(images)
        (feat * g).sum().backward()
    finally:
        mp.undo()
    assert calls == {"conv": 331, "fuse": 26}
    mp.setattr(layers, "conv2d_act", conv2d_act_plain)
    mp.setattr(hrnet, "hr_fuse", hr_fuse_plain)
    try:
        want = ref(images)
        (want * g).sum().backward()
    finally:
        mp.undo()
    torch.testing.assert_close(feat, want, rtol=1e-5, atol=1e-6)
    refs = dict(ref.named_parameters())
    for name, p in net.named_parameters():
        w = refs[name].grad
        assert p.grad is not None, name
        err = float((p.grad - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (name, err)
    refb = dict(ref.named_buffers())
    for name, b in net.named_buffers():
        torch.testing.assert_close(b, refb[name], rtol=1e-6, atol=1e-7)
