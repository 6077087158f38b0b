"""Parity of the port's eval backbone (K5's plain versions: ``conv2d_act``
and ``hr_fuse`` on CPU tensors) with the JAX package's HRNet-W48 layers,
BN folded.

Weights are made with a numpy seed on the port's modules and carried to
the JAX functions with ``io/from_jax.py``'s layout (OIHW <-> HWIO);
activations are NHWC on the JAX side and channels_last NCHW on the port's.
The JAX functions run eagerly, on the CPU.

Tolerances: single convs and the fusion 1e-5 absolute in f32 (the same
conv, summed in another order, then the same eager adds); the whole
backbone's features 1e-4 relative (~100 convs deep).
"""

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


def test_k5_backward_raises():
    """K5-conv and K5-fuse are forward only: the CUDA route runs each
    kernel through ``forward_only``, whose backward raises instead of
    returning a gradient (here around the plain versions, which that
    route launches in their place on the card); without a gradient needed
    no autograd node is made."""
    x = torch.randn(1, 8, 4, 4, requires_grad=True)
    w = torch.randn(8, 8, 3, 3)
    y = layers.forward_only("K5-conv", conv2d_act_plain, x, w, None, None,
                            True, 1)
    assert y.requires_grad
    with pytest.raises(NotImplementedError, match="K5-conv"):
        y.sum().backward()
    z = layers.forward_only("K5-fuse", lambda x, t: hr_fuse_plain(
        x, [(t, 1)]), x, x[:, :, ::2, ::2].contiguous())
    with pytest.raises(NotImplementedError, match="K5-fuse"):
        z.sum().backward()
    u = torch.randn(1, 8, 2, 2, requires_grad=True)  # a term needs it
    z = layers.forward_only("K5-fuse", lambda x, t: hr_fuse_plain(
        x, [(t, 1)]), x.detach(), u)
    with pytest.raises(NotImplementedError, match="K5-fuse"):
        z.sum().backward()
    with torch.no_grad():
        assert layers.forward_only("K5-conv", conv2d_act_plain, x, w, None,
                                   None, False, 1).grad_fn is None


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
    """In training the blocks run F.conv2d, train-mode BN and eager adds
    (K5 has no backward yet): a train forward makes no ``conv2d_act``
    call and its gradient reaches the first conv; an eval forward of the
    unfolded backbone (BN in eval mode) equals the folded one."""
    block = conv_bn(8, 16, 3, 2)
    _randomize_(block, seed=2)
    block.train()
    x = torch.randn(2, 8, 6, 6)
    mp = pytest.MonkeyPatch()

    def refuse(*a):
        raise AssertionError("conv2d_act in training")

    mp.setattr(layers, "conv2d_act", refuse)
    try:
        block(x).sum().backward()
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
