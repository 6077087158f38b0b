"""The plans of K5-conv's, K5-dgrad's and K5-wgrad's Hopper kernels, on
the CPU.

The kernels run only on the card, but what they compute is decided in
Python from the shape alone: K5-conv's tiles, taps and K partitions
(``_conv_plan``), K5-dgrad's parity classes, their taps, the weight read
in place and the K partitions (``_dgrad_plan``), and K5-wgrad's row
partitions (``_wgrad_parts``). K5-conv's plan drives a plain replay in the
same way: per K partition in order, the sum over its steps (tap, bk
channels) of 1x1 ``F.conv2d`` calls on x sampled at the tap, then the
epilogue (bias, residual, ReLU); it must equal ``conv2d_act_plain`` in
f64 (1e-12 of the largest |y|) and the JAX ``conv2d`` with the same
epilogue in f32 (1e-5 of the largest |y|). Here the dgrad plan drives
a plain PyTorch replay, dx summed per class from 1x1 ``F.conv2d`` calls
over the planned taps and channel steps, partition by partition in
partition order, with each step's weight read from the OHWI weight viewed
as (Cout, k^2, Cin) at the coordinates the kernel's TMA boxes use. The
replay must equal ``conv2d_input_plain`` in f64 (1e-12 of the largest
|value|: the same products summed in another order) and the JAX VJP of
``shapy_tpu/models/backbones/layers.py`` ``conv2d`` within 1e-5 of the
largest |value| in f32 (XLA's sums in another order). Inputs are made
with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from shapy_tpu.models.backbones import layers as jlayers
from shapy_tpu_torch.models.backbones.layers import (
    _PLAN_MIN_STEPS,
    _TILE_ROWS,
    _WGRAD_MIN_ROWS,
    _conv_plan,
    _dgrad_plan,
    _wgmma_n,
    _wgrad_parts,
    conv2d_act_plain,
    conv2d_input_plain,
)

# The backbone's conv shapes (Cin, Cout, k, stride, input side) at a 256^2
# crop: every one that a train step differentiates.
BACKBONE = [
    (3, 64, 3, 2, 256), (64, 64, 3, 2, 128), (64, 256, 1, 1, 64),
    (64, 64, 1, 1, 64), (64, 64, 3, 1, 64), (256, 64, 1, 1, 64),
    (256, 48, 3, 1, 64), (256, 96, 3, 2, 64), (48, 48, 3, 1, 64),
    (96, 96, 3, 1, 32), (96, 48, 1, 1, 32), (48, 96, 3, 2, 64),
    (96, 192, 3, 2, 32), (192, 192, 3, 1, 16), (192, 48, 1, 1, 16),
    (192, 96, 1, 1, 16), (48, 48, 3, 2, 64), (48, 192, 3, 2, 32),
    (192, 384, 3, 2, 16), (384, 384, 3, 1, 8), (384, 48, 1, 1, 8),
    (384, 96, 1, 1, 8), (384, 192, 1, 1, 8), (48, 48, 3, 2, 32),
    (48, 384, 3, 2, 16), (96, 96, 3, 2, 32), (96, 384, 3, 2, 16),
    (1536, 2048, 1, 1, 8), (1536, 512, 1, 1, 8), (512, 512, 3, 1, 8),
    (512, 2048, 1, 1, 8), (2048, 2048, 1, 1, 8), (2048, 512, 1, 1, 8),
]


def _out(size: int, k: int, stride: int) -> int:
    return (size + 2 * (k // 2) - k) // stride + 1


def dgrad_replay(dy: torch.Tensor, w: torch.Tensor, input_shape,
                 stride: int) -> torch.Tensor:
    """dx as K5-dgrad's plan computes it: per parity class, per K
    partition in partition order, the sum over the partition's steps
    (tap t, channels co0 .. co0 + bk) of a 1x1 conv of dy shifted by the
    tap's (dh, dw) with the weight box w[co0:co0 + bk, t, :]."""
    n, cin, h, wd = input_shape
    cout, _, k, _ = w.shape
    plan = _dgrad_plan(n, h, wd, cin, cout, k, stride)
    boxes = w.permute(0, 2, 3, 1).reshape(cout, k * k, cin)  # in place
    chunks = -(-cout // plan.bk)
    dx = torch.zeros(input_shape, dtype=dy.dtype)
    for cls in plan.classes:
        # dy padded so that (i + dh, j + dw) for dh, dw in {-1, 0, 1} and
        # every class pixel lands inside; zeros outside dy.
        pad = F.pad(dy, (1, cls.wc + 1, 1, cls.hc + 1))
        acc = torch.zeros((n, cin, cls.hc, cls.wc), dtype=dy.dtype)
        for p in range(plan.parts):
            part = torch.zeros_like(acc)
            for s in plan.partition(cls, cout, p):
                r, c, dh, dw = cls.taps[s // chunks]
                co0 = (s % chunks) * plan.bk
                box = boxes[co0:co0 + plan.bk, r * k + c, :]
                src = pad[:, co0:co0 + plan.bk, 1 + dh:1 + dh + cls.hc,
                          1 + dw:1 + dw + cls.wc]
                part = part + F.conv2d(src, box.t()[:, :, None, None])
            acc = acc + part
        dx[:, :, cls.ph::stride, cls.pw::stride] = acc
    return dx


@pytest.mark.parametrize("cin,cout", [(48, 96), (96, 48)])
@pytest.mark.parametrize("side", [8, 9])
@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_dgrad_plan_replay_matches_plain_and_jax(k, stride, side, cin, cout):
    """The plan's replay against ``conv2d_input_plain`` (f64) and against
    ``jax.vjp`` of the JAX ``conv2d`` (f32), batch 2, even and odd sides."""
    rng = np.random.default_rng(1000 * k + 100 * stride + side + cin)
    n, out = 2, _out(side, k, stride)
    x = rng.normal(size=(n, side, side, cin)).astype(np.float32)
    w = (rng.normal(size=(k, k, cin, cout))
         / np.sqrt(k * k * cin)).astype(np.float32)
    dy = rng.normal(size=(n, out, out, cout)).astype(np.float32)
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())  # OIHW
    dyt = torch.from_numpy(dy.transpose(0, 3, 1, 2).copy())
    shape = (n, cin, side, side)

    got = dgrad_replay(dyt.double(), wt.double(), shape, stride)
    want = conv2d_input_plain(shape, wt.double(), dyt.double(), stride)
    assert float((got - want).abs().max()) <= 1e-12 * float(
        want.abs().max())

    def run(x):
        store = jlayers.ParamStore({"c.weight": jnp.asarray(w)})
        return jlayers.conv2d(store, "c", x, cout, k, stride, k // 2)

    _, vjp = jax.vjp(run, jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(dy))
    got32 = dgrad_replay(dyt, wt, shape, stride).numpy().transpose(0, 2, 3, 1)
    jdx = np.asarray(jdx)
    assert np.abs(got32 - jdx).max() <= 1e-5 * np.abs(jdx).max()


@pytest.mark.parametrize("shape", BACKBONE[1:] + [
    (64, 64, 3, 2, 15), (48, 96, 1, 2, 9), (256, 96, 3, 2, 64),
    (16, 24, 3, 2, 7)], ids=lambda s: "-".join(map(str, s)))
def test_dgrad_plan_covers_every_pixel_and_k_step_once(shape):
    """At batch 48 (the train step's) and at odd sides: the classes cover
    each dx pixel once, and the M tiles' dy boxes (images x rows x
    columns, at most 128 pixels) each class pixel once; a stride-2 3x3
    has classes of 4, 2, 2 and 1 taps (a 1x1 one of 1 tap and zero-tap
    classes), each tap reaches dy at (h + pad - r) / stride, the
    partitions of each class cover its K steps once and in order, each
    partition holds at least the minimum steps unless there is one, and
    the plan depends on the shape alone."""
    cin, cout, k, stride, side = shape
    n = 48
    plan = _dgrad_plan(n, side, side, cin, cout, k, stride)
    assert plan == _dgrad_plan(n, side, side, cin, cout, k, stride)
    assert plan.bn == _wgmma_n(cin)
    assert cout % plan.bk == 0 or plan.bk == 16
    assert plan.bk in (64, 48, 32, 16)  # the K steps conv.cu takes
    bni, bh, bw = plan.box
    assert bni * bh * bw <= _TILE_ROWS
    seen = np.zeros((side, side), dtype=int)
    for cls in plan.classes:
        seen[cls.ph::stride, cls.pw::stride] += 1
        assert (cls.hc, cls.wc) == seen[cls.ph::stride, cls.pw::stride].shape
        boxed = np.zeros((n, cls.hc, cls.wc), dtype=int)
        for n0 in range(0, n, bni):
            for i0 in range(0, cls.hc, bh):
                for j0 in range(0, cls.wc, bw):
                    boxed[n0:n0 + bni, i0:i0 + bh, j0:j0 + bw] += 1
        assert (boxed == 1).all()
        for r, c, dh, dw in cls.taps:
            h, w = cls.ph, cls.pw
            assert (h + k // 2 - r) == stride * dh
            assert (w + k // 2 - c) == stride * dw
        steps = plan.steps(cls, cout)
        covered = [s for p in range(plan.parts)
                   for s in plan.partition(cls, cout, p)]
        assert covered == list(range(steps))
        if plan.parts > 1:
            longest = max(plan.steps(c, cout) for c in plan.classes)
            assert longest // plan.parts >= _PLAN_MIN_STEPS
    assert (seen == 1).all()
    taps = sorted((len(c.taps) for c in plan.classes), reverse=True)
    want = {(3, 1): [9], (1, 1): [1], (3, 2): [4, 2, 2, 1],
            (1, 2): [1, 0, 0, 0]}[(k, stride)]
    assert taps == want[:len(taps)]
    assert [len(c.taps) for c in plan.classes] == taps


@pytest.mark.parametrize("wgmma", [True, False])
@pytest.mark.parametrize("shape", BACKBONE, ids=lambda s: "-".join(
    map(str, s)))
def test_wgrad_parts_cover_every_row_once(shape, wgmma):
    """K5-wgrad's row partitions at batch 48 and batch 2: consecutive
    ranges of ``per`` rows (a multiple of the kernel's row step: 64 for
    the wgmma kernel, 32 for the stem's and f32) that cover the N Ho Wo
    rows once, at least 256 rows each unless there is one, and a function
    of the shape alone."""
    cin, cout, k, stride, side = shape
    for n in (48, 2):
        rows = n * _out(side, k, stride) ** 2
        parts, per = _wgrad_parts(rows, cout, k * k * cin, wgmma)
        assert (parts, per) == _wgrad_parts(rows, cout, k * k * cin, wgmma)
        assert per % (64 if wgmma else 32) == 0
        assert (parts - 1) * per < rows <= parts * per
        starts = [p * per for p in range(parts)]
        assert sorted(set(r for s in starts for r in range(
            s, min(rows, s + per)))) == list(range(rows))
        assert parts == 1 or per >= _WGRAD_MIN_ROWS


def test_wgmma_n_divides_the_channels():
    """The wgmma N tile: all the channels of the 48-, 96- and 192-channel
    convs (no column wasted), the widest dividing width above 256."""
    assert [_wgmma_n(c) for c in (48, 64, 96, 192, 256)] == [
        48, 64, 96, 192, 256]
    assert [_wgmma_n(c) for c in (384, 512, 1536, 2048)] == [
        192, 256, 256, 256]
    assert _wgmma_n(40) == 64
    assert _TILE_ROWS == 128


def conv_replay(x, w, bias=None, residual=None, relu=False, stride=1):
    """y as K5-conv's plan computes it (x NCHW, w OIHW, Cin % 8 == 0): per
    K partition in partition order, the sum over its steps (tap (r, c),
    channels ci0 .. ci0 + bk) of a 1x1 conv of x sampled at (stride i + r
    - pad, stride j + c - pad) (zero outside x); the partitions added in
    order, then the epilogue, each step rounded to x's dtype."""
    n, cin, h, wd = x.shape
    cout, _, k, _ = w.shape
    pad = k // 2
    ho, wo = _out(h, k, stride), _out(wd, k, stride)
    plan = _conv_plan(n, h, wd, cin, cout, k, stride)
    chunks = -(-cin // plan.bk)
    xp = F.pad(x, (pad, pad + stride, pad, pad + stride))
    y = torch.zeros((n, cout, ho, wo), dtype=x.dtype)
    for p in range(plan.parts):
        part = torch.zeros_like(y)
        for s in plan.partition(cin, k, p):
            tap, ci0 = divmod(s, chunks)
            r, c = divmod(tap, k)
            ci0 *= plan.bk
            src = xp[:, ci0:ci0 + plan.bk, r:r + stride * ho:stride,
                     c:c + stride * wo:stride]
            box = w[:, ci0:ci0 + plan.bk, r, c]
            part = part + F.conv2d(src, box[:, :, None, None])
        y = y + part
    if bias is not None:
        y = y + bias[:, None, None]
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def _conv_inputs(rng, n, cin, cout, k, side, stride):
    out = _out(side, k, stride)
    x = rng.normal(size=(n, side, side, cin)).astype(np.float32)
    w = (rng.normal(size=(k, k, cin, cout))
         / np.sqrt(k * k * cin)).astype(np.float32)
    b = rng.normal(size=cout).astype(np.float32) * 0.3
    r = rng.normal(size=(n, out, out, cout)).astype(np.float32)
    return x, w, b, r


@pytest.mark.parametrize("epilogue", ["none", "bias-relu",
                                      "bias-residual-relu"])
@pytest.mark.parametrize("cin,cout", [(48, 96), (96, 48), (40, 24)])
@pytest.mark.parametrize("side", [8, 9])
@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_conv_plan_replay_matches_plain(k, stride, side, cin, cout,
                                        epilogue):
    """The plan's replay against ``conv2d_act_plain`` in f64, batch 3,
    even and odd sides, K steps of 64, 48 and 16 channels (40 channels
    run past Cin), with and without the epilogue: the same products
    summed in another order."""
    rng = np.random.default_rng(100 * k + 10 * stride + side + cin)
    x, w, b, r = _conv_inputs(rng, 3, cin, cout, k, side, stride)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).double()
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).double()
    bt = torch.from_numpy(b).double() if "bias" in epilogue else None
    rt = (torch.from_numpy(r.transpose(0, 3, 1, 2).copy()).double()
          if "residual" in epilogue else None)
    relu = "relu" in epilogue
    got = conv_replay(xt, wt, bt, rt, relu, stride)
    want = conv2d_act_plain(xt, wt, bt, rt, relu, stride)
    assert float((got - want).abs().max()) <= 1e-12 * float(
        want.abs().max())


@pytest.mark.parametrize("index", range(len(BACKBONE[1:])),
                         ids=lambda i: "-".join(map(str, BACKBONE[1 + i])))
def test_conv_plan_replay_matches_jax(index):
    """The plan's replay against the JAX package's ``conv2d`` (bias) + the
    residual + ReLU in f32, within 1e-5 of the largest |y|, at every
    backbone shape with Cin % 8 == 0, the side cut to a sixteenth (at
    least 3) and the batch cycling through 1-3."""
    cin, cout, k, stride, side = BACKBONE[1 + index]
    side, n = max(3, side // 16), 1 + index % 3
    rng = np.random.default_rng(7 * index + 1)
    x, w, b, r = _conv_inputs(rng, n, cin, cout, k, side, stride)
    store = jlayers.ParamStore({"c.weight": jnp.asarray(w),
                                "c.bias": jnp.asarray(b)})
    want = np.asarray(jax.nn.relu(jlayers.conv2d(
        store, "c", jnp.asarray(x), cout, k, stride, k // 2, bias=True)
        + jnp.asarray(r)))
    got = conv_replay(
        torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
        torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(b), torch.from_numpy(r.transpose(0, 3, 1, 2).copy()),
        True, stride).numpy().transpose(0, 2, 3, 1)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("shape", BACKBONE[1:] + [
    (64, 64, 3, 2, 15), (48, 96, 1, 2, 9), (40, 40, 3, 1, 7),
    (256, 48, 3, 1, 17)], ids=lambda s: "-".join(map(str, s)))
def test_conv_plan_covers_every_output_and_k_step_once(shape):
    """At batches 32 (served), 48 (trained) and 128: the M tiles' boxes of
    output pixels (images x rows x columns, at most 128) and the N tiles
    cover each output element once; the partitions cover the K steps once
    and in order, each with at least the minimum steps unless there is
    one; the N tile is a wgmma width, the K step divides Cin where it can;
    and the plan depends on the shape alone."""
    cin, cout, k, stride, side = shape
    out = _out(side, k, stride)
    for n in (32, 48, 128):
        plan = _conv_plan(n, side, side, cin, cout, k, stride)
        assert plan == _conv_plan(n, side, side, cin, cout, k, stride)
        assert plan.bn == _wgmma_n(cout)
        assert cin % plan.bk == 0 or plan.bk == 16
        assert plan.bk in (64, 48, 16)  # the K steps conv.cu takes
        bni, bh, bw = plan.box
        assert bni * bh * bw <= _TILE_ROWS
        seen = np.zeros((n, out, out, -(-cout // plan.bn) * plan.bn),
                        dtype=np.int64)
        for n0 in range(0, n, bni):
            for i0 in range(0, out, bh):
                for j0 in range(0, out, bw):
                    for co0 in range(0, cout, plan.bn):
                        seen[n0:n0 + bni, i0:i0 + bh, j0:j0 + bw,
                             co0:co0 + plan.bn] += 1
        assert (seen[..., :cout] == 1).all()
        steps = plan.steps(cin, k)
        covered = [s for p in range(plan.parts)
                   for s in plan.partition(cin, k, p)]
        assert covered == list(range(steps))
        if plan.parts > 1:
            assert steps // plan.parts >= _PLAN_MIN_STEPS
