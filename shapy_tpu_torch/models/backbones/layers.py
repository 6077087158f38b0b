"""Conv-net building blocks with the JAX package's param names (port of
``shapy_tpu/models/backbones/layers.py``).

Modules are named so that ``state_dict`` keys equal the JAX param names
(``stage2.0.branches.1.3.conv2.weight`` ...), i.e. the reference torch
names. Conv weights are OIHW here and HWIO in the JAX package
(``io/from_jax.py`` transposes).

In training, :class:`BatchNorm2d` normalises with the batch's moments
and updates its running stats through :func:`batch_norm_train`, whose CUDA
path is kernel K4 (``csrc/batch_norm.cu``, forward and backward). For
eval, :func:`fold_bn_` folds each BN into the conv before it at load time,
as the JAX package's eval forward does (``bn_fold_params``).

Every conv runs :func:`conv2d_act`, in training and in eval: kernel
K5-conv (``csrc/conv.cu``) for CUDA tensors, its plain version for CPU
tensors. With the BN folded (eval), :func:`conv_act` fuses each conv's
bias, the block's residual and the ReLU into that one call; in training
the conv is followed by K4's BN. Its backward is K5-dgrad (the data
gradient) and K5-wgrad (the weight and bias gradients) on the card, and
``torch.nn.grad.conv2d_input`` / ``conv2d_weight`` on the CPU.

The ResNet's 7x7 stem (3 input channels) is kernel K10 (``csrc/conv.cu``
``conv2d_stem_forward`` / ``conv2d_stem_wgrad``; the images take no data
gradient), and its 3x3 / stride-2 max pool, :func:`max_pool2d`, kernel
K11 (``csrc/max_pool.cu``, forward and backward).

Weights stay f32 (the master copy) and each conv runs in its input's
dtype, so a bf16 backbone trains as the JAX package's ``compute_dtype``
bfloat16 does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from shapy_tpu_torch.utils.cuda_kernels import CudaKernel, check_cuda_input

BN_EPS = 1e-5
BN_MOMENTUM = 0.1

BN_KERNEL = CudaKernel("batch_norm.cu", {
    "bn_forward": "ppppp pppp iiiii iii fff p",
    "bn_backward": "ppppp ppppp iiii iii p",
})
# The activation dtypes K4, K5-conv and K5-fuse take, by their C code.
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# K4's plans (:func:`_bn_plan`): a thread takes 8 channels of a row (1
# where C % 8 != 0). One launch, a thread-block cluster per 8 channels (16
# blocks where C / 8 such clusters fit one block to each of an H100's
# _BN_SMS SMs, else 8), where a thread then sums at most _BN_CLUSTER_ROWS
# rows and the launch holds at most _BN_CLUSTER_BLOCKS blocks (3 an SM):
# for the backward, the 8^2 and 16^2 layers up to 384 channels; the
# forward (x alone, fewer registers) where a thread sums at most
# _BN_FWD_CLUSTER_ROWS rows, at any width: the 8^2 and 16^2 layers and
# the 48-channel 32^2 ones (both measured, PERF.md). Else three launches
# over row tiles of about _BN_TILE_ELEMS elements, at most
# _BN_SPLIT_TILES, the forward's elementwise pass on at most
# _BN_NORM_BLOCKS blocks (4 an SM, as its launch bounds hold it).
# Constants: the tiles, and with them the sums' bits, depend on the shape
# alone.
_BN_THREADS = 256
_BN_SMS = 132
_BN_CLUSTER_ROWS, _BN_CLUSTER_BLOCKS = 6, 396
_BN_NORM_BLOCKS = 4 * _BN_SMS
_BN_FWD_CLUSTER_ROWS = 12
_BN_TILE_ELEMS, _BN_SPLIT_TILES = 1 << 14, 1024

CONV_KERNEL = CudaKernel("conv.cu", {
    "conv2d_act_forward": "pppppp iiiiiii ii iiiii i p",
    "conv2d_dgrad": "pppp iiiiiii iii iii i p",
    "conv2d_wgrad": "pppppppp iiiiiii ii iii p",
    "conv2d_relu_mask": "ppp ii p",
    # K10, the ResNet's 7x7 stem on the images: forward and weight gradient
    "conv2d_stem_forward": "pppp iiiiiii ii ii p",
    "conv2d_stem_wgrad": "pppppppp iiiiiii iii i p",
})
POOL_KERNEL = CudaKernel("max_pool.cu", {
    "max_pool_forward": "pp iiii i p",
    "max_pool_backward": "ppp iiii i iii p",
})
# K10's kernel size: a 7x7 conv runs only on the 3 image channels.
STEM_K = 7
# K11's backward (:func:`max_pool_backward_plan`): a block takes at most
# _POOL_TILE x _POOL_TILE output windows and a channel slice of at most
# _POOL_SLICE_BYTES a pixel (67 KB of shared memory at most: three blocks
# an SM of an H100).
_POOL_TILE, _POOL_SLICE_BYTES = 8, 128
# The wgmma widths (N tiles) that K5-conv, K5-dgrad and K5-wgrad are built
# for.
_WGMMA_N = (256, 192, 128, 96, 64, 48)
# The wgmma kernels: 128-row M tiles (two warpgroups of 64); K5-conv's and
# K5-dgrad's K steps and K5-wgrad's row steps are at most 64 deep.
_TILE_ROWS = 128
# K5-wgrad's row partitions: for the wgmma kernel (128 K columns x an N
# tile of up to 256 channels, 64-row steps, a persistent grid), as many
# partitions of the N Ho Wo rows as keep the tiles at most this many (two
# per SM of an H100), at least 256 rows each; for the stem's mma.sync
# kernel (64 x 64 tiles, 32-row steps, a block per tile) as many as bring
# a launch to about this many blocks. Constants, so that the partition,
# and with it the gradient's bits, depends on the shape alone and not on
# the card.
_WGRAD_MIN_ROWS = 256
_WGRAD_HOPPER_STEP, _WGRAD_HOPPER_TILES = 64, 264
_WGRAD_TILE, _WGRAD_STEP, _WGRAD_BLOCKS = 64, 32, 512
# K10's weight gradient in bf16 (7x7, stride 2, 64 channels): runs of up
# to _STEM_RUN output pixels of a row, in at most _STEM_WGRAD_PARTS
# partitions of consecutive runs (about two blocks an SM of an H100; a
# constant, for the same reason).
_STEM_RUN, _STEM_WGRAD_PARTS = 128, 264
# K10's forward in bf16 (7x7, stride 2, 64 channels; :func:`stem_plan`): a
# persistent grid of at most _STEM_BLOCKS blocks (three an SM of an H100
# by their shared memory and registers; the kernel takes no more than its
# groups of output pixels fill).
_STEM_BLOCKS = 396
# K5-conv's and K5-dgrad's K partitions (:func:`_k_parts`): a persistent
# grid holds _PLAN_SMS blocks (an H100's SMs; twice as many where two
# blocks share an SM, :func:`_wgmma_pair`), and the K walk (taps x channels
# in bk-deep steps) is cut into the fewest partitions, each of at least
# _PLAN_MIN_STEPS steps, whose rounds of tiles x (steps per partition + the
# f32 partial's write and read in steps' worth of bytes) come within
# _PLAN_SLACK of the least. Constants, for the same reason: the partition,
# and with it the bits, never depends on the card.
_PLAN_SMS, _PLAN_MIN_STEPS, _PLAN_SLACK = 132, 4, 1.05


def _wide(t: torch.Tensor) -> torch.Tensor:
    """f32 for bf16 / f32 tensors (the JAX package's sums); f64 stays."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _moments_plain(x: torch.Tensor):
    """Batch moments over (N, H, W) as ``E[x^2] - E[x]^2`` in f32
    (``layers.py:142-159`` of the JAX package)."""
    xf = _wide(x)
    mean = xf.mean(dim=(0, 2, 3))
    var = xf.square().mean(dim=(0, 2, 3)) - mean.square()
    return mean, var


def _xhat_plain(x, mean, inv):
    """``(x - mean) * inv`` in x's dtype, mean and inv (C,) f32 rounded to
    it first."""
    dt = x.dtype
    return (x - mean.to(dt)[:, None, None]) * inv.to(dt)[:, None, None]


def batch_norm_train_plain(x, gamma, beta, eps: float = BN_EPS):
    """Plain version of K4's forward: ``(y, mean, var)`` with the moments
    in f32 and y in x's dtype, each operation rounded to it after mean and
    ``inv = rsqrt(var + eps)`` are (``_bn_normalize``). x (N, C, H, W)."""
    mean, var = _moments_plain(x)
    inv = torch.rsqrt(var + eps)
    dt = x.dtype
    y = (_xhat_plain(x, mean, inv) * gamma.to(dt)[:, None, None]
         + beta.to(dt)[:, None, None])
    return y, mean, var


def batch_norm_train_backward_plain(dy, x, gamma, mean, inv):
    """Plain version of K4's backward, the JAX package's fused formula
    (``_bn_train_bwd``): ``dx = gamma inv (dy - mean(dy) - x_hat
    mean(dy x_hat))`` in the activation dtype with f32 sums; ``dgamma =
    sum dy x_hat``, ``dbeta = sum dy``. Returns (dx, dgamma, dbeta)."""
    dt = dy.dtype
    n = float(dy.numel() // dy.shape[1])
    xhat = _xhat_plain(x, mean, inv)
    dyf = _wide(dy)
    sdy = dyf.sum(dim=(0, 2, 3))
    sdyx = (dyf * _wide(xhat)).sum(dim=(0, 2, 3))
    scale = _wide(gamma) * _wide(inv.to(dt))
    dx = scale.to(dt)[:, None, None] * (
        dy - (sdy / n).to(dt)[:, None, None]
        - xhat * (sdyx / n).to(dt)[:, None, None])
    return dx, sdyx.to(gamma.dtype), sdy.to(gamma.dtype)


class BnPlan(NamedTuple):
    """K4's plan for R rows of C channels, its forward's or its
    backward's (:func:`_bn_plan`). A thread takes ``vec`` channels (8, or
    1 where C % 8 != 0) of every ``lanes``-th row of its tile (``tiles``
    of ``rows`` rows).
      * ``fused`` (one launch): tile t is block t of a cluster of
        ``tiles`` (8 or 16) per ``vec`` channels, 256 lanes. Sum order:
        lane l sums its rows in order; lanes 32 g .. 32 g + 31 in order
        for g = 0 .. 7, those 8 in order; then the cluster's blocks in
        order.
      * else (three launches): a block is ``lanes`` row lanes x ``group``
        channel chunks (group = min(C / vec, 256), lanes = 256 / group).
        Sum order: lane l of tile t sums its rows in order; then the lanes
        in order; then the tiles: 32 finalize lanes, lane f over tiles f,
        f + 32, ... in order, then those lanes in order. The forward's
        elementwise pass runs ``bands`` blocks along the rows (0 when
        ``fused``): block b's lane l writes rows ``b lanes + l`` and
        every ``bands lanes``-th row after it.
    The forward sums x and x^2, the backward dy and dy x_hat."""
    fused: bool
    tiles: int
    rows: int
    vec: int
    group: int
    lanes: int
    bands: int


def _tiles_of(R: int, tiles: int):
    """(tiles, rows per tile) covering R rows with at most ``tiles``."""
    rows = -(-R // max(1, tiles))
    return -(-R // rows), rows


@functools.lru_cache(maxsize=None)
def _bn_plan(R: int, C: int, forward: bool = False) -> BnPlan:
    """K4's plan for its backward, or with ``forward`` its forward, from
    the shape alone (never the card): the cluster regime where it fits
    (see ``_BN_*``), else the three launches; the two passes' tiles in a
    regime are the same. Cached, like the conv plans: a wrapper call then
    costs no planning."""
    cluster = _bn_plan_regime(R, C, True)
    if forward:
        fits = R <= cluster.tiles * _BN_THREADS * _BN_FWD_CLUSTER_ROWS
    else:
        fits = (R <= cluster.tiles * _BN_THREADS * _BN_CLUSTER_ROWS
                and C // cluster.vec * cluster.tiles <= _BN_CLUSTER_BLOCKS)
    return cluster if fits else _bn_plan_regime(R, C, False)


def _bn_plan_regime(R: int, C: int, fused: bool) -> BnPlan:
    """K4's plan for R rows of C channels with the regime given:
    ``fused`` one cluster launch, else three. :func:`_bn_plan` picks the
    regime; this forces one, to time or test each."""
    vec = 8 if C % 8 == 0 else 1
    if fused:
        cluster = 16 if C // vec * 16 <= _BN_SMS else 8
        return BnPlan(True, cluster, -(-R // cluster), vec, 1, _BN_THREADS,
                      0)
    group = min(C // vec, _BN_THREADS)
    lanes = _BN_THREADS // group
    want = min(_BN_SPLIT_TILES, -(-R * C // _BN_TILE_ELEMS))
    tiles, rows = _tiles_of(R, want)
    cgroups = -(-(C // vec) // group)
    bands = max(1, min(-(-R // lanes), _BN_NORM_BLOCKS // cgroups))
    return BnPlan(False, tiles, rows, vec, group, lanes, bands)


def _bn_backward_cuda(dy, x, gamma, mean, inv, plan: BnPlan):
    """Kernel K4's backward on CUDA tensors: ``(dx, dgamma, dbeta)`` for
    dy and x (N, C, H, W) of one dtype, by ``plan`` (:func:`_bn_plan` of
    the shape)."""
    N, C, H, W = x.shape
    R = N * H * W
    rows, dy_rows = _bn_rows(x), _bn_rows(dy.to(x.dtype))
    if plan.vec == 8:
        rows, dy_rows, mean, inv = _aligned16(rows, dy_rows, mean, inv)
    dx = torch.empty_like(rows)
    dgamma = torch.empty_like(gamma)
    dbeta = torch.empty_like(gamma)
    partials = coef = None
    if not plan.fused:
        partials = torch.empty((plan.tiles, C, 2), dtype=torch.float32,
                               device=x.device)
        coef = torch.empty((3, C), dtype=torch.float32, device=x.device)
    BN_KERNEL.launch("bn_backward", [
        dy_rows, rows, gamma, mean, inv, partials, coef, dgamma, dbeta, dx,
        R, C, plan.tiles, plan.rows, plan.vec, int(plan.fused),
        KERNEL_DTYPES[x.dtype]])
    return dx.permute(0, 3, 1, 2), dgamma, dbeta


def _bn_forward_cuda(x, gamma, beta, running_mean, running_var, eps,
                     momentum, plan: BnPlan):
    """Kernel K4's forward on CUDA tensors: ``(y, mean, inv)`` for x (N,
    C, H, W) by ``plan`` (:func:`_bn_plan` of the shape, ``forward``),
    the running stats (or None) updated in place."""
    N, C, H, W = x.shape
    R = N * H * W
    rows = _bn_rows(x)
    if plan.vec == 8:
        rows, gamma, beta = _aligned16(rows, gamma, beta)
    y = torch.empty_like(rows)
    mean = torch.empty(C, dtype=torch.float32, device=x.device)
    inv = torch.empty_like(mean)
    partials = None if plan.fused else torch.empty(
        (plan.tiles, C, 2), dtype=torch.float32, device=x.device)
    BN_KERNEL.launch("bn_forward", [
        rows, gamma, beta, running_mean, running_var, partials, mean, inv,
        y, R, C, plan.tiles, plan.rows, plan.bands, plan.vec,
        int(plan.fused), KERNEL_DTYPES[x.dtype], float(eps), float(momentum),
        float(np.float32(R / max(R - 1, 1)))])
    return y.permute(0, 3, 1, 2), mean, inv


def _bn_rows(t: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) channels-last -> its (N H W, C) row-major storage."""
    return t.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def _aligned16(*ts):
    """The tensors for K4's 16-byte rows and vectors: a copy only of a
    view at an odd offset."""
    return tuple(t.clone() if t.data_ptr() % 16 else t for t in ts)


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode BN: K4's kernels for CUDA tensors, the plain versions
    for CPU tensors; the running stats are updated in place in the
    forward."""

    @staticmethod
    def forward(ctx, x, gamma, beta, running_mean, running_var, eps,
                momentum):
        N, C, H, W = x.shape
        R = N * H * W
        if x.device.type == "cpu":
            y, mean, var = batch_norm_train_plain(x, gamma, beta, eps)
            inv = torch.rsqrt(var + eps)
            unbias = R / max(R - 1, 1)
            if running_mean is not None:
                running_mean.copy_((1 - momentum) * running_mean
                                   + momentum * mean)
                running_var.copy_((1 - momentum) * running_var
                                  + momentum * (var * unbias))
        else:
            y, mean, inv = _bn_forward_cuda(x, gamma, beta, running_mean,
                                            running_var, eps, momentum,
                                            _bn_plan(R, C, True))
        ctx.save_for_backward(x, gamma, mean, inv)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, inv = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dgamma, dbeta = batch_norm_train_backward_plain(
                dy.to(x.dtype), x, gamma, mean, inv)
            return dx, dgamma, dbeta, None, None, None, None
        N, C, H, W = x.shape
        dx, dgamma, dbeta = _bn_backward_cuda(dy, x, gamma, mean, inv,
                                              _bn_plan(N * H * W, C))
        return dx, dgamma, dbeta, None, None, None, None


def batch_norm_train(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, running_mean=None, running_var=None,
                     eps: float = BN_EPS, momentum: float = BN_MOMENTUM
                     ) -> torch.Tensor:
    """Train-mode BatchNorm of x (N, C, H, W), bf16 or f32, with f32
    gamma / beta (C,): the plain versions for CPU tensors, kernel K4 for
    CUDA tensors (a channels-last copy is made if x is not channels-last).
    ``running_mean`` / ``running_var`` (f32, or both None) get the EMA in
    place."""
    if x.device.type == "cuda":
        if x.dtype not in KERNEL_DTYPES:
            raise TypeError(f"batch_norm_train: dtype {x.dtype}")
        N, C, H, W = x.shape
        if N * H * W * C >= 2 ** 32:
            raise ValueError("batch_norm_train: 2^32 elements or more")
        dev = x.device
        for t, name in ((gamma, "gamma"), (beta, "beta"),
                        (running_mean, "running_mean"),
                        (running_var, "running_var")):
            if t is not None:
                check_cuda_input(t, name, torch.float32, (C,), dev)
        if (running_mean is None) != (running_var is None):
            raise ValueError("batch_norm_train: both running stats or none")
    elif x.device.type != "cpu":
        raise ValueError(f"batch_norm_train: unsupported device {x.device}")
    return _BatchNormTrain.apply(x, gamma, beta, running_mean, running_var,
                                 eps, momentum)


class BatchNorm2d(nn.Module):
    """BatchNorm with the torch param names and no ``num_batches_tracked``
    (the JAX params have none): batch moments and running-stat EMA in
    training (:func:`batch_norm_train`), running stats in eval."""

    def __init__(self, c: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return batch_norm_train(x, self.weight, self.bias,
                                    self.running_mean, self.running_var,
                                    self.eps, self.momentum)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def bf16_step(mag: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 numbers at magnitude ``mag``."""
    e = torch.floor(torch.log2(mag.float().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def conv2d_act_bf16_tolerance(s, bias, residual, terms, cin: int, k: int
                              ) -> torch.Tensor:
    """The per-element limit of bf16 K5-conv against its plain version (or
    either against the plain epilogue on the exact sum): one bf16 step at
    each rounding of the epilogue (the conv sum ``s`` in f32, + bias, +
    residual, at their magnitudes) plus the worst-case gap of two f32 sums
    of the same K = cin k^2 products in other orders, 2 K 2^-24 sum |x w|
    (``terms``, the conv of |x| and |w|): under cancellation that gap
    exceeds a step of the sum itself."""
    tol = bf16_step(s.abs())
    if bias is not None:
        s = s + bias.float()[:, None, None]
        tol = tol + bf16_step(s.abs())
    if residual is not None:
        tol = tol + bf16_step((s + residual.float()).abs())
    return tol + 2.0 * cin * k * k * 2.0 ** -24 * terms


def conv2d_wgrad_bf16_tolerance(got, terms, k: int) -> torch.Tensor:
    """The per-element limit of a bf16 K5-wgrad value ``got`` (dw or
    dbias) against the exact sum of its k = N Ho Wo products: half a bf16
    step at ``got`` (its one rounding to nearest) plus 2 sqrt(k) 2^-24
    sum |terms| (``terms``: the sum of the products' magnitudes), twice
    the statistical size of an f32 sum's rounding errors. The worst case
    of :func:`conv2d_act_bf16_tolerance`, 2 k 2^-24 sum |terms|, would
    pass a zeroed gradient at the backbone's k of up to 786,432."""
    return (0.5 * bf16_step(got.float().abs())
            + 2.0 * k ** 0.5 * 2.0 ** -24 * terms)


def conv2d_wgrad_f32_tolerance(got, terms, k: int) -> torch.Tensor:
    """As :func:`conv2d_wgrad_bf16_tolerance`, for an f32 K5-wgrad value
    ``got``: half an f32 step at ``got`` (its one rounding) plus 2
    sqrt(k) 2^-24 sum |terms|, the f32 sum's statistical rounding."""
    mag = got.double().abs().clamp_min(2.0 ** -126)
    half_step = torch.exp2(torch.floor(torch.log2(mag)) - 24)
    return half_step + 2.0 * k ** 0.5 * 2.0 ** -24 * terms.double()


def conv2d_act_plain(x, weight, bias=None, residual=None, relu=False,
                     stride=1):
    """Plain version of K5-conv: ``F.conv2d`` without bias (padding k //
    2), then ``+ bias``, ``+ residual`` and the ReLU as separate eager
    ops, each rounded to x's dtype."""
    y = F.conv2d(x, weight, None, stride, weight.shape[-1] // 2)
    if bias is not None:
        y = y + bias[:, None, None]
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def conv2d_input_plain(input_shape, weight: torch.Tensor,
                       dy: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Plain version of K5-dgrad: the data gradient of
    ``conv2d_act_plain``'s conv (padding k // 2) for a cotangent ``dy``
    already masked by the ReLU, in dy's dtype (f32 sums, one rounding)."""
    return torch.nn.grad.conv2d_input(input_shape, weight, dy, stride,
                                      weight.shape[-1] // 2)


def conv2d_weight_plain(x: torch.Tensor, weight_shape, dy: torch.Tensor,
                        stride: int = 1, bias: bool = False):
    """Plain version of K5-wgrad: ``(dw, dbias)``, the weight gradient of
    the conv in x's dtype and, with ``bias``, the sum of ``dy`` over (N,
    H, W) in f32 rounded once (else None)."""
    dw = torch.nn.grad.conv2d_weight(x, weight_shape, dy, stride,
                                     weight_shape[-1] // 2)
    db = _wide(dy).sum(dim=(0, 2, 3)).to(dy.dtype) if bias else None
    return dw, db


def relu_mask_plain(dy: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``dy`` where the ReLU's output ``y`` is > 0, else 0 (the VJP of
    ``torch.relu`` and ``jax.nn.relu`` from the saved output)."""
    return torch.where(y > 0, dy, torch.zeros((), dtype=dy.dtype))


def conv2d_backward_plain(dy, x, weight, y, stride, need_x, need_w,
                          need_bias, need_residual):
    """The VJP of :func:`conv2d_act_plain` through the plain versions:
    ``(dx, dw, dbias, dresidual)``, each None where not needed; ``y`` the
    saved output of a ReLU epilogue, else None."""
    g = dy if y is None else relu_mask_plain(dy, y)
    dx = conv2d_input_plain(x.shape, weight, g, stride) if need_x else None
    dw = db = None
    if need_w or need_bias:
        dw, db = conv2d_weight_plain(x, weight.shape, g, stride, need_bias)
    return dx, dw, db, g if need_residual else None


def _conv2d_act_cuda(x, weight, bias, residual, relu, stride):
    """Kernel K5-conv; raises on what it does not take."""
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"conv2d_act: dtype {x.dtype}")
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError("conv2d_act: x and weight must be 4-D")
    N, C, H, W = x.shape
    O, I, kh, kw = weight.shape
    stem = kh == STEM_K and C == 3 and residual is None
    if (I != C or kh != kw or not (kh in (1, 3) or stem)
            or stride not in (1, 2)):
        raise ValueError(f"conv2d_act: weight {tuple(weight.shape)}, stride "
                         f"{stride} for input {tuple(x.shape)}")
    if O % 8:
        raise ValueError("conv2d_act: output channels not a multiple of 8")
    cl = torch.channels_last
    if not x.is_contiguous(memory_format=cl):
        raise ValueError("conv2d_act: x must be channels_last-contiguous")
    if not weight.is_contiguous(memory_format=cl):
        raise ValueError("conv2d_act: weight must be OHWI (channels_last)")
    dev = x.device
    if weight.device != dev or weight.dtype != x.dtype:
        raise ValueError("conv2d_act: weight on another device or dtype")
    Ho = (H + 2 * (kh // 2) - kh) // stride + 1
    Wo = (W + 2 * (kh // 2) - kh) // stride + 1
    if bias is not None and (bias.shape != (O,) or bias.dtype != x.dtype
                             or bias.device != dev
                             or not bias.is_contiguous()):
        raise ValueError(f"conv2d_act: bias must be contiguous ({O},) of "
                         "x's dtype and device")
    if residual is not None:
        if (residual.shape != (N, O, Ho, Wo) or residual.dtype != x.dtype
                or residual.device != dev or residual.data_ptr() % 16
                or not residual.is_contiguous(memory_format=cl)):
            raise ValueError("conv2d_act: residual must be channels_last "
                             f"{(N, O, Ho, Wo)} of x's dtype and device")
    if max(x.numel(), N * O * Ho * Wo, weight.numel()) >= 2 ** 31:
        raise ValueError("conv2d_act: 2^31 elements or more")
    y = torch.empty((N, O, Ho, Wo), dtype=x.dtype, device=dev,
                    memory_format=cl)
    if stem:  # K10: the bias and ReLU of the folded BN, or the bare conv
        plan = stem_plan(N, H, W, O, stride, x.dtype)
        if plan.grid:  # 16-byte aligned x (the boxes) and weight, the bias
            x, weight = _aligned_cl(x), _aligned_cl(weight)  # read in pairs
            if bias is not None and bias.data_ptr() % 4:
                bias = bias.clone()
        CONV_KERNEL.launch("conv2d_stem_forward", [
            x, weight, bias, y, N, H, W, C, O, kh, stride, int(relu),
            KERNEL_DTYPES[x.dtype], int(plan.staged), plan.grid])
        return y
    # bf16 with Cin % 8 == 0: the wgmma kernel on its plan (16-byte rows of
    # x and the weight, a copy only for a view at an odd offset); the stem
    # (Cin = 3) and f32: bn 0, no plan.
    part, bn, bk, box, parts = None, 0, 0, (0, 0, 0), 0
    if x.dtype == torch.bfloat16 and C % 8 == 0:
        x, weight = _aligned_cl(x), _aligned_cl(weight)
        plan = _conv_plan(N, H, W, C, O, kh, stride)
        bn, bk, box, parts = plan.bn, plan.bk, plan.box, plan.parts
        if parts > 1:
            part = torch.empty((parts, N * O * Ho * Wo), dtype=torch.float32,
                               device=dev)
    CONV_KERNEL.launch("conv2d_act_forward", [
        x, weight, bias, residual, y, part, N, H, W, C, O, kh, stride,
        int(relu), KERNEL_DTYPES[x.dtype], bn, bk, *box, parts])
    return y


def _wgmma_n(c: int) -> int:
    """The N tile of K5-dgrad and K5-wgrad's wgmma kernels for ``c``
    output channels: all of them where a wgmma width is ``c``, else the
    widest that divides ``c`` (384 -> 192, 512 and 2048 -> 256), else 64
    with a ragged edge."""
    if c in _WGMMA_N:
        return c
    return next((n for n in _WGMMA_N if c % n == 0), 64)


@functools.lru_cache(maxsize=None)
def _wgrad_parts(rows: int, cout: int, kdim: int, wgmma: bool = True):
    """(partitions, rows per partition) of K5-wgrad for a conv with
    ``rows`` = N Ho Wo, ``cout`` output channels and ``kdim`` = k^2 Cin,
    for the wgmma kernel (bf16, Cin % 8 == 0) or the mma.sync / f32
    kernels (``wgmma`` False)."""
    if wgmma:
        tiles = -(-kdim // _TILE_ROWS) * -(-cout // _wgmma_n(cout))
        step, parts = _WGRAD_HOPPER_STEP, _WGRAD_HOPPER_TILES // tiles
    else:
        tiles = -(-cout // _WGRAD_TILE) * -(-kdim // _WGRAD_TILE)
        step, parts = _WGRAD_STEP, -(-_WGRAD_BLOCKS // tiles)
    parts = max(1, min(parts, -(-rows // _WGRAD_MIN_ROWS)))
    per = -(-rows // parts)
    per = -(-per // step) * step
    return -(-rows // per), per


@functools.lru_cache(maxsize=None)
def _stem_wgrad_parts(n: int, ho: int, wo: int):
    """(partitions, runs per partition) of ``stem7_wgrad_kernel`` for dy
    (n, ho, wo, 64): run ``(i ho + h) ceil(wo / 128) + w`` holds output
    pixels ``w 128 .. min(wo, w 128 + 128) - 1`` of row h of image i;
    partition p sums runs ``[p per, (p + 1) per)`` in order."""
    runs = n * ho * -(-wo // _STEM_RUN)
    per = -(-runs // max(1, min(_STEM_WGRAD_PARTS, runs)))
    return -(-runs // per), per


class StemPlan(NamedTuple):
    """K10's forward plan for one shape: ``staged`` (each warp's input
    boxes come by TMA, which maps rows of 6 W bytes only where that is a
    multiple of 16; else the warp copies its box) on a persistent grid of
    at most ``grid`` blocks (0: the general stem kernels, which take f32
    and the other stem shapes)."""
    staged: bool
    grid: int


def stem_plan(N: int, H: int, W: int, cout: int, stride: int,
              dtype: torch.dtype) -> StemPlan:
    """K10's forward plan for x (N, 3, H, W): ``stem7_kernel`` in bf16 at
    stride 2 and 64 output channels (the ResNet's stem), staged by TMA
    where 6 W % 16 == 0; else the general stem kernels."""
    if not (dtype == torch.bfloat16 and stride == 2 and cout == 64):
        return StemPlan(False, 0)
    return StemPlan(6 * W % 16 == 0, _STEM_BLOCKS)


class DgradClass(NamedTuple):
    """A parity class of K5-dgrad: the dx pixels (ph + stride i, pw +
    stride j), i < hc, j < wc, and its taps (r, c, dh, dw): tap (r, c)
    of the weight meets dy at (i + dh, j + dw)."""
    ph: int
    pw: int
    hc: int
    wc: int
    taps: tuple


class DgradPlan(NamedTuple):
    """K5-dgrad's plan for one conv shape: N tile ``bn`` (over Cin), K
    step ``bk`` (channels of Cout within one tap), the M tile's box of dy
    ``box`` = (images, rows, columns) of a class (at most 128 pixels), K
    partitions ``parts`` and the parity classes, most taps first."""
    bn: int
    bk: int
    box: tuple
    parts: int
    classes: tuple

    def steps(self, cls: DgradClass, cout: int) -> int:
        return len(cls.taps) * -(-cout // self.bk)

    def partition(self, cls: DgradClass, cout: int, p: int) -> range:
        """The K steps of ``cls`` in partition ``p``: step s is tap
        ``s // ceil(cout / bk)`` at channels ``(s % ...) * bk`` on."""
        n = self.steps(cls, cout)
        return range(p * n // self.parts, (p + 1) * n // self.parts)


def _wgmma_pair(bn: int, bk: int, forward: bool) -> bool:
    """Whether two blocks of 128 rows of K5-conv's (``forward``) or
    K5-dgrad's wgmma kernel share an SM (``conv.cu`` gemm_pair): N tile
    <= 64 and three ring stages (the A tile and the B tile: ``bn`` rows of
    64 channels for K5-conv, ``bn / 64`` boxes of ``bk`` rows for
    K5-dgrad), the staged output tile and the alignment within half an
    SM's shared memory."""
    b_tile = bn * 128 if forward else -(-bn // 64) * bk * 128
    nbytes = (1024 + 3 * (_TILE_ROWS * 128 + b_tile)
              + _TILE_ROWS * (bn + 8) * 2 + 48)
    return bn <= 64 and nbytes <= 115712


def _pixel_box(hc: int, wc: int) -> tuple:
    """The M tile of K5-conv and K5-dgrad over an (images, hc, wc) grid of
    pixels: (images, rows, columns) of at most 128 pixels, whole rows (of
    several images where an image holds at most 64 pixels), or a run of
    128 columns of one row."""
    bw = min(wc, _TILE_ROWS)
    bh = 1 if bw < wc else min(hc, _TILE_ROWS // bw)
    bni = max(1, _TILE_ROWS // (hc * wc)) if bh == hc and bw == wc else 1
    return bni, bh, bw


def _k_parts(tiles: int, steps: int, bn: int, bk: int, pair: bool) -> int:
    """The K partitions of a launch of ``tiles`` tiles of ``steps`` K steps
    each (``_PLAN_*`` above)."""
    slots = _PLAN_SMS * (2 if pair else 1)
    # A tile's f32 partial (written, then read by the reduce) in steps of
    # its A and B tiles' bytes.
    extra = _TILE_ROWS * bn * 8 / ((_TILE_ROWS + bn) * bk * 2)
    cost = {p: -(-tiles * p // slots) * (-(-steps // p) + (p > 1) * extra)
            for p in range(1, max(1, steps // _PLAN_MIN_STEPS) + 1)}
    least = min(cost.values())
    return min(p for p, c in cost.items() if c <= _PLAN_SLACK * least)


@functools.lru_cache(maxsize=None)
def _dgrad_plan(n: int, h: int, w: int, cin: int, cout: int, k: int,
                stride: int) -> DgradPlan:
    """K5-dgrad's plan, a function of the shape alone (as the C entry
    point computes the same classes): for stride 2 the four parity
    classes of dx (a class that no tap reaches, the odd pixels of a 1x1,
    is written as zeros), for stride 1 one class with all k^2 taps."""
    pad = k // 2
    bk = next((b for b in (64, 48, 32) if cout % b == 0), 16)
    bn = _wgmma_n(cin)
    found = []
    for ph in range(stride):
        for pw in range(stride):
            taps = tuple(
                (r, c, (ph + pad - r) // stride, (pw + pad - c) // stride)
                for r in range(k) for c in range(k)
                if (ph + pad - r) % stride == 0
                and (pw + pad - c) % stride == 0)
            hc, wc = -(-(h - ph) // stride), -(-(w - pw) // stride)
            if n * hc * wc > 0:
                found.append(DgradClass(ph, pw, hc, wc, taps))
    classes = tuple(sorted(found, key=lambda c: -len(c.taps)))
    bni, bh, bw = _pixel_box(-(-h // stride), -(-w // stride))
    tiles = sum(-(-n // bni) * -(-c.hc // bh) * -(-c.wc // bw)
                for c in classes) * -(-cin // bn)
    steps = max(len(c.taps) for c in classes) * -(-cout // bk)
    parts = _k_parts(tiles, steps, bn, bk, _wgmma_pair(bn, bk, False))
    return DgradPlan(bn, bk, (bni, bh, bw), parts, classes)


class ConvPlan(NamedTuple):
    """K5-conv's plan for one bf16 conv shape with Cin % 8 == 0: N tile
    ``bn`` (over Cout), K step ``bk`` (channels of Cin within one tap), the
    M tile's box of output pixels ``box`` = (images, rows, columns; at
    most 128) and K partitions ``parts``. K step s is tap ``s // ceil(cin
    / bk)`` (r k + c, unflipped) at channels ``(s % ceil(cin / bk)) * bk``
    on; tap (r, c) of output pixel (i, j) reads x at (stride i + r - k //
    2, stride j + c - k // 2), zero outside x."""
    bn: int
    bk: int
    box: tuple
    parts: int

    def steps(self, cin: int, k: int) -> int:
        return k * k * -(-cin // self.bk)

    def partition(self, cin: int, k: int, p: int) -> range:
        """The K steps of partition ``p``."""
        n = self.steps(cin, k)
        return range(p * n // self.parts, (p + 1) * n // self.parts)


@functools.lru_cache(maxsize=None)
def _conv_plan(n: int, h: int, w: int, cin: int, cout: int, k: int,
               stride: int) -> ConvPlan:
    """K5-conv's plan (bf16, Cin % 8 == 0), a function of the shape alone
    and the constants above, never of the card: its K partitions, and so
    the output's bits, are the same on any device."""
    ho = (h + 2 * (k // 2) - k) // stride + 1
    wo = (w + 2 * (k // 2) - k) // stride + 1
    bk = next((b for b in (64, 48) if cin % b == 0), 16)
    bn = _wgmma_n(cout)
    bni, bh, bw = _pixel_box(ho, wo)
    tiles = (-(-n // bni) * -(-ho // bh) * -(-wo // bw)
             * -(-cout // bn))
    steps = k * k * -(-cin // bk)
    parts = _k_parts(tiles, steps, bn, bk, _wgmma_pair(bn, bk, True))
    return ConvPlan(bn, bk, (bni, bh, bw), parts)


def _aligned_cl(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a channels_last-contiguous tensor on a 16-byte boundary:
    a copy of an expanded cotangent (the mean pool's), of a slice (the
    concat's) or of a view at an odd offset."""
    t = t.contiguous(memory_format=torch.channels_last)
    return t if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.channels_last)


def _conv2d_wgrad_cuda(x, dy, y, weight_shape, stride, bias):
    """Kernel K5-wgrad: ``(dw, dbias or None, masked dy or None)``, dy
    masked by ``y > 0`` as it is read when ``y`` (a ReLU epilogue's
    output) is given."""
    N, C, H, W = x.shape
    O, _, k, _ = weight_shape
    Ho, Wo = dy.shape[2:]
    rows, kdim = N * Ho * Wo, k * k * C
    if max(x.numel(), dy.numel(), O * kdim) >= 2 ** 31:
        raise ValueError("conv2d_wgrad: 2^31 elements or more")
    dev, dt = x.device, x.dtype
    # Cin % 8 == 0: 16-byte rows of x (aligned here, a copy only for a view
    # at an odd offset); bf16 then runs the wgmma kernel, the stem's Cin =
    # 3 the scalar one.
    vec = int(C % 8 == 0)
    if vec:
        x = _aligned_cl(x)
    wgmma = bool(vec) and dt == torch.bfloat16
    # The ResNet's stem in bf16 runs stem7_wgrad_kernel over runs of
    # output pixels, with 16-byte copies of x's rows: decided here alone,
    # and passed to conv2d_stem_wgrad, which takes ``per`` as runs (else
    # as rows).
    runs = k == STEM_K and dt == torch.bfloat16 and stride == 2 and O == 64
    if runs:
        x = _aligned_cl(x)
        parts, per = _stem_wgrad_parts(N, Ho, Wo)
    else:
        parts, per = _wgrad_parts(rows, O, kdim, wgmma)
    part = torch.empty((parts, O, kdim), dtype=torch.float32, device=dev)
    pbias = (torch.empty((parts, O), dtype=torch.float32, device=dev)
             if bias else None)
    dw = torch.empty(tuple(weight_shape), dtype=dt, device=dev,
                     memory_format=torch.channels_last)
    db = torch.empty(O, dtype=dt, device=dev) if bias else None
    dym = None if y is None else torch.empty_like(dy)
    if k == STEM_K:  # K10's weight gradient (runs of stem7_wgrad_kernel,
        # or rows of the scalar mma.sync / f32 kernels)
        CONV_KERNEL.launch("conv2d_stem_wgrad", [
            x, dy, y, dym, part, pbias, dw, db, N, H, W, C, O, k, stride,
            parts, per, int(runs), KERNEL_DTYPES[dt]])
        return dw, db, dym
    CONV_KERNEL.launch("conv2d_wgrad", [
        x, dy, y, dym, part, pbias, dw, db, N, H, W, C, O, k, stride,
        parts, per, vec, KERNEL_DTYPES[dt], _wgmma_n(O)])
    return dw, db, dym


def _conv2d_dgrad_cuda(dy, weight, input_shape, stride):
    """Kernel K5-dgrad: the data gradient. bf16 reads the weight in place
    (:func:`_dgrad_plan`); f32 from the weight flipped in (kh, kw) and
    transposed (a small copy per call)."""
    N, C, H, W = input_shape
    O, _, k, _ = weight.shape
    if C % 8:
        raise ValueError(f"conv2d_dgrad: {C} input channels, not a multiple "
                         "of 8 (the images take no gradient)")
    if N * C * H * W >= 2 ** 31:
        raise ValueError("conv2d_dgrad: 2^31 elements or more")
    dx = torch.empty(tuple(input_shape), dtype=dy.dtype, device=dy.device,
                     memory_format=torch.channels_last)
    part, bn, bk, box, parts = None, 0, 0, (0, 0, 0), 0
    if dy.dtype == torch.float32:
        w = weight.flip((2, 3)).transpose(0, 1).contiguous(
            memory_format=torch.channels_last)
    else:
        w = _aligned_cl(weight)
        plan = _dgrad_plan(N, H, W, C, O, k, stride)
        bn, bk, box, parts = plan.bn, plan.bk, plan.box, plan.parts
        if parts > 1:
            part = torch.empty((parts, N * H * W * C), dtype=torch.float32,
                               device=dy.device)
    CONV_KERNEL.launch("conv2d_dgrad", [
        dy, w, dx, part, N, H, W, C, O, k, stride, KERNEL_DTYPES[dy.dtype],
        bn, bk, *box, parts])
    return dx


def _relu_mask_cuda(dy, y):
    """The ReLU's VJP from its saved output ``y`` on the card, for a conv
    whose weight and bias take no gradient (K5-wgrad masks dy itself)."""
    if (y.shape != dy.shape or y.dtype != dy.dtype
            or not y.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("conv2d_relu_mask: y must be channels_last like dy")
    if dy.numel() >= 2 ** 31:
        raise ValueError("conv2d_relu_mask: 2^31 elements or more")
    dym = torch.empty_like(dy)
    CONV_KERNEL.launch("conv2d_relu_mask", [dy, y, dym, dy.numel(),
                                            KERNEL_DTYPES[dy.dtype]])
    return dym


def _conv2d_backward_cuda(dy, x, weight, y, stride, need_x, need_w,
                          need_bias, need_residual):
    """The VJP of K5-conv through K5-wgrad, then K5-dgrad (on the masked
    dy that K5-wgrad wrote for a ReLU epilogue, or the mask kernel when
    neither the weight nor the bias takes a gradient): as
    :func:`conv2d_backward_plain`."""
    dy = _aligned_cl(dy)
    dw = db = None
    g = dy
    if need_w or need_bias:
        dw, db, dym = _conv2d_wgrad_cuda(x, dy, y, weight.shape, stride,
                                         need_bias)
        g = dy if dym is None else dym
    elif y is not None:
        g = _relu_mask_cuda(dy, y)
    dx = _conv2d_dgrad_cuda(g, weight, x.shape, stride) if need_x else None
    return dx, dw, db, g if need_residual else None


def _conv2d_act_any(x, weight, bias, residual, relu, stride):
    """The forward on x's device: the plain version for CPU tensors,
    K5-conv for CUDA tensors."""
    if x.device.type == "cpu":
        return conv2d_act_plain(x, weight, bias, residual, relu, stride)
    return _conv2d_act_cuda(x, weight, bias, residual, relu, stride)


class _Conv2dAct(torch.autograd.Function):
    """K5-conv with its VJP: the plain versions for CPU tensors, K5-conv,
    K5-wgrad and K5-dgrad for CUDA tensors. Saves x and the weight, and
    the output only for a ReLU epilogue (its mask, y > 0)."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, relu, stride):
        y = _conv2d_act_any(x, weight, bias, residual, relu, stride)
        ctx.stride = stride
        ctx.save_for_backward(x, weight, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, y = ctx.saved_tensors
        need_x, need_w, need_b, need_r = ctx.needs_input_grad[:4]
        backward = (conv2d_backward_plain if x.device.type == "cpu"
                    else _conv2d_backward_cuda)
        dx, dw, db, dres = backward(dy.to(x.dtype), x, weight, y,
                                    ctx.stride, need_x, need_w, need_b,
                                    need_r)
        return dx, dw, db, dres, None, None


def conv2d_act(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None = None,
               residual: torch.Tensor | None = None, relu: bool = False,
               stride: int = 1) -> torch.Tensor:
    """``relu?(conv(x, weight, stride, padding k // 2) + bias [+
    residual])`` for x (N, C, H, W) and weight (O, C, k, k) of one dtype,
    f32 or bf16: kernel K5-conv for CUDA tensors (x and residual
    channels_last, the weight OHWI, i.e. channels_last; k 1 or 3, stride 1
    or 2), :func:`conv2d_act_plain` for CPU tensors. A 7x7 kernel is taken
    only on 3 input channels and without a residual (the ResNet's stem:
    kernel K10 on the card). When a tensor argument needs a gradient it
    runs through an autograd Function whose backward is K5-wgrad (K10's
    for the stem) and K5-dgrad on the card (the data gradient needs Cin %
    8 == 0) and the plain versions on the CPU; otherwise no autograd node
    is made."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv2d_act: unsupported device {x.device}")
    if weight.shape[-1] == STEM_K and (x.shape[1] != 3
                                       or residual is not None):
        raise ValueError("conv2d_act: a 7x7 kernel only on 3 input channels "
                         "and without a residual (the ResNet stem, K10)")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, weight, bias, residual)):
        return _Conv2dAct.apply(x, weight, bias, residual, relu, stride)
    return _conv2d_act_any(x, weight, bias, residual, relu, stride)


def _pool_windows(x: torch.Tensor) -> torch.Tensor:
    """The 3x3 / stride-2 / pad-1 windows of x (N, C, H, W) as (N, C, Ho,
    Wo, 9), taps in row-major order, the padding -inf (never a maximum)."""
    xp = F.pad(x, (1, 1, 1, 1), value=float("-inf"))
    return xp.unfold(2, 3, 2).unfold(3, 3, 2).flatten(-2)


def max_pool2d_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K11's forward: the 3x3 / stride-2 / pad-1 max of x
    (N, C, H, W), as ``jax.lax.reduce_window(max, -inf)``; Ho = (H - 1) //
    2 + 1."""
    return _pool_windows(x).amax(dim=-1).contiguous(
        memory_format=torch.channels_last)


def max_pool2d_backward_plain(dy: torch.Tensor, x: torch.Tensor
                              ) -> torch.Tensor:
    """Plain version of K11's backward, the VJP of ``reduce_window`` max:
    each window's dy goes to the first maximum of the window in row-major
    order (``torch.max``'s index), never to the padding; a pixel's
    contributions are summed in f32 in the windows' row-major order and
    rounded once to dy's dtype. A pixel lies at tap row 1 of one window,
    or at tap row 2 of one window and tap row 0 of the next: adding the
    taps of rows (1, 2) before row 0, and of columns likewise, is that
    order."""
    N, C, H, W = x.shape
    Ho, Wo = dy.shape[2:]
    arg = _pool_windows(x).max(dim=-1).indices
    g = _wide(dy)
    acc = torch.zeros((N, C, 2 * Ho + 1, 2 * Wo + 1), dtype=g.dtype,
                      device=dy.device)
    first, second = (1, 2), (0,)
    for rows in (first, second):
        for cols in (first, second):
            for r in rows:
                for c in cols:
                    acc[:, :, r:r + 2 * Ho:2, c:c + 2 * Wo:2] += torch.where(
                        arg == 3 * r + c, g, torch.zeros((), dtype=g.dtype))
    return acc[:, :, 1:H + 1, 1:W + 1].to(dy.dtype).contiguous(
        memory_format=torch.channels_last)


def _pool_check(x: torch.Tensor, what: str) -> None:
    """Raise on what K11 does not take: NHWC rows of 16 bytes (C % 8 == 0
    in bf16, % 4 in f32), channels_last-contiguous, 16-byte aligned."""
    if x.dtype not in KERNEL_DTYPES or x.dim() != 4:
        raise ValueError(f"{what}: a 4-D bf16 or f32 tensor, not "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.shape[1] % (16 // x.element_size()):
        raise ValueError(f"{what}: {x.shape[1]} channels are not 16-byte "
                         "rows")
    if (not x.is_contiguous(memory_format=torch.channels_last)
            or x.data_ptr() % 16):
        raise ValueError(f"{what}: must be channels_last-contiguous and "
                         "16-byte aligned")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{what}: 2^31 elements or more")


def _max_pool2d_cuda(x: torch.Tensor) -> torch.Tensor:
    """Kernel K11's forward."""
    _pool_check(x, "max_pool2d")
    N, C, H, W = x.shape
    y = torch.empty((N, C, (H - 1) // 2 + 1, (W - 1) // 2 + 1),
                    dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    POOL_KERNEL.launch("max_pool_forward", [x, y, N, H, W, C,
                                            KERNEL_DTYPES[x.dtype]])
    return y


class PoolPlan(NamedTuple):
    """K11's backward tiles for one shape: ``th`` x ``tw`` output windows
    and a slice of ``cs`` channels a block. The kernel launches N x
    ceil(Ho / th) x ceil(Wo / tw) x C / cs blocks, the slices fastest;
    the block of windows (i0, j0) writes dx's rows 2 i0 .. 2 i0 + 2 th - 1
    and columns 2 j0 .. 2 j0 + 2 tw - 1, from windows i0 .. i0 + th and j0
    .. j0 + tw, whose taps are x's rows 2 i0 - 1 .. 2 i0 + 2 th + 1 and
    likewise in columns (its staged box)."""
    th: int
    tw: int
    cs: int


@functools.lru_cache(maxsize=None)
def max_pool_backward_plan(N: int, H: int, W: int, C: int,
                           esize: int) -> PoolPlan:
    """K11's backward tiles for x (N, C, H, W) of ``esize``-byte elements,
    from the shape alone: ``_POOL_TILE`` x ``_POOL_TILE`` windows (fewer
    where the image has fewer) and the widest channel slice of a power of
    two of 16-byte chunks that divides C within ``_POOL_SLICE_BYTES`` a
    pixel."""
    v = 16 // esize
    chunks = 1
    while C // v % (2 * chunks) == 0 and 2 * chunks * 16 <= _POOL_SLICE_BYTES:
        chunks *= 2
    ho, wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    return PoolPlan(min(_POOL_TILE, ho), min(_POOL_TILE, wo), chunks * v)


def _max_pool2d_backward_cuda(dy: torch.Tensor,
                              x: torch.Tensor) -> torch.Tensor:
    """Kernel K11's backward: dx from dy and x in one launch on the tiles
    of :func:`max_pool_backward_plan`."""
    dy = _aligned_cl(dy.to(x.dtype))
    _pool_check(dy, "max_pool2d backward")
    _pool_check(x, "max_pool2d backward")
    N, C, H, W = x.shape
    plan = max_pool_backward_plan(N, H, W, C, x.element_size())
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    POOL_KERNEL.launch("max_pool_backward", [
        dy, x, dx, N, H, W, C, KERNEL_DTYPES[x.dtype], plan.th, plan.tw,
        plan.cs])
    return dx


class _MaxPool2d(torch.autograd.Function):
    """K11 with its VJP: the plain versions for CPU tensors, the kernels
    for CUDA tensors. Saves x (the backward finds each window's maximum
    again, in one launch)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if x.device.type == "cpu":
            return max_pool2d_plain(x)
        return _max_pool2d_cuda(x)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        if x.device.type == "cpu":
            return max_pool2d_backward_plain(dy, x)
        return _max_pool2d_backward_cuda(dy, x)


def max_pool2d(x: torch.Tensor) -> torch.Tensor:
    """The ResNet's 3x3 / stride-2 / pad-1 max pool of x (N, C, H, W), f32
    or bf16: kernel K11 for CUDA tensors (channels_last, 16-byte rows),
    :func:`max_pool2d_plain` for CPU tensors; differentiable through K11's
    backward (:func:`max_pool2d_backward_plain` on the CPU)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"max_pool2d: unsupported device {x.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        return _MaxPool2d.apply(x)
    if x.device.type == "cpu":
        return max_pool2d_plain(x)
    return _max_pool2d_cuda(x)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that runs in its input's dtype: f32 master weights
    are cast to a bf16 input's dtype (a no-op once the module itself is
    bf16, as for eval), so the weight's gradient is rounded to bf16 once
    and widened, as JAX's ``w.astype(x.dtype)``. It is :func:`conv2d_act`
    (kernels K5-conv, K5-dgrad and K5-wgrad on the card) in training and
    in eval."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return conv2d_act(x, self.weight.to(x.dtype), bias,
                          stride=self.stride[0])


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1,
         bias: bool = False) -> nn.Conv2d:
    """Conv with torch-style symmetric padding ``kernel // 2``."""
    return Conv2d(in_ch, out_ch, kernel, stride, kernel // 2, bias=bias)


def conv_act(conv_mod: nn.Conv2d, bn: nn.Module | None, x: torch.Tensor,
             residual: torch.Tensor | None = None,
             relu: bool = False) -> torch.Tensor:
    """``relu?(bn(conv_mod(x)) [+ residual])``. In eval with the BN folded
    into the conv (``bn`` None or Identity) it is one :func:`conv2d_act`
    call, one K5-conv launch on the card; otherwise the separate ops."""
    if not conv_mod.training and (bn is None or isinstance(bn, nn.Identity)):
        w, bias = conv_mod.weight, conv_mod.bias
        if w.dtype != x.dtype:  # f32 master weights, a bf16 input
            w = w.to(x.dtype)
            bias = None if bias is None else bias.to(x.dtype)
        return conv2d_act(x, w, bias, residual, relu, conv_mod.stride[0])
    y = conv_mod(x)
    if bn is not None:
        y = bn(y)
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y


class ConvBN(nn.Sequential):
    """Sequential(conv, BN[, ReLU]), keys ``.0.*``, ``.1.*``, run by
    :func:`conv_act`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_act(self[0], self[1], x, relu=len(self) > 2)


class ConvBNChain(nn.Sequential):
    """(conv, BN, ReLU) triples flattened into one Sequential, keys
    ``{3i}`` conv, ``{3i+1}`` BN, each triple run by :func:`conv_act`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(0, len(self), 3):
            x = conv_act(self[i], self[i + 1], x, relu=True)
        return x


def conv_bn(in_ch, out_ch, kernel, stride=1, relu=True, bias=False):
    """ConvBN(conv, BN[, ReLU]): keys ``.0.*``, ``.1.*``."""
    layers = [conv(in_ch, out_ch, kernel, stride, bias), BatchNorm2d(out_ch)]
    if relu:
        layers.append(nn.ReLU())
    return ConvBN(*layers)


class BasicBlock(nn.Module):
    """3x3(stride)-BN-ReLU-3x3-BN + skip -> ReLU."""

    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = conv(in_ch, planes, 3, stride)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv(planes, planes, 3)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (conv_bn(in_ch, planes, 1, stride, relu=False)
                           if downsample else None)

    def forward(self, x):
        y = conv_act(self.conv1, self.bn1, x, relu=True)
        identity = x if self.downsample is None else self.downsample(x)
        return conv_act(self.conv2, self.bn2, y, identity, relu=True)


class Bottleneck(nn.Module):
    """1x1-BN-ReLU-3x3(stride)-BN-ReLU-1x1(x4)-BN + skip -> ReLU.
    ``downsample_has_bn=False`` makes the downsample a bare 1x1 conv (the
    final conv head, keys ``downsample.weight``)."""

    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False, downsample_has_bn: bool = True):
        super().__init__()
        out_ch = planes * 4
        self.conv1 = conv(in_ch, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv(planes, planes, 3, stride)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = conv(planes, out_ch, 1)
        self.bn3 = BatchNorm2d(out_ch)
        if not downsample:
            self.downsample = None
        elif downsample_has_bn:
            self.downsample = conv_bn(in_ch, out_ch, 1, stride, relu=False)
        else:
            self.downsample = conv(in_ch, out_ch, 1, stride)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = conv_act(self.conv1, self.bn1, x, relu=True)
        y = conv_act(self.conv2, self.bn2, y, relu=True)
        return conv_act(self.conv3, self.bn3, y, identity, relu=True)


def _fold_pair(conv_mod: nn.Conv2d, bn: BatchNorm2d) -> None:
    """conv(x, w) -> BN  ==  conv(x, w * scale) + bias, in f32 as
    ``bn_fold_params``: scale = gamma / sqrt(var + eps), bias = beta -
    mean * scale (+ conv bias * scale)."""
    scale = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    bias = bn.bias.float() - bn.running_mean.float() * scale
    w = conv_mod.weight
    if conv_mod.bias is not None:
        bias = bias + conv_mod.bias.float() * scale
    conv_mod.weight = nn.Parameter(
        (w.float() * scale[:, None, None, None]).to(w.dtype),
        requires_grad=w.requires_grad)
    conv_mod.bias = nn.Parameter(bias.to(w.dtype),
                                 requires_grad=w.requires_grad)


@torch.no_grad()
def fold_bn_(module: nn.Module) -> nn.Module:
    """Fold every BatchNorm into the conv that feeds it and replace the BN
    with Identity; eval only. Pairs are (convN, bnN) attributes of a block
    and adjacent (Conv2d, BatchNorm2d) entries of a Sequential."""
    for m in list(module.modules()):
        if isinstance(m, nn.Sequential):
            names = list(m._modules)
            pairs = list(zip(names[:-1], names[1:]))
        else:
            pairs = [(f"conv{k}", f"bn{k}") for k in (1, 2, 3)]
        for c, b in pairs:
            conv_mod, bn = m._modules.get(c), m._modules.get(b)
            if isinstance(conv_mod, nn.Conv2d) and isinstance(bn, BatchNorm2d):
                _fold_pair(conv_mod, bn)
                m._modules[b] = nn.Identity()
    return module
