"""Conv-net building blocks with the JAX package's param names (port of
``shapy_tpu/models/backbones/layers.py``).

Modules are named so that ``state_dict`` keys equal the JAX param names
(``stage2.0.branches.1.3.conv2.weight`` ...), i.e. the reference torch
names. Conv weights are OIHW here and HWIO in the JAX package
(``io/from_jax.py`` transposes).

BatchNorm is eval-only for now (the slice does not train), and
:func:`fold_bn_` folds each BN into the conv before it at load time, as
the JAX package's eval forward does (``bn_fold_params``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


class BatchNorm2d(nn.Module):
    """Eval-mode BatchNorm with the torch param names and no
    ``num_batches_tracked`` (the JAX params have none)."""

    def __init__(self, c: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1,
         bias: bool = False) -> nn.Conv2d:
    """Conv with torch-style symmetric padding ``kernel // 2``."""
    return nn.Conv2d(in_ch, out_ch, kernel, stride, kernel // 2, bias=bias)


def conv_bn(in_ch, out_ch, kernel, stride=1, relu=True, bias=False):
    """Sequential(conv, BN[, ReLU]): keys ``.0.*``, ``.1.*``."""
    layers = [conv(in_ch, out_ch, kernel, stride, bias), BatchNorm2d(out_ch)]
    if relu:
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


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
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


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
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


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
