"""HRNet-W48 backbone as ``nn.Module``s (port of
``shapy_tpu/models/backbones/hrnet.py``, default topology).

  stem (2 x stride-2 conv-BN-ReLU, 64ch)
  -> stage1: 4 Bottleneck(64) blocks (256ch out)
  -> transition1 -> stage2: 1 module, 2 branches (48, 96)
  -> transition2 -> stage3: 4 modules, 3 branches (48, 96, 192)
  -> transition3 -> stage4: 3 modules, 4 branches (48, 96, 192, 384)
  -> head: every branch subsampled to 1/32 resolution (stride-2 convs with
     bias), concat to 1536ch, 5 Bottleneck(512) layers to 2048ch (bare 1x1
     conv downsample), global mean pool -> (B, 2048).

``state_dict`` keys equal the JAX param names. Takes NCHW input (the
regressor passes a channels_last view of its NHWC crops). The
``use_old_impl`` topology is not ported yet.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from shapy_tpu_torch.models.backbones.layers import (
    BasicBlock,
    BatchNorm2d,
    Bottleneck,
    conv,
    conv_bn,
)

# (num_modules, num_branches, num_blocks, num_channels, block)
W48_STAGES = {
    "stage1": (1, 1, (4,), (64,), "BOTTLENECK"),
    "stage2": (1, 2, (4, 4), (48, 96), "BASIC"),
    "stage3": (4, 3, (4, 4, 4), (48, 96, 192), "BASIC"),
    "stage4": (3, 4, (4, 4, 4, 4), (48, 96, 192, 384), "BASIC"),
}
_BLOCKS = {"BOTTLENECK": Bottleneck, "BASIC": BasicBlock}
HRNET_OUTPUT_DIM = 2048


def _branch_channels(stage: str) -> List[int]:
    _, _, _, chans, block = W48_STAGES[stage]
    return [c * _BLOCKS[block].expansion for c in chans]


def _block_seq(in_ch: int, block: str, planes: int, num_blocks: int):
    cls = _BLOCKS[block]
    out_ch = planes * cls.expansion
    layers = []
    for i in range(num_blocks):
        layers.append(cls(in_ch, planes, 1,
                          downsample=(i == 0 and in_ch != out_ch)))
        in_ch = out_ch
    return nn.Sequential(*layers)


def _transition(pre_ch: List[int], cur_ch: List[int]) -> nn.ModuleList:
    """Branch-count / channel adaptation between stages."""
    layers = []
    for i, c in enumerate(cur_ch):
        if i < len(pre_ch):
            layers.append(conv_bn(pre_ch[i], c, 3) if c != pre_ch[i]
                          else nn.Identity())
        else:
            hops, in_c = [], pre_ch[-1]
            for j in range(i + 1 - len(pre_ch)):
                out_c = c if j == i - len(pre_ch) else in_c
                hops.append(conv_bn(in_c, out_c, 3, 2))
                in_c = out_c
            layers.append(nn.Sequential(*hops))
    return nn.ModuleList(layers)


class HighResolutionModule(nn.Module):
    """Parallel branches + multi-resolution fusion. Fusion for target i:
    ``relu(x_i + sum_{j>i} up(bn(conv1x1(x_j))) + sum_{j<i} down_j(x_j))``
    in that order (as the JAX package sums)."""

    def __init__(self, stage: str):
        super().__init__()
        _, n, num_blocks, chans, block = W48_STAGES[stage]
        channels = _branch_channels(stage)
        self.branches = nn.ModuleList(
            _block_seq(channels[b], block, chans[b], num_blocks[b])
            for b in range(n))
        self.fuse_layers = None
        if n > 1:
            fuse = []
            for i in range(n):
                row = []
                for j in range(n):
                    if j > i:
                        row.append(nn.Sequential(
                            conv(channels[j], channels[i], 1),
                            BatchNorm2d(channels[i]),
                            nn.Upsample(scale_factor=2 ** (j - i),
                                        mode="nearest")))
                    elif j == i:
                        row.append(nn.Identity())
                    else:
                        hops = []
                        for k in range(i - j):
                            last = k == i - j - 1
                            hops.append(conv_bn(
                                channels[j],
                                channels[i] if last else channels[j],
                                3, 2, relu=not last))
                        row.append(nn.Sequential(*hops))
                fuse.append(nn.ModuleList(row))
            self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return xs
        n = len(xs)
        out = []
        for i in range(n):
            y = xs[i]
            for j in list(range(i + 1, n)) + list(range(i)):
                y = y + self.fuse_layers[i][j](xs[j])
            out.append(torch.relu(y))
        return out


def _subsample(in_ch: int, num_layers: int) -> nn.Sequential:
    """Stride-2 conv(+bias)-BN-ReLU chain doubling channels each step;
    keys ``{3i}`` conv, ``{3i+1}`` BN."""
    layers = []
    for _ in range(num_layers):
        layers += list(conv_bn(in_ch, 2 * in_ch, 3, 2, bias=True))
        in_ch *= 2
    return nn.Sequential(*layers)


class HRNet(nn.Module):
    """HRNet-W48, images (B, 3, H, W) -> features (B, 2048)."""

    def __init__(self):
        super().__init__()
        self.conv1 = conv(3, 64, 3, 2)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = conv(64, 64, 3, 2)
        self.bn2 = BatchNorm2d(64)
        self.layer1 = _block_seq(64, "BOTTLENECK", 64, 4)
        self.transition1 = _transition([256], _branch_channels("stage2"))
        self.stage2 = nn.ModuleList(
            HighResolutionModule("stage2")
            for _ in range(W48_STAGES["stage2"][0]))
        self.transition2 = _transition(_branch_channels("stage2"),
                                       _branch_channels("stage3"))
        self.stage3 = nn.ModuleList(
            HighResolutionModule("stage3")
            for _ in range(W48_STAGES["stage3"][0]))
        self.transition3 = _transition(_branch_channels("stage3"),
                                       _branch_channels("stage4"))
        self.stage4 = nn.ModuleList(
            HighResolutionModule("stage4")
            for _ in range(W48_STAGES["stage4"][0]))
        c4 = _branch_channels("stage4")
        self.subsample_4 = _subsample(c4[0], 3)
        self.subsample_3 = _subsample(c4[1], 2)
        self.subsample_2 = _subsample(c4[2], 1)
        self.conv_layers = nn.Sequential(*[
            Bottleneck(4 * c4[3] if i == 0 else 2048, 512, 1,
                       downsample=True, downsample_has_bn=False)
            for i in range(5)])

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator,
                      std: float = 0.001) -> None:
        """The JAX package's init: conv weights normal(0, std), conv
        biases 0, unit BN (``hrnet_init``)."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()

    @staticmethod
    def _transition_forward(layers, xs):
        out = []
        for i, layer in enumerate(layers):
            out.append(layer(xs[i] if i < len(xs) else xs[-1]))
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        x = self.layer1(x)
        xs = self._transition_forward(self.transition1, [x])
        for m in self.stage2:
            xs = m(xs)
        xs = self._transition_forward(self.transition2, xs)
        for m in self.stage3:
            xs = m(xs)
        xs = self._transition_forward(self.transition3, xs)
        for m in self.stage4:
            xs = m(xs)
        feat = torch.cat([self.subsample_4(xs[0]), self.subsample_3(xs[1]),
                          self.subsample_2(xs[2]), xs[3]], dim=1)
        feat = self.conv_layers(feat)
        return feat.mean(dim=(2, 3))
