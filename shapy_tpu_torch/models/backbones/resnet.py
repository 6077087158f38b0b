"""ResNet backbones (18/34/50/101/152) as ``nn.Module``s (port of
``shapy_tpu/models/backbones/resnet.py``).

  stem: 7x7 / stride-2 conv-BN-ReLU (64ch), 3x3 / stride-2 max pool
  -> layer1..4: BasicBlocks (18, 34) or Bottlenecks (50, 101, 152), the
     first block of layers 2-4 at stride 2 with a 1x1 conv-BN downsample
  -> global mean pool -> (B, 512) or (B, 2048).

``state_dict`` keys are torchvision's (``conv1``, ``bn1``,
``layer1.0.conv1``, ``layer2.0.downsample.0`` ...) without ``fc``, which
are the JAX package's param names. Takes NCHW input (the regressor passes
a channels_last view of its NHWC crops). On the card the stem's conv is
kernel K10 and the max pool kernel K11 (``layers.max_pool2d``); every
other conv is one K5-conv launch (in eval with the folded BN's bias, the
residual and the ReLU fused), and in training each BN is K4. ResNet-50
runs 52 K5-conv, 1 K10 and 1 K11 launches a forward; a train step adds
52 K5-dgrad, 52 K5-wgrad, K10's weight gradient, K11's backward and 53
K4 forwards and backwards.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

from shapy_tpu_torch.models.backbones.layers import (
    BasicBlock,
    BatchNorm2d,
    Bottleneck,
    conv,
    conv_act,
    max_pool2d,
)

RESNET_LAYERS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}
RESNET_FEAT_DIM = {18: 512, 34: 512, 50: 2048, 101: 2048, 152: 2048}


class ResNet(nn.Module):
    """ResNet-``depth``, images (B, 3, H, W) -> a dict of ``layer1`` ..
    ``layer4``, ``avg_pooling`` (B, feat) and ``concat`` (the same), as
    ``resnet_forward``."""

    def __init__(self, depth: int = 50):
        super().__init__()
        if depth not in RESNET_LAYERS:
            raise ValueError(f"ResNet depth {depth}: one of "
                             f"{sorted(RESNET_LAYERS)}")
        self.depth = depth
        kind, layers = RESNET_LAYERS[depth]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = conv(3, 64, 7, 2)
        self.bn1 = BatchNorm2d(64)
        in_ch, planes = 64, 64
        for stage, count in enumerate(layers):
            stride = 1 if stage == 0 else 2
            blocks = []
            for b in range(count):
                s = stride if b == 0 else 1
                out_ch = planes * block.expansion
                blocks.append(block(in_ch, planes, s, downsample=b == 0 and (
                    s != 1 or in_ch != out_ch)))
                in_ch = out_ch
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            planes *= 2

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator,
                      std: float = 0.001) -> None:
        """The JAX package's init (``resnet_init``): conv weights normal(0,
        std), unit BN."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, std, generator=generator)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = conv_act(self.conv1, self.bn1, x, relu=True)
        x = max_pool2d(x)
        out = {}
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
            out[f"layer{stage}"] = x
        # The mean in x's dtype, as jnp.mean of the bf16 map (f32 sum,
        # one rounding).
        out["avg_pooling"] = x.mean(dim=(2, 3))
        out["concat"] = out["avg_pooling"]
        return out


def import_resnet_state_dict(resnet: ResNet, state_dict: Mapping) -> ResNet:
    """Load a torchvision ResNet ``state_dict`` into ``resnet``, as the JAX
    package's ``import_resnet_state_dict`` converts one: ``fc.*`` and the
    ``num_batches_tracked`` counters (the port's BN keeps none) dropped,
    every other key must land and every parameter be loaded."""
    resnet.load_state_dict({
        k: torch.as_tensor(v) for k, v in state_dict.items()
        if not k.startswith("fc.") and not k.endswith("num_batches_tracked")})
    return resnet
