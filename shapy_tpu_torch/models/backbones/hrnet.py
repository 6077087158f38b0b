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
regressor passes a channels_last view of its NHWC crops). The module's
train / eval mode is the JAX ``train`` flag: every BN, the fuse and
transition layers' included, normalises with batch moments and updates
its running stats in training (kernel K4 on the card). Every conv is one
K5-conv launch on the card (``layers.conv2d_act``; in eval with the folded
BN's bias, the residual and the ReLU fused), and each fusion target one
K5-fuse launch (:func:`hr_fuse`, ``csrc/hr_fuse.cu``): 331 and 26 per
forward, in training and in eval. A train step's backward adds 330
K5-dgrad (every conv but the stem's first: the images take no gradient),
331 K5-wgrad and 26 K5-fuse backward launches. ``nn.Upsample`` stays in
``fuse_layers`` for the ``state_dict`` layout only. The ``use_old_impl``
topology is not ported yet.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from shapy_tpu_torch.models.backbones.layers import (
    KERNEL_DTYPES,
    BasicBlock,
    BatchNorm2d,
    Bottleneck,
    ConvBNChain,
    _aligned_cl,
    _wide,
    conv,
    conv_act,
    conv_bn,
    relu_mask_plain,
)
from shapy_tpu_torch.utils.cuda_kernels import CudaKernel

FUSE_KERNEL = CudaKernel("hr_fuse.cu", {
    "hr_fuse_forward": "ppppp iiii iiii i p",
    "hr_fuse_backward": "pppppp iii i iiii i ii p",
})
_MAX_FUSE_TERMS = 3
_FUSE_BWD_THREADS = 256  # hr_fuse.cu's kThreads


class FuseBackwardPlan(NamedTuple):
    """The tiles of K5-fuse's backward for one target (from the shape
    alone): a block owns ``2 ** shift`` rows (``shift`` the largest of the
    terms') x ``tw`` micro boxes of ``side`` x ``side`` pixels x ``cs``
    channel vectors of 16 bytes; ``grid`` = (images x row tiles x
    ``col_tiles``, channel slices), ``threads`` a block."""

    shift: int
    side: int
    cs: int
    tw: int
    col_tiles: int
    grid: Tuple[int, int]
    threads: int


def hr_fuse_backward_plan(N: int, C: int, H: int, W: int,
                          shifts: Sequence[int],
                          element_size: int) -> FuseBackwardPlan:
    """K5-fuse's backward tiles (``csrc/hr_fuse.cu``): aligned to the box
    of the largest shift S, whose 2^S rows a block holds (2^S / side rows
    of micro boxes, side 2 for S > 0, else 1). The channel slice is the
    largest divisor of the channel vectors that lets a block hold one box
    column; then as many box columns as divide the row and fit 256
    threads."""
    S = max(shifts, default=0)
    if (C * element_size % 16 or H % (1 << S) or W % (1 << S)
            or min(shifts, default=0) < 0 or S > 3):
        raise ValueError(f"hr_fuse backward: {C} channels at {H}x{W} with "
                         f"shifts {tuple(shifts)}")
    side = 2 if S > 0 else 1
    rows = (1 << S) // side
    cv = C * element_size // 16
    cs = max(d for d in range(1, cv + 1)
             if cv % d == 0 and rows * rows * d <= _FUSE_BWD_THREADS)
    wm = W // side
    tw = max(k for k in range(rows, wm + 1, rows)
             if wm % k == 0 and rows * k * cs <= _FUSE_BWD_THREADS)
    col_tiles = wm // tw
    return FuseBackwardPlan(S, side, cs, tw, col_tiles,
                            (N * (H >> S) * col_tiles, cv // cs),
                            rows * tw * cs)


def hr_fuse_plain(x: torch.Tensor,
                  terms: Sequence[Tuple[torch.Tensor, int]]) -> torch.Tensor:
    """Plain version of K5-fuse: ``relu(x + up(t_0) + up(t_1) + ...)``
    with eager adds in the terms' order, each ``(t, s)`` upsampled by
    ``2 ** s`` (nearest, as ``nn.Upsample``) when s > 0."""
    y = x
    for t, s in terms:
        if s:
            t = F.interpolate(t, scale_factor=2 ** s, mode="nearest")
        y = y + t
    return torch.relu(y)


def hr_fuse_backward_plain(dy: torch.Tensor, y: torch.Tensor,
                           shifts: Sequence[int]):
    """Plain version of K5-fuse's backward: ``(dx, [dt_j])`` with ``dx =
    dy (y > 0)`` and each term's gradient the ``2 ** s`` x ``2 ** s`` box
    sum of dx (the adjoint of the nearest upsample; dx itself for s = 0),
    summed in f32 (f64 stays) in the kernel's tree, 2x2 = (g00 + g01) +
    (g10 + g11), then each coarser box from four of the last in the same
    order, and rounded once."""
    g = relu_mask_plain(dy, y)
    sums = [g]
    acc = _wide(g)
    for _ in range(max(shifts, default=0)):
        acc = ((acc[:, :, 0::2, 0::2] + acc[:, :, 0::2, 1::2])
               + (acc[:, :, 1::2, 0::2] + acc[:, :, 1::2, 1::2]))
        sums.append(acc)
    return g, [g.clone() if s == 0 else sums[s].to(dy.dtype) for s in shifts]


def _hr_fuse_cuda(x, terms):
    """Kernel K5-fuse; raises on what it does not take."""
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"hr_fuse: dtype {x.dtype}")
    N, C, H, W = x.shape
    if len(terms) > _MAX_FUSE_TERMS or C % 8:
        raise ValueError(f"hr_fuse: {len(terms)} terms, {C} channels")
    cl = torch.channels_last
    if not x.is_contiguous(memory_format=cl) or x.data_ptr() % 16:
        raise ValueError("hr_fuse: x must be channels_last-contiguous")
    ptrs, shifts = [None] * _MAX_FUSE_TERMS, [0] * _MAX_FUSE_TERMS
    for j, (t, s) in enumerate(terms):
        if (H >> s << s != H or W >> s << s != W
                or t.shape != (N, C, H >> s, W >> s) or t.dtype != x.dtype
                or t.device != x.device or t.data_ptr() % 16
                or not t.is_contiguous(memory_format=cl)):
            raise ValueError(f"hr_fuse: term {j} {tuple(t.shape)} (shift "
                             f"{s}) for x {tuple(x.shape)}")
        ptrs[j], shifts[j] = t, s
    y = torch.empty_like(x, memory_format=cl)
    FUSE_KERNEL.launch("hr_fuse_forward", [
        x, *ptrs, y, *shifts, len(terms), N, H, W, C, KERNEL_DTYPES[x.dtype]])
    return y


def _hr_fuse_backward_cuda(dy, y, shifts):
    """K5-fuse's backward kernel: as :func:`hr_fuse_backward_plain`, in
    :func:`hr_fuse_backward_plan`'s tiles."""
    cl = torch.channels_last
    dy = _aligned_cl(dy)
    N, C, H, W = y.shape
    plan = hr_fuse_backward_plan(N, C, H, W, shifts, y.element_size())
    dx = torch.empty_like(y, memory_format=cl)
    grads = [torch.empty((N, C, H >> s, W >> s), dtype=y.dtype,
                         device=y.device, memory_format=cl) for s in shifts]
    ptrs = (grads + [None] * _MAX_FUSE_TERMS)[:_MAX_FUSE_TERMS]
    pad = (list(shifts) + [0] * _MAX_FUSE_TERMS)[:_MAX_FUSE_TERMS]
    FUSE_KERNEL.launch("hr_fuse_backward", [
        dy, y, dx, *ptrs, *pad, len(shifts), N, H, W, C,
        KERNEL_DTYPES[y.dtype], plan.cs, plan.tw])
    return dx, grads


def _hr_fuse_any(x, terms):
    """The forward on x's device: the plain version for CPU tensors,
    K5-fuse for CUDA tensors."""
    if x.device.type == "cpu":
        return hr_fuse_plain(x, terms)
    return _hr_fuse_cuda(x, terms)


class _HrFuse(torch.autograd.Function):
    """K5-fuse with its VJP: the plain versions for CPU tensors, K5-fuse
    and its backward kernel for CUDA tensors. Saves the output (its ReLU
    mask), which the next layer saves anyway."""

    @staticmethod
    def forward(ctx, x, shifts, *ts):
        y = _hr_fuse_any(x, list(zip(ts, shifts)))
        ctx.shifts = shifts
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        backward = (hr_fuse_backward_plain if y.device.type == "cpu"
                    else _hr_fuse_backward_cuda)
        dx, grads = backward(dy.to(y.dtype), y, ctx.shifts)
        return (dx, None, *grads)


def hr_fuse(x: torch.Tensor,
            terms: Sequence[Tuple[torch.Tensor, int]]) -> torch.Tensor:
    """One fusion target of HRNet: ``relu(x + sum of terms)`` where term
    ``(t, s)`` is read at ``(h >> s, w >> s)``, i.e. upsampled by ``2 **
    s`` (nearest). x (N, C, H, W) and the terms of one dtype, f32 or bf16:
    kernel K5-fuse for CUDA tensors (channels_last, C % 8 == 0, at most 3
    terms, shifts up to 3), :func:`hr_fuse_plain` for CPU tensors. When a
    tensor needs a gradient it runs through an autograd Function whose
    backward is K5-fuse's backward kernel on the card and
    :func:`hr_fuse_backward_plain` on the CPU; otherwise no autograd node
    is made."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hr_fuse: unsupported device {x.device}")
    terms = list(terms)
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for t, _ in terms)):
        return _HrFuse.apply(x, tuple(s for _, s in terms),
                             *(t for t, _ in terms))
    return _hr_fuse_any(x, terms)

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
    in that order (as the JAX package sums): one :func:`hr_fuse` per
    target, which reads the 1x1 convs' outputs (BN folded in eval, K4's BN
    after them in training) at their own resolution."""

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
        return self.fuse(xs)

    def fuse(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """The multi-resolution fusion of the branches' outputs."""
        n = len(xs)
        out = []
        for i in range(n):
            row = self.fuse_layers[i]
            order = list(range(i + 1, n)) + list(range(i))
            # row[j] for j > i is (conv, BN, Upsample): the upsample is
            # folded into hr_fuse's read.
            terms = [(conv_act(row[j][0], row[j][1], xs[j]), j - i) if j > i
                     else (row[j](xs[j]), 0) for j in order]
            out.append(hr_fuse(xs[i], terms))
        return out


def _subsample(in_ch: int, num_layers: int) -> nn.Sequential:
    """Stride-2 conv(+bias)-BN-ReLU chain doubling channels each step;
    keys ``{3i}`` conv, ``{3i+1}`` BN."""
    layers = []
    for _ in range(num_layers):
        layers += list(conv_bn(in_ch, 2 * in_ch, 3, 2, bias=True))
        in_ch *= 2
    return ConvBNChain(*layers)


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
        x = conv_act(self.conv1, self.bn1, x, relu=True)
        x = conv_act(self.conv2, self.bn2, x, relu=True)
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
