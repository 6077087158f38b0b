"""K10's forward (the ResNet's 7x7 stem) and K11's backward (its max
pool's gradient) and the ResNet steps that run them, on two trees, in
turns on one card.

Needs one CUDA card. Each tree given is a checkout of the repository (this
one, and for instance ``git archive`` of its parent unpacked under
``chip_archive/``). For each tree in turn a subprocess with that tree first
on ``sys.path`` builds the tree's own kernels and times, as device time
from ``chip_harness.trace`` (``torch.profiler`` traces of 5 calls between
spin kernels, checked), each beside ``empty_ms``, the device time of an
empty kernel launched on the same grids (``chip_harness.empty_ms``), and
beside its library call:

* ``k10_b32``, ``k10_b128``: one K10 forward (``conv2d_act``, bf16 crops
  of 256x256, seeded weights, the folded BN's bias and the ReLU) at batch
  32 and 128 (served), ``k10_b48``: bare at 48 (a train step's);
  ``library_ms``: ``F.conv2d`` with bias (cuDNN) on the same inputs;
* ``k11b_b48``: one K11 backward at a ResNet train step's shape (48 x 64
  x 128^2 bf16, small integers after a ReLU: most windows tie);
  ``library_ms``: ``aten.max_pool2d_with_indices_backward`` given
  ``F.max_pool2d``'s indices;
* each output's ``hash`` (the raw bytes'), so that bit-equality across
  the trees shows;
* ``r50_request_b32``, ``r50_request_b128``: a ResNet-50 served request
  (``chip_harness.resnet_request``), ``r50_train``, ``r18_train``: a
  ResNet-50 and a ResNet-18 train step at 48
  (``chip_harness.resnet_train_step``): the host-clock wall over 10 (5)
  calls and, from a trace of 3, device busy time, idle share, kernels a
  step and ``conv.cu``'s and ``max_pool.cu``'s time.

With ``--hrnet-step`` it times instead the HRNet train step at 48
(``chip_harness.train_step``) with every source's device time and
kernels, the library kernels' remainder and the step's longest kernels.

The trees run in turns (``chip_harness.in_turns``, ``--rounds 2``: a b b
a), each run printing one JSON line; the last line gives each tree's
median of each number.

    python tools/perf_k10_k11_compare.py [--rounds N] [--hrnet-step] TREE ...
"""

from __future__ import annotations

import argparse
import sys

from chip_harness import in_turns

RUN = r"""
import hashlib, json, sys, torch
sys.path.insert(0, ".")
import torch.nn.functional as F
from chip_harness import (PASSES, by_source, card, empty_ms, grids,
                          resnet_request, resnet_train_step, step_numbers,
                          trace)
from shapy_tpu_torch.models.backbones import layers
from shapy_tpu_torch.utils import profiling

SOURCES = profiling._hand_kernel_sources()
dev = torch.device("cuda", 0)
cl = torch.channels_last
floors = {}


def timed(fn, src, library):
    # src's device ms and kernels per call of fn, the empty kernel's
    # device ms on the same grids, the library call's device ms
    ms = by_source(trace(fn)).get(src, [])
    empty = 0.0
    for name, grid, block in grids(fn):
        if profiling._hand_kernel(name, SOURCES) == src:
            if (grid, block) not in floors:
                floors[grid, block] = empty_ms(grid, block)
            empty += floors[grid, block]
    lib = sum(b - a for a, b, _ in trace(library)) / 1e3 / PASSES
    return {"ms": sum(ms) / PASSES, "kernels": len(ms) // PASSES,
            "empty_ms": empty, "library_ms": lib,
            "hash": hashlib.sha256(fn().cpu().contiguous().view(
                torch.uint8).numpy().tobytes()).hexdigest()[:16]}


out = {"card": card()}
gen = torch.Generator().manual_seed(7)
w = (torch.randn((64, 3, 7, 7), generator=gen) / 147 ** 0.5).to(
    dev, torch.bfloat16).contiguous(memory_format=cl)
b = (torch.randn(64, generator=gen) * 0.3).to(dev, torch.bfloat16)
with torch.inference_mode():
    for n, full in ((32, True), (128, True), (48, False)):
        x = torch.randn((n, 3, 256, 256), generator=gen).to(
            dev, torch.bfloat16).contiguous(memory_format=cl)
        bb = b if full else None
        out[f"k10_b{n}"] = timed(
            lambda: layers.conv2d_act(x, w, bb, None, full, 2), "conv.cu",
            lambda: F.conv2d(x, w, b, 2, 3))
    x = torch.randint(-2, 3, (48, 64, 128, 128), generator=gen).float()
    x = x.clamp_min(0).to(dev, torch.bfloat16).contiguous(memory_format=cl)
    dy = torch.randn((48, 64, 64, 64), generator=gen).to(
        dev, torch.bfloat16).contiguous(memory_format=cl)
    _, idx = F.max_pool2d(x, 3, 2, 1, return_indices=True)
    out["k11b_b48"] = timed(
        lambda: layers._max_pool2d_backward_cuda(dy, x), "max_pool.cu",
        lambda: torch.ops.aten.max_pool2d_with_indices_backward(
            dy, x, [3, 3], [2, 2], [1, 1], [1, 1], False, idx))
    del x, dy, idx
for n in (32, 128):
    out[f"r50_request_b{n}"] = step_numbers(resnet_request(50, n, dev), 10,
                                            "conv.cu", "max_pool.cu")
    torch.cuda.empty_cache()
for depth in (50, 18):
    out[f"r{depth}_train"] = step_numbers(resnet_train_step(depth, dev), 5,
                                          "conv.cu", "max_pool.cu")
    torch.cuda.empty_cache()
print(json.dumps(out))
"""

HRNET = r"""
import json, sys, time, torch
sys.path.insert(0, ".")
from chip_harness import card, train_step
from shapy_tpu_torch.utils import profiling

dev = torch.device("cuda", 0)
step = train_step(dev)
for _ in range(2):
    step()
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(5):
    step()
torch.cuda.synchronize()
wall = (time.perf_counter() - t0) * 1e3 / 5
traced = profiling._trace(step, "step", None)
hand = traced["hand_kernels"]
busy = traced["device_busy_ms"]
print(json.dumps({
    "card": card(), "wall_ms": wall, "busy_ms": busy,
    "idle_share_traced": traced["device_idle_share"],
    "kernels": traced["cuda_kernel_launches"],
    "sources_ms": {k: v[0] for k, v in hand.items()},
    "sources_kernels": {k: v[1] for k, v in hand.items()},
    "library_ms": busy - sum(v[0] for v in hand.values()),
    "top": [[k[:60], ms, n] for k, ms, n in traced["top_kernels_ms"][:8]]}))
"""


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--hrnet-step", action="store_true")
    parser.add_argument("trees", nargs="+")
    args = parser.parse_args(argv)
    return in_turns(HRNET if args.hrnet_step else RUN, args.trees,
                    args.rounds)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
