"""K2 (crop and normalise) and K3-chain (the kinematic chain, forward and
backward) and the steps that run them, on two trees, in turns on one card.

Needs one CUDA card. Each tree given is a checkout of the repository (this
one, and for instance ``git archive`` of its parent unpacked under
``chip_archive/``). For each tree in turn a subprocess with that tree first
on ``sys.path`` builds the tree's own kernels and times, as device time
from ``chip_harness.trace`` (``torch.profiler`` traces of 5 calls between
spin kernels, checked), each beside ``empty_ms``, the device time of an
empty kernel launched on the same grids (``chip_harness.empty_ms``):

* ``k2_b32``, ``k2_b128``: one K2 call (``crop_normalize``, uint8 images
  of 480x360 -> bf16 crops of 256x256) on the served requests
  (``flagship.synthetic_requests``) at batch 32 and 128; ``grid_sample_b32``
  / ``_b128``: ``F.grid_sample`` (bilinear, zero padding,
  ``align_corners=True``) on an f32 NCHW copy of the same images, a
  yardstick for the crop alone (not the same function: no uint8 decode,
  normalisation or cast);
* ``chain_fwd_b32``, ``chain_fwd_b48``: one K3-chain forward on the
  flagship's body model (synthetic SMPL-X, 55 joints in 6 levels; joints
  from seeded betas, rotations of 0.3 rad a joint) at batch 32 (a served
  batch) and 48 (a train step's); ``chain_bwd_b48``: one backward at 48
  (every ``kinematic_chain.cu`` kernel of one ``torch.autograd.grad``);
  ``smplx_fwd_b48``, ``smplx_bwd_b48``: the same on the published SMPL-X
  tree (55 joints in 11 levels, ``chip_smoke.SMPLX_PARENTS``);
* ``eval_step``: the flagship's eval step at batch 32
  (``chip_harness.eval_step``): the host-clock wall over 10 steps and,
  from a trace of 3, device busy time, idle share, kernels a step and
  ``ingest.cu``'s and ``kinematic_chain.cu``'s time;
* ``train_step``: the same for one HRNet train step at batch 48 (5 steps
  on the host clock).

The trees run in turns (``chip_harness.in_turns``, ``--rounds 2``: a b b
a), each run printing one JSON line; the last line gives each tree's
median of each number.

    python tools/perf_k2_chain_compare.py [--rounds N] TREE [TREE ...]
"""

from __future__ import annotations

import argparse
import sys

from chip_harness import in_turns

RUN = r"""
import json, sys, torch
sys.path.insert(0, ".")
import torch.nn.functional as F
from chip_harness import (PASSES, by_source, card, empty_ms, eval_step,
                          flagship, grids, smoke, step_numbers, trace,
                          train_step)
from shapy_tpu_torch.core.kinematics import batch_rigid_transform
from shapy_tpu_torch.core.rotations import aa_to_rotmat
from shapy_tpu_torch.data.crop import crop_normalize
from shapy_tpu_torch.flagship import synthetic_requests
from shapy_tpu_torch.utils import profiling

K2, CHAIN = "ingest.cu", "kinematic_chain.cu"
SOURCES = profiling._hand_kernel_sources()
dev = torch.device("cuda", 0)
floors = {}


def timed(fn, src):
    # src's device ms and kernels per call of fn, and the empty kernel's
    # device ms on the same grids
    ms = by_source(trace(fn)).get(src, [])
    empty = 0.0
    for name, grid, block in grids(fn):
        if profiling._hand_kernel(name, SOURCES) == src:
            if (grid, block) not in floors:
                floors[grid, block] = empty_ms(grid, block)
            empty += floors[grid, block]
    return {"ms": sum(ms) / PASSES, "kernels": len(ms) // PASSES,
            "empty_ms": empty}


def device_ms(fn):
    return sum(b - a for a, b, _ in trace(fn)) / 1e3 / PASSES


out = {"card": card()}
with torch.no_grad():
    for Bk in (32, 128):
        images, affines = synthetic_requests(Bk, 360, 480, 256, seed=0)
        images = torch.from_numpy(images).to(dev)
        affines = torch.from_numpy(affines).to(dev)
        out[f"k2_b{Bk}"] = timed(lambda: crop_normalize(
            images, affines, 256, out_dtype=torch.bfloat16), K2)
        x = images.permute(0, 3, 1, 2).float() / 255.0
        g = torch.arange(256, dtype=torch.float32, device=dev)
        gy, gx = torch.meshgrid(g, g, indexing="ij")
        A = affines[:, :2, :, None, None]
        src = A[:, :, 0] * gx + A[:, :, 1] * gy + A[:, :, 2]  # (B, 2, S, S)
        scale = torch.tensor([2 / (480 - 1), 2 / (360 - 1)], device=dev)
        grid = (src.permute(0, 2, 3, 1) * scale - 1).contiguous()
        out[f"grid_sample_b{Bk}"] = device_ms(lambda: F.grid_sample(
            x, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True))

reg = flagship()
model = reg.model.to(dev)
gen = torch.Generator().manual_seed(1)


def chain_inputs(Bk):
    betas = (torch.randn((Bk, model.num_betas), generator=gen) * 1.5).to(dev)
    joints = torch.matmul(model.J_regressor,
                          model.forward_shape(betas)["v_shaped"]).contiguous()
    aa = torch.randn((Bk, model.num_joints, 3), generator=gen) * 0.3
    rot = aa_to_rotmat(aa.to(dev)).contiguous()
    cts = [torch.randn(s, generator=gen).to(dev) for s in
           (joints.shape, (Bk, model.num_joints, 4, 4),
            (Bk, model.num_joints, 4, 4))]
    return rot, joints, cts


for name, parents in (("", model.parents), ("smplx_",
                                             smoke().SMPLX_PARENTS)):
    for Bk in (32, 48) if not name else (48,):
        rot, joints, cts = chain_inputs(Bk)
        with torch.no_grad():
            out[f"{name or 'chain_'}fwd_b{Bk}"] = timed(
                lambda: batch_rigid_transform(rot, joints, parents), CHAIN)
    r, j = rot.clone().requires_grad_(), joints.clone().requires_grad_()
    y = batch_rigid_transform(r, j, parents)
    out[f"{name or 'chain_'}bwd_b48"] = timed(
        lambda: torch.autograd.grad(y, (r, j), cts, retain_graph=True), CHAIN)
    del r, j, y

step = eval_step(reg, dev)
with torch.inference_mode():
    out["eval_step"] = step_numbers(step, 10, K2, CHAIN)
del step, reg, model
torch.cuda.empty_cache()
out["train_step"] = step_numbers(train_step(dev), 5, K2, CHAIN)
print(json.dumps(out))
"""


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("trees", nargs="+")
    args = parser.parse_args(argv)
    return in_turns(RUN, args.trees, args.rounds)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
