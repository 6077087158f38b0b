"""K3 (skinning, forward and backward) and the steps that run it, on two
trees, in turns on one card.

Needs one CUDA card. Each tree given is a checkout of the repository (this
one, and for instance ``git archive`` of its parent unpacked under
``chip_archive/``). For each tree in turn a subprocess with that tree first
on ``sys.path`` builds the tree's own kernels and times:

* ``fwd_b32``, ``fwd_b48``: the device time of one K3 forward
  (``skin``) at batch 32 (a served batch) and 48 (a train step's) on the
  flagship's body model (synthetic SMPL-X at the real template's counts,
  10475 vertices, 55 joints), posed bodies as ``chip_smoke.py`` makes
  them, and the ``skinning.cu`` kernels a call;
* ``bwd_b48``: the same for one K3 backward at batch 48 (every
  ``skinning.cu`` kernel of one ``torch.autograd.grad`` call, summed);
* ``eval_step``: the flagship's eval step at batch 32 as
  ``utils/profiling.py`` builds it (HRNet-W48, bf16 backbone, random
  weights from a seed; the served request, the metrics against synthetic
  GT and the one device-to-host copy): the host-clock wall over 10 steps
  after a synchronise and, from a ``torch.profiler`` trace of 3 steps
  (``utils/profiling._trace``), device busy time, idle share, kernels a
  step and ``skinning.cu``'s time;
* ``train_step``: the same for one train step at batch 48 as
  ``utils/profiling.py --train`` builds it (5 steps on the host clock).

K3's device times come from ``chip_harness.trace`` (``torch.profiler``
traces of 5 calls between spin kernels, checked). The trees run in turns
(``chip_harness.in_turns``, ``--rounds 3``: a b b a a b), each run
printing one JSON line; the last line gives each tree's median of each
number.

    python tools/perf_k3_compare.py [--rounds N] TREE [TREE ...]
"""

from __future__ import annotations

import argparse
import sys

from chip_harness import in_turns

RUN = r"""
import json, sys, torch
sys.path.insert(0, ".")
from chip_harness import (PASSES, by_source, card, eval_step, flagship,
                          step_numbers, trace, train_step)
from shapy_tpu_torch.core.kinematics import batch_rigid_transform
from shapy_tpu_torch.core.rotations import aa_to_rotmat
from shapy_tpu_torch.models.body.lbs import skin

SRC = "skinning.cu"
dev = torch.device("cuda", 0)


def skin_ms(fn):
    # skinning.cu's device ms and kernels per call of fn
    ms = by_source(trace(fn)).get(SRC, [])
    return {"ms": sum(ms) / PASSES, "kernels": len(ms) // PASSES}


out = {"card": card()}
reg = flagship()
model = reg.model.to(dev)
W = model.lbs_weights
gen = torch.Generator().manual_seed(1)


def posed(Bk):
    betas = (torch.randn((Bk, model.num_betas), generator=gen) * 1.5).to(dev)
    v_shaped = model.forward_shape(betas)["v_shaped"]
    joints = torch.matmul(model.J_regressor, v_shaped)
    aa = (torch.randn((Bk, model.num_joints, 3), generator=gen) * 0.3)
    _, rel, _ = batch_rigid_transform(aa_to_rotmat(aa.to(dev)), joints,
                                      model.parents, model.levels)
    v_posed = v_shaped + 0.01 * torch.randn(v_shaped.shape,
                                            generator=gen).to(dev)
    return rel.contiguous(), v_posed.contiguous()


with torch.no_grad():
    for Bk in (32, 48):
        rel, vp = posed(Bk)
        out[f"fwd_b{Bk}"] = skin_ms(lambda: skin(W, rel, vp))
rel, vp = posed(48)
a, b = rel.clone().requires_grad_(), vp.clone().requires_grad_()
dv = torch.randn(vp.shape, generator=gen).to(dev)
y = skin(W, a, b)
out["bwd_b48"] = skin_ms(lambda: torch.autograd.grad(y, (a, b), dv,
                                                     retain_graph=True))
del a, b, y

step = eval_step(reg, dev)
with torch.inference_mode():
    out["eval_step"] = step_numbers(step, 10, SRC)
del step, reg, model
torch.cuda.empty_cache()
out["train_step"] = step_numbers(train_step(dev), 5, SRC)
print(json.dumps(out))
"""


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("trees", nargs="+")
    args = parser.parse_args(argv)
    return in_turns(RUN, args.trees, args.rounds)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
