"""K7, the repulsion loss's forward and backward, in variants of
``csrc/repulsion.cu`` and of its plan, on one card: what holds the
kernels back.

Needs one CUDA card. Each variant is a copy of this tree's port under
``shapy_tpu_torch/_build/k7_sweep/<variant>/`` with some text replaced
(``chip_harness.planted_copy``). A subprocess per variant builds the copy
and times, as device time from ``chip_harness.trace`` (``torch.profiler``
traces of 5 calls between spin kernels, checked), K7 on phase 9's contacts
(``chip_smoke.contact_bodies``' four SMPL-X body pairs, K6's hits at 256
slots as pairs, the two bodies' triangles side by side): each device
kernel's time a call of the forward (``repulsion_loss``) and of the
backward (``torch.autograd.grad`` with a (4,) cotangent), the registers
of each kernel from ``nvcc``'s log, and the loss's and the gradient's
hashes (a variant that splits the work otherwise must keep them).

Variants: ``as_is`` (2 tangents a pass, 9 passes a pair, 4 ids a walk);
``tangents_<n>`` (n tangents a pass, 18 / n passes a pair: 1, 3, 6, 9);
``blocks_per_sm_<n>`` (the plan's pair-pass block the largest that gives n
blocks an SM: 1, 6, 12); ``list_<n>`` (n entry ids a face sorts in
registers a walk: 2, 8, 16, 32); ``fwd_no_fields`` (the forward without
its cones and fields: loads, tree and ticket alone) and ``fwd_no_ticket``
(without the ticket and the last block's sum); these two change the
outputs.

    python tools/perf_k7_sweep.py [--variants NAME ...]

Prints a JSON line a variant.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys

from chip_harness import BUILD, planted_copy, run_script

OUT = BUILD / "k7_sweep"
K7 = "shapy_tpu_torch/csrc/repulsion.cu"
K7_PY = "shapy_tpu_torch/ops/repulsion.py"


def _tangents(n: int) -> list:
    return [(K7, "constexpr int kTangents = 2;",
             f"constexpr int kTangents = {n};"),
            (K7_PY, "_PASSES = 9", f"_PASSES = {18 // n}")]


# name -> [(file, text, replacement)]
VARIANTS = {
    "as_is": [],
    **{f"tangents_{n}": _tangents(n) for n in (1, 3, 6, 9)},
    **{f"blocks_per_sm_{n}": [(K7_PY, "_PAIR_BLOCKS_PER_SM = 3",
                               f"_PAIR_BLOCKS_PER_SM = {n}")]
       for n in (1, 6, 12)},
    **{f"list_{n}": [(K7, "constexpr int kList = 4;",
                      f"constexpr int kList = {n};")] for n in (2, 8, 16, 32)},
    "fwd_no_fields": [(K7, "        f[v] = field(points[v], cone, p, inside);",
                       "        f[v] = 0.f;\n        inside = false;")],
    "fwd_no_ticket": [(
        K7, "    last = atomicAdd(tickets + b, 1u) == (unsigned)(tiles - 1);",
        "    last = false;")],
}

RUN = r"""
import hashlib, json, re, sys, torch
sys.path.insert(0, ".")
from chip_harness import PASSES, body_model, card, smoke, trace
from shapy_tpu_torch.ops.repulsion import REPULSION_KERNEL, repulsion_loss
from shapy_tpu_torch.ops.tri_tri import mesh_mesh_intersection

dev = torch.device("cuda", 0)
cs = smoke()
model, _ = body_model(dev)
bodies = cs.contact_bodies(model, dev)
with torch.no_grad():
    faces, _ = mesh_mesh_intersection(bodies["a"], bodies["b"], cs.CONTACT_M)
F = bodies["a"].shape[1]
pairs = cs.contact_pairs(faces, cs.CONTACT_M, F)
tris = torch.cat([bodies["a"], bodies["b"]], dim=1).contiguous()
x = tris.clone().requires_grad_()
cot = torch.linspace(1.0, -0.5, tris.shape[0], device=dev)
loss = repulsion_loss(x, pairs)
grad, = torch.autograd.grad(loss, x, cot, retain_graph=True)
own = REPULSION_KERNEL.device_functions()


def per_kernel(fn):
    spans = {}
    for a, b, name in trace(fn):
        key = next((k for k in own if f"{k}(" in name), name)
        spans[key] = spans.get(key, 0.0) + (b - a) / 1e3 / PASSES
    return spans


def digest(t):
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


regs = dict(re.findall(r"Compiling entry function '\w*?\d+(repulsion_\w+?)E"
                       r".*?Used (\d+) registers", REPULSION_KERNEL.build_log,
                       re.S))
print(json.dumps({
    "card": card(), "registers": regs,
    "forward": per_kernel(lambda: repulsion_loss(x, pairs)),
    "backward": per_kernel(lambda: torch.autograd.grad(loss, x, cot,
                                                       retain_graph=True)),
    "hashes": [digest(loss), digest(grad)]}))
"""


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", nargs="*", default=list(VARIANTS))
    args = parser.parse_args(argv)
    rc = 0
    for name in args.variants:
        dst = planted_copy(OUT / name, VARIANTS[name])
        proc = run_script(RUN, dst)
        shutil.rmtree(dst)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode or not lines:
            print(json.dumps({"variant": name, "rc": proc.returncode,
                              "error": proc.stderr[-2000:]}), flush=True)
            rc = 1
            continue
        row = json.loads(lines[-1])
        print(json.dumps({"variant": name, **row}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
