"""K3's forward and backward at the flagship's shapes, in variants of its
source and of its plan, on one card.

Needs one CUDA card. Each variant is a copy of the port under
``shapy_tpu_torch/_build/k3_sweep/<variant>/`` whose ``csrc/skinning.cu``
has some text replaced (``chip_harness.planted_copy``), and whose
``skin_plan`` may be overridden. A subprocess per variant builds the copy
and times, as device time from ``chip_harness.trace`` (``torch.profiler``
traces of 5 calls between spin kernels, checked): the forward at batch
32 and 48 and the backward at batch 48 (both its kernels, and each alone)
on SMPL-X's shapes (10475 vertices, 55 joints; dense random weights,
rigid transforms, bodies of ~1 m). Variants that change the arithmetic
give wrong outputs: they time a part of the kernel, nothing else.

    python tools/perf_k3_sweep.py [--variants NAME ...]

Variants (``VARIANTS``): ``as_is``; ``run_R`` (R bodies a block, in both
kernels; above 4 with the kernels' ``kMaxRun`` raised to 8);
``bwd_tiles_T`` (the backward's tiles a partition); ``no_rebuild`` (the
backward without rebuilding the transforms, taken as zero), the cost
that saving the forward's transforms would trade for 48 B a vertex
written and read; ``no_dA`` (the backward without its d A sums);
``fwd_no_sums`` (the forward's staging and stores alone);
``bwd_no_unroll`` (the d A loop not unrolled); ``bwd_loads_early`` (the
backward's v_posed and dv loaded before the transforms are rebuilt, not
after); ``fwd_quarter_weights`` (a quarter of each weight tile staged:
the staging's share of the time); ``fwd_vp_late`` (the forward's v_posed
loaded after its sums, not before); ``bwd_one_stage`` (one weight tile in
flight, not two: 3 blocks an SM, 3 tiles a partition); ``fwd_bounds_256``
(the forward compiled for blocks of 256 threads, as with ``kMaxRun`` 8,
its runs still of 4). Prints a JSON line a variant, with each kernel's
registers from the copy's build.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys

from chip_harness import BUILD, planted_copy, run_script

OUT = BUILD / "k3_sweep"
SKIN = "shapy_tpu_torch/csrc/skinning.cu"

_REBUILD = "      transform_sums(T, ws + lane * J, As + w * J * 12, J);\n"
_DA_LOOP = "      for (int v = s; v < nv; v += S) {\n"
_FWD_SUMS = ("  float T[4][12];\n"
             "  transform_sums(T, ws + lane * J, As + w * J * 12, J);\n")
_LOADS = """      float vp[4][3], dv[4][3];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int v = min(lane + 32 * k, nv - 1);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          vp[k][c] = v_posed[o + v * 3 + c];
          dv[k][c] = grad_out[o + v * 3 + c];
        }
      }
"""
_VP = """  float vp[4][3];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int v = min(lane + 32 * k, nv - 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) vp[k][c] = v_posed[o + v * 3 + c];
  }
"""
_ZERO_T = ("#pragma unroll\n  for (int k = 0; k < 4; ++k)\n#pragma unroll\n"
           "    for (int e = 0; e < 12; ++e) T[k][e] = 0.f;\n")

# The backward with one weight tile in flight: the next tile staged after
# this one is summed, into the same buffer.
_ONE_STAGE = [
    ("  float* As = smem + 2 * kTile * J;  // run x J x 12\n",
     "  float* As = smem + kTile * J;\n"),
    ("    const float* ws = ws0 + (t - t0) % 2 * kTile * J;\n"
     "    if (t + 1 < t1) {\n",
     "    const float* ws = ws0;\n    if (false) {\n"),
    ("    __syncthreads();  // ws and gs are written again by the next tile\n",
     "    __syncthreads();\n    if (t + 1 < t1) {\n"
     "      stage_weights(ws0, weights, v0 + kTile,\n"
     "                    min(kTile, V - v0 - kTile), J);\n"
     "      cp_async_commit();\n    }\n"),
    ("  const size_t smem = sizeof(float) * (size_t)(2 * kTile * J + "
     "run * J * 12 +\n",
     "  const size_t smem = sizeof(float) * (size_t)(kTile * J + "
     "run * J * 12 +\n"),
]
_RUN_8 = [("constexpr int kMaxRun = 4;", "constexpr int kMaxRun = 8;")]
_FWD_BOUNDS_256 = [(
    "__global__ void __launch_bounds__(32 * kMaxRun) skin_forward_kernel(",
    "__global__ void __launch_bounds__(256) skin_forward_kernel(")]

# name -> ([(text, replacement)] in skinning.cu, {plan field: value})
VARIANTS = {
    "as_is": ([], {}),
    **{f"run_{r}": (_RUN_8 if r > 4 else [], {"run": r}) for r in (2, 6, 8)},
    **{f"bwd_tiles_{t}": ([], {"tiles_per_part": t}) for t in (2, 3, 6)},
    "no_rebuild": ([(_REBUILD, "  " + _ZERO_T.replace("\n  ", "\n    "))],
                   {}),
    "no_dA": ([(_DA_LOOP, "      for (int v = s; v < 0; v += S) {\n")], {}),
    "fwd_no_sums": ([(_FWD_SUMS, "  float T[4][12];\n" + _ZERO_T)], {}),
    "bwd_no_unroll": ([("#pragma unroll 4\n" + _DA_LOOP, _DA_LOOP)], {}),
    "bwd_loads_early": ([("      float T[4][12];\n" + _REBUILD + _LOADS,
                          _LOADS + "      float T[4][12];\n" + _REBUILD)],
                        {}),
    "bwd_one_stage": (_ONE_STAGE, {"tiles_per_part": 3}),
    "fwd_vp_late": ([(_VP + _FWD_SUMS, _FWD_SUMS + _VP)], {}),
    "fwd_bounds_256": (_FWD_BOUNDS_256, {}),
    "fwd_quarter_weights": ([("  const int n = nv * J;\n",
                              "  const int n = nv * J / 4;\n")], {}),
}

RUN = r"""
import collections, json, re, sys, torch
sys.path.insert(0, ".")
from chip_harness import PASSES, trace
from shapy_tpu_torch.core.rotations import aa_to_rotmat
from shapy_tpu_torch.models.body import lbs
from shapy_tpu_torch.utils import profiling

override = json.loads(sys.argv[1])
plan = lbs.skin_plan


def patched(B, V, J):
    fields = dict(override)
    if "tiles_per_part" in fields:
        tiles = -(-V // 128)
        fields["parts"] = -(-tiles // fields["tiles_per_part"])
    if "run" in fields:
        fields["run"] = min(fields["run"], B)
    return plan(B, V, J)._replace(**fields)


lbs.skin_plan = patched
dev = torch.device("cuda", 0)


def skin_kernels(fn):
    # each skinning.cu kernel's device ms per call of fn
    sources = profiling._hand_kernel_sources()
    by = collections.defaultdict(float)
    for start, stop, name in trace(fn):
        if profiling._hand_kernel(name, sources) == "skinning.cu":
            kernel = re.search(r"(\w+_kernel)\b", name).group(1)
            by[kernel] += (stop - start) / 1e3 / PASSES
    return dict(by)


gen = torch.Generator().manual_seed(0)
V, J = 10475, 55
w = torch.rand(V, J, generator=gen)
w = (w / w.sum(1, keepdim=True)).to(dev)


def inputs(B):
    rel = torch.zeros(B, J, 4, 4)
    rel[:, :, :3, :3] = aa_to_rotmat(torch.randn(B, J, 3, generator=gen)
                                     * 0.3)
    rel[:, :, :3, 3] = torch.randn(B, J, 3, generator=gen) * 0.2
    rel[:, :, 3, 3] = 1.0
    v = torch.randn(B, V, 3, generator=gen) * 0.5
    return rel.to(dev), v.to(dev)


out = {"variant": sys.argv[2]}
with torch.no_grad():
    for B in (32, 48):
        rel, v = inputs(B)
        out[f"fwd_b{B}"] = skin_kernels(lambda: lbs.skin(w, rel, v))
rel, v = inputs(48)
a, b = rel.clone().requires_grad_(), v.clone().requires_grad_()
dv = torch.randn(v.shape, generator=gen).to(dev)
y = lbs.skin(w, a, b)
out["bwd_b48"] = skin_kernels(lambda: torch.autograd.grad(
    y, (a, b), dv, retain_graph=True))
# each kernel's registers, from the copy's build (nvcc -Xptxas -v)
out["registers"], kernel = {}, None
for line in lbs.SKIN_KERNEL.build_log.splitlines():
    found = re.search(r"entry function '\w*?(skin_\w+?_kernel)", line)
    kernel = found.group(1) if found else kernel
    found = re.search(r"Used (\d+) registers", line)
    if found and kernel:
        out["registers"][kernel] = int(found.group(1))
out["plan_b32"] = lbs.skin_plan(32, V, J)._asdict()
out["plan_b48"] = lbs.skin_plan(48, V, J)._asdict()
print(json.dumps(out))
"""


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", nargs="+", default=list(VARIANTS))
    args = parser.parse_args(argv)
    failed = 0
    for name in args.variants:
        changes, fields = VARIANTS[name]
        dst = planted_copy(OUT / name, [(SKIN, old, new)
                                        for old, new in changes])
        proc = run_script(RUN, dst, (json.dumps(fields), name), timeout=600)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(f"{name}: rc {proc.returncode}\n{proc.stderr[-2000:]}")
            failed += 1
        else:
            print(lines[-1], flush=True)
        shutil.rmtree(dst)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
