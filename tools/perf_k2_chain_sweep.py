"""K2 and K3-chain at the flagship's shapes, in variants of their sources,
on one card: what holds each kernel back.

Needs one CUDA card. Each variant is a copy of a tree's port under
``shapy_tpu_torch/_build/k2_chain_sweep/<variant>/`` (this repository's,
or with ``--parent TREE`` that tree's for the ``parent_*`` variants)
whose ``csrc/ingest.cu`` or ``csrc/kinematic_chain.cu`` has some text
replaced (``chip_harness.planted_copy``). A subprocess per variant builds
the copy and times, as device time from ``chip_harness.trace``
(``torch.profiler`` traces of 5 calls between spin kernels, checked): K2
(uint8 480x360 -> bf16 256x256) on the served requests at batch 32 and
128, and K3-chain's forward at 32 and 48 and backward at 48 on the
flagship's tree (synthetic SMPL-X, 6 levels) and the forward and backward
at 48 on the published SMPL-X tree (11 levels); it prints whether K2's
output is still bit-equal to the plain version (variants that change the
arithmetic time a part of the kernel, nothing else).

    python tools/perf_k2_chain_sweep.py [--parent TREE] [--variants NAME ...]

K2's variants: ``as_is``; ``direct`` (no tile staged: every corner read
from the image); ``no_div`` (a product in place of the true division);
``scalar_out`` (the finished tile stored element by element);
``warps_W`` (W warps a block, 32 / W rows a thread); ``box_K`` (a K KB staging budget);
``no_corner_reads``, ``no_staging_copy``, ``no_out`` (the staged
corners' reads, the footprint's copy, the output's stores left out, by
a condition false at run time). The
parent's (``--parent``): ``parent_as_is``; ``parent_shift`` (the pixel's
row and column by shift and mask, not ``%`` and ``/``: right for a
256-pixel crop only); ``parent_4_loads`` (one load a corner, its byte
taken for all three channels); ``parent_no_div``; ``parent_one_store``
(one channel of three stored). K3-chain's: ``chain_no_levels`` (no level
walked: the staging, the loads and the stores alone);
``chain_stride_constant`` (its strided loops stepping by the constant
64, not by ``blockDim.x`` read at run time). Prints a
JSON line a variant, with each kernel's registers from the copy's build.
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

from chip_harness import BUILD, REPO, planted_copy, run_script

OUT = BUILD / "k2_chain_sweep"
INGEST = "shapy_tpu_torch/csrc/ingest.cu"
CHAIN = "shapy_tpu_torch/csrc/kinematic_chain.cu"

_DIV = ("      res[i][c] = (val - norm.mean[c]) / norm.std[c];\n",
        "      res[i][c] = (val - norm.mean[c]) * norm.std[c];\n")
_PARENT_STORE = "    store(dst + c, (val - norm.mean[c]) / norm.std[c]);\n"
_LEVELS = "  for (int l = 1; l < s.L; ++l) {\n"
_BWD_LEVELS = "  for (int l = s.L - 2; l >= 0; --l) {\n"


def _const(name, old, new):
    return (INGEST, f"constexpr int {name} = {old};",
            f"constexpr int {name} = {new};")


# name -> [(file, text, replacement)]; parent_* apply to --parent's tree
VARIANTS = {
    "as_is": [],
    "direct": [(INGEST, "  const bool staged = aligned && finite && (long "
                "long)pitch * bh <= kBoxBytes;\n",
                "  const bool staged = false;\n")],
    "no_div": [(INGEST, *_DIV)],
    "scalar_out": [(INGEST, "  if (vector_out && w == kTile) {\n",
                    "  if (false) {\n")],
    # parts left out (at run time: the compiler keeps the rest)
    "no_corner_reads": [(INGEST, "      if (staged) {  // a shared-memory "
                         "load a channel\n", "      if (staged && S < 0) {\n"
                         ), (INGEST, "      } else {\n        const In* p = "
                         "img + ", "      } else if (!staged) {\n        "
                         "const In* p = img + ")],
    "no_staging_copy": [(INGEST, "    for (int i = threadIdx.x; i < n; i += "
                         "kThreads) {\n", "    for (int i = threadIdx.x; i < n"
                         " * (S < 0); i += kThreads) {\n")],
    "no_out": [(INGEST, "    for (int i = threadIdx.x; i < h * kChunks; i "
                "+= kThreads) {\n", "    for (int i = threadIdx.x; i < h * "
                "kChunks * (S < 0); i += kThreads) {\n")],
    **{f"warps_{w}": [_const("kWarps", 4, w)] for w in (2, 8)},
    **{f"box_{k}": [_const("kBoxBytes", "24 * 1024", f"{k} * 1024")]
       for k in (12, 16, 32)},
    "parent_as_is": [],
    "parent_shift": [(INGEST, "  const float gx = (float)(pix % out_w);\n"
                      "  const float gy = (float)(pix / out_w);\n",
                      "  const float gx = (float)(pix & 255);\n"
                      "  const float gy = (float)(pix >> 8);\n")],
    "parent_4_loads": [(INGEST, "      for (int c = 0; c < 3; ++c) v[k][c] = "
                        "load(src + c);\n",
                        "      for (int c = 0; c < 3; ++c) v[k][c] = "
                        "load(src);\n")],
    "parent_no_div": [(INGEST, _PARENT_STORE, _PARENT_STORE.replace(
        ") / norm", ") * norm"))],
    "parent_one_store": [(INGEST, _PARENT_STORE,
                          "    if (c == 0) " + _PARENT_STORE.lstrip())],
    "chain_stride_constant": [
        (CHAIN, f"i < {n}; i += {k}blockDim.x) {t}",
         f"i < {n}; i += {k}kMaxJoints) {t}")
        for n, k, t in (("done", "4 * ", "{"), ("n", "", "{"),
                        ("J * 3", "", "{"), ("J * 4", "", "{"),
                        ("J * 9", "", "d_rot"), ("J * 3", "", "d_joints"))],
    "chain_no_levels": [(CHAIN, _LEVELS, "  for (int l = 1; l < 1; ++l) {\n"),
                        (CHAIN, _BWD_LEVELS,
                         "  for (int l = -1; l >= 0; --l) {\n")],
}

RUN = r"""
import json, re, sys, torch
sys.path.insert(0, ".")
from chip_harness import PASSES, by_source, smoke, trace
from shapy_tpu_torch.core import kinematics
from shapy_tpu_torch.core.rotations import aa_to_rotmat
from shapy_tpu_torch.data import crop
from shapy_tpu_torch.flagship import synthetic_requests
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data

dev = torch.device("cuda", 0)
out = {"variant": sys.argv[1]}


def ms(fn, src):
    return sum(by_source(trace(fn)).get(src, [])) / PASSES


with torch.no_grad():
    for Bk in (32, 128):
        images, affines = synthetic_requests(Bk, 360, 480, 256, seed=0)
        images = torch.from_numpy(images).to(dev)
        affines = torch.from_numpy(affines).to(dev)
        fn = lambda: crop.crop_normalize(images, affines, 256,  # noqa: E731
                                         out_dtype=torch.bfloat16)
        out[f"k2_b{Bk}"] = ms(fn, "ingest.cu")
        out[f"k2_b{Bk}_bit_equal"] = torch.equal(fn(), crop.crop_normalize_plain(
            images, affines, 256, out_dtype=torch.bfloat16))

data = make_synthetic_model_data("smplx", subdivisions=1)
synthetic = tuple(int(p) for p in data["kintree_table"][0][1:])
gen = torch.Generator().manual_seed(0)
for tree, parents in (("chain", (-1,) + synthetic),
                      ("smplx", smoke().SMPLX_PARENTS)):
    for Bk in (32, 48) if tree == "chain" else (48,):
        J = len(parents)
        rot = aa_to_rotmat(torch.randn(Bk, J, 3, generator=gen) * 0.3).to(dev)
        joints = (torch.randn(Bk, J, 3, generator=gen) * 0.3).to(dev)
        with torch.no_grad():
            out[f"{tree}_fwd_b{Bk}"] = ms(lambda: kinematics.batch_rigid_transform(
                rot, joints, parents), "kinematic_chain.cu")
    cts = [torch.randn(s, generator=gen).to(dev) for s in
           ((Bk, J, 3), (Bk, J, 4, 4), (Bk, J, 4, 4))]
    r, j = rot.clone().requires_grad_(), joints.clone().requires_grad_()
    y = kinematics.batch_rigid_transform(r, j, parents)
    out[f"{tree}_bwd_b{Bk}"] = ms(lambda: torch.autograd.grad(
        y, (r, j), cts, retain_graph=True), "kinematic_chain.cu")
# each kernel's registers, from the copy's builds (nvcc -Xptxas -v)
out["registers"] = {}
for kernel in (crop.INGEST_KERNEL, kinematics.CHAIN_KERNEL):
    name = None
    for line in kernel.build_log.splitlines():
        found = re.search(r"entry function '(\w+)'", line)
        name = found.group(1)[:60] if found else name
        found = re.search(r"Used (\d+) registers", line)
        if found and name:
            out["registers"][name] = int(found.group(1))
print(json.dumps(out))
"""


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path)
    parser.add_argument("--variants", nargs="+", default=[
        v for v in VARIANTS if not v.startswith("parent")])
    args = parser.parse_args(argv)
    failed = 0
    for name in args.variants:
        root = args.parent.resolve() if name.startswith("parent") else REPO
        dst = planted_copy(OUT / name, VARIANTS[name], root=root)
        proc = run_script(RUN, dst, (name,), timeout=600)
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
