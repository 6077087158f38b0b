"""Show that ``chip_smoke.py``'s K5-conv and K4 checks catch planted
faults.

Needs one CUDA card. For each fault, the port and ``chip_smoke.py`` are
copied into ``shapy_tpu_torch/_build/k5_conv_k4_faults/<fault>/`` (a
directory that git ignores; the tree itself is never edited), one part of
the copy is changed, and the copy runs phase 2's K5-conv check (the 33
shapes of a served forward at batch 32 in bf16, each with its epilogue,
and in f32: ``backbone_calls`` + ``check_conv_kernels``) and its K4 check
(the stem's and a stage-4 BN at batch 48, bf16 and f32, the forward and
the backward in both regimes: ``check_train_kernels``), with the kernels' timings
skipped. The unplanted copy must pass, every planted one fail; a fault of
K4's forward alone must fail the forward's own check (its y, mean and inv
limits in one regime) before anything else.

    python tools/k5_conv_k4_faults.py [fault ...]

Each copy's output goes to
``shapy_tpu_torch/_build/k5_conv_k4_faults/<fault>.log``; the last line
is a JSON summary of return codes and verdicts. The copies run three at
a time.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "shapy_tpu_torch" / "_build" / "k5_conv_k4_faults"
CONV = "shapy_tpu_torch/csrc/conv.cu"
BN = "shapy_tpu_torch/csrc/batch_norm.cu"

# fault -> [(file, text, replacement)]: changes to a copy.
FAULTS = {
    "none": [],
    # K5-conv's reduce adds all K partitions but the last.
    "conv_last_partition": [(
        CONV,
        "(const bf16*)a.res, (bf16*)a.y, parts, n,",
        "(const bf16*)a.res, (bf16*)a.y, parts - 1, n,")],
    # The wgmma kernel's epilogue leaves out the residual.
    "conv_no_residual": [(
        CONV,
        "epilogue8(v, bias, res, idx, d.ci0 + cc, relu);",
        "epilogue8(v, bias, nullptr, idx, d.ci0 + cc, relu);")],
    # A stride-2 conv's first tap loads no x box (its bytes are taken out
    # of the stage's count, so the ring runs on over a stale A tile).
    "conv_stride2_tap": [(
        CONV,
        "        mbar_expect_tx(&full[st], tx);\n"
        "        tma_load_4d(As + st * kStageA, &amap, &full[st], k0,\n"
        "                    P.astride * d.j0 + dw, P.astride * d.i0 + dh, "
        "d.n0);\n",
        "        const bool drop = kFwd && P.astride == 2 && tp == 0;\n"
        "        mbar_expect_tx(&full[st], drop ? tx - 128u * P.box_w * "
        "P.box_h * P.box_n : tx);\n"
        "        if (!drop) {\n"
        "          tma_load_4d(As + st * kStageA, &amap, &full[st], k0,\n"
        "                      P.astride * d.j0 + dw, P.astride * d.i0 + "
        "dh, d.n0);\n"
        "        }\n")],
    # K4's three-launch regime: the finalize (the forward's and the
    # backward's) leaves out the last row tile.
    "bn_split_last_tile": [(
        BN,
        "    for (int k = l; k < tiles; k += kTileLanes) {",
        "    for (int k = l; k < tiles - 1; k += kTileLanes) {")],
    # K4's cluster regime: the blocks' sums leave out the last block.
    "bn_cluster_last_tile": [(
        BN,
        "    for (int r = 0; r < kCl; ++r) {",
        "    for (int r = 0; r < kCl - 1; ++r) {")],
    # The forward alone. Its finalize leaves out the last row tile (1 of
    # the stem's 1024): y moves by less than a bf16 step, mean and inv do
    # not.
    "bn_fwd_split_last_tile": [(
        BN,
        "  if (sum_tiles(partials, tiles, C, &s, &q)) {",
        "  if (sum_tiles(partials, tiles - 1, C, &s, &q)) {")],
    # Its cluster kernel leaves out the last thread of the last block: a
    # thread's rows (192 of the stem's 786432 rows, 1 of stage 4's 3072).
    "bn_fwd_cluster_last_lane": [(
        BN,
        "  float sum, sum2;\n  cluster_sums<V, kCl>(s, sq, &sum, &sum2);",
        "  float sum, sum2;\n"
        "  if (rank == kCl - 1 && l == kThreads - 1) {\n"
        "    for (int i = 0; i < V; ++i) s[i] = sq[i] = 0.f;\n"
        "  }\n"
        "  cluster_sums<V, kCl>(s, sq, &sum, &sum2);")],
}
# What a planted fault's failure must name: a fault of the forward alone
# must be caught by the forward's own limits.
CAUGHT_BY = {"bn_fwd_split_last_tile": "split forward at",
             "bn_fwd_cluster_last_lane": "cluster forward at"}

RUN = """
import copy, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from shapy_tpu_torch.flagship import (build_flagship, spread_init_,
                                      synthetic_requests)
cs.time_ms = lambda fn, iters=20, warmup=3: (fn(), 1.0)[1]
dev = torch.device("cuda", 0)
base = build_flagship(subdivisions=5, exact_counts=True, device="cpu",
                      seed=cs.SEED)
spread_init_(base, seed=cs.SEED, beta_scale=0.25)
reg = copy.deepcopy(base).to(dev).prepare_for_eval_(torch.bfloat16)
images, affines = synthetic_requests(cs.B, cs.IMAGE_H, cs.IMAGE_W, cs.CROP,
                                     cs.SEED)
requests = (torch.from_numpy(images).to(dev),
            torch.from_numpy(affines).to(dev))
failed = []
convs, _ = cs.backbone_calls(reg.backbone, requests)
try:
    cs.check_conv_kernels(convs)
    print("K5-conv check passed")
except RuntimeError as e:
    failed.append(f"K5-conv: {e}")
del convs
try:
    cs.check_train_kernels(reg.model, dev)
    print("K4 check passed")
except RuntimeError as e:
    failed.append(f"K4: {e}")
for f in failed:
    print("caught:", f[:400])
sys.exit(1 if failed else 0)
"""


def copy_with(fault: str) -> Path:
    dst = OUT / fault
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(REPO / "shapy_tpu_torch", dst / "shapy_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(REPO / "chip_smoke.py", dst / "chip_smoke.py")
    for path, old, new in FAULTS[fault]:
        text = (dst / path).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{fault}: the planted text is not in {path}")
        (dst / path).write_text(text.replace(old, new))
    return dst


def run(fault: str) -> dict:
    dst = copy_with(fault)
    proc = subprocess.run(
        ["timeout", "900", sys.executable, "-c", RUN], cwd=dst,
        capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    (OUT / f"{fault}.log").write_text(log)
    shutil.rmtree(dst)
    passed = proc.returncode == 0
    caught = [ln for ln in log.splitlines() if ln.startswith("caught:")]
    print(f"{fault}: rc {proc.returncode}; "
          f"{' | '.join(c[:300] for c in caught) if caught else log[-600:]}",
          flush=True)
    named = all(CAUGHT_BY.get(fault, "") in c for c in caught)
    return {"rc": proc.returncode, "passed": passed, "caught": len(caught),
            "as_expected": passed if fault == "none"
            else bool(caught) and named}


def main(names) -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    names = names or list(FAULTS)
    # Three copies at a time: each builds its kernels and holds a served
    # forward's recorded convs (a few GiB of the card).
    with ThreadPoolExecutor(3) as pool:
        summary = dict(zip(names, pool.map(run, names)))
    print(json.dumps(summary))
    return 0 if all(v["as_expected"] for v in summary.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
