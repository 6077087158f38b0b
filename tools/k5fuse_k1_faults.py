"""Show that ``chip_smoke.py``'s K5-fuse backward and K1 forward checks
catch planted faults.

Needs one CUDA card. For each fault, the port and ``chip_smoke.py`` are
copied into ``shapy_tpu_torch/_build/k5fuse_k1_faults/<fault>/`` (a
directory that git ignores; the tree itself is never edited), one part of
the copy is changed, and the copy runs phase 2's K1 forward checks (the
served bodies of batch 32 on the subsets and all faces:
``check_k1_forward``; all faces at batch 48 and 1 in both slice modes,
forward and backward: ``check_measure_kernels``) and its K5-fuse backward
check (one train step's 26 recorded targets at batch 48:
``train_step_calls`` + ``check_fuse_backward_kernel``), with the timings
skipped. The unplanted copy must pass, every planted one fail, and a
fault must be caught by the check of its own kernel.

    python tools/k5fuse_k1_faults.py [fault ...]

Each copy's output goes to
``shapy_tpu_torch/_build/k5fuse_k1_faults/<fault>.log``; the last line is
a JSON summary of return codes and verdicts. The copies run four at a
time.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "shapy_tpu_torch" / "_build" / "k5fuse_k1_faults"
FUSE = "shapy_tpu_torch/csrc/hr_fuse.cu"
MEASURE = "shapy_tpu_torch/csrc/measure.cu"

# fault -> [(file, text, replacement)]: changes to a copy.
FAULTS = {
    "none": [],
    # K5-fuse's backward: the last fine row of every tile is neither read
    # nor written (its dx left as allocated, its g out of the box sums).
    "fuse_tile_last_row": [(
        FUSE,
        "      masked(dy, y, off, g[dh][dw]);\n",
        "      if (row * kM + dh == (1 << kS) - 1) {\n"
        "        for (int i = 0; i < kV; ++i) g[dh][dw][i] = 0.f;\n"
        "        continue;\n"
        "      }\n"
        "      masked(dy, y, off, g[dh][dw]);\n")],
    # K1's forward: the last CTA of each plane's cluster walks no face.
    "k1_cluster_last_cta": [(
        MEASURE,
        "  const int hi = min(n, lo + spans.plane[p]);\n",
        "  const int hi = rank + 1 == ranks ? lo : min(n, lo + "
        "spans.plane[p]);\n")],
    # K1's forward: ranks 0 and 1 take each other's hit offsets (rank 1's
    # hits first): the same hits, out of face order.
    "k1_swap_rank_offsets": [(
        MEASURE,
        "      if (r < rank) offset += __float_as_int(sh.peer[r][0]);\n",
        "      if (rank < 2 ? rank == 0 && r == 1 : r < rank) {\n"
        "        offset += __float_as_int(sh.peer[r][0]);\n"
        "      }\n")],
}
# What a planted fault's failure must name.
CAUGHT_BY = {"fuse_tile_last_row": "K5-fuse backward:",
             "k1_cluster_last_cta": "K1",
             "k1_swap_rank_offsets": "K1"}

RUN = """
import copy, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from shapy_tpu_torch.flagship import build_flagship, spread_init_
cs.time_ms = lambda fn, iters=20, warmup=3: (fn(), 1.0)[1]
cs.device_ms = lambda fn, passes=3: (fn(), 1.0)[1]
dev = torch.device("cuda", 0)
base = build_flagship(subdivisions=5, exact_counts=True, device="cpu",
                      seed=cs.SEED)
spread_init_(base, seed=cs.SEED, beta_scale=0.25)
reg = copy.deepcopy(base).to(dev).prepare_for_eval_(torch.bfloat16)
model, meas = reg.model, reg.body_measurements
failed = []
gen = torch.Generator().manual_seed(cs.SEED + 1)
betas = torch.randn((cs.B, model.num_betas), generator=gen) * 1.5
betas = betas * torch.clamp(6.0 / betas.norm(dim=1, keepdim=True), max=1)
v = model.forward_shape(betas.to(dev))["v_shaped"].contiguous()
try:
    cs.check_k1_forward(meas, v)
    cs.check_measure_kernels(model, meas.anchors, dev)
    print("K1 check passed")
except RuntimeError as e:
    failed.append(f"K1: {e}")
try:
    _, fuses, _, _ = cs.train_step_calls(base, dev)
    cs.check_fuse_backward_kernel(fuses)
    print("K5-fuse backward check passed")
except RuntimeError as e:
    failed.append(f"K5-fuse backward: {e}")
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
    named = all(c.startswith("caught: " + CAUGHT_BY.get(fault, ""))
                for c in caught)
    return {"rc": proc.returncode, "passed": passed, "caught": len(caught),
            "as_expected": passed if fault == "none"
            else bool(caught) and named}


def main(names) -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    names = names or list(FAULTS)
    # Four copies at a time: each builds its kernels and holds a train
    # step's recorded tensors (a few GiB of the card).
    with ThreadPoolExecutor(4) as pool:
        summary = dict(zip(names, pool.map(run, names)))
    print(json.dumps(summary))
    return 0 if all(v["as_expected"] for v in summary.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
