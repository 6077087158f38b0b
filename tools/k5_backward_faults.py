"""Show that ``chip_smoke.py``'s K5 backward check catches planted faults.

Needs one CUDA card. For each fault, the port and ``chip_smoke.py`` are
copied into ``shapy_tpu_torch/_build/k5_faults/<fault>/`` (a directory
that git ignores; the tree itself is never edited), one line of the copy is
changed, and the copy runs phase 2's K5-dgrad / K5-wgrad check
(``train_step_calls`` + ``check_conv_backward_kernels``: one train step's
recorded calls at batch 48, bf16, all 33 conv shapes) with the kernels'
timings skipped. The unplanted copy must pass, every planted one fail.

    python tools/k5_backward_faults.py [fault ...]

Each copy's output goes to
``shapy_tpu_torch/_build/k5_faults/<fault>.log``; the last line is a
JSON summary of return codes and verdicts. The copies run three at a
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
OUT = REPO / "shapy_tpu_torch" / "_build" / "k5_faults"
CONV = "shapy_tpu_torch/csrc/conv.cu"
LAYERS = "shapy_tpu_torch/models/backbones/layers.py"

# fault -> (file, text, replacement): one change to a copy.
FAULTS = {
    "none": None,
    # K5-wgrad's reduce adds all row partitions but the last.
    "wgrad_last_partition": (
        CONV,
        "  if (dtype == 0) {\n    wgrad_reduce_kernel<float><<<blocks, 256, "
        "0, st>>>(\n        (const float*)part, (const float*)pbias, "
        "(float*)dw, (float*)db,\n        parts, CK, Cout);",
        "  parts -= 1;\n  if (dtype == 0) {\n    wgrad_reduce_kernel<float>"
        "<<<blocks, 256, 0, st>>>(\n        (const float*)part, (const "
        "float*)pbias, (float*)dw, (float*)db,\n        parts, CK, Cout);"),
    # The stem's weight gradient zeroed.
    "stem_dw_zeroed": (
        LAYERS,
        "        parts, per, vec, KERNEL_DTYPES[dt], _wgmma_n(O)])\n"
        "    return dw, db, dym",
        "        parts, per, vec, KERNEL_DTYPES[dt], _wgmma_n(O)])\n"
        "    if C == 3:\n        dw.zero_()\n    return dw, db, dym"),
    # K5-dgrad's reduce adds all K partitions but the last.
    "dgrad_last_partition": (
        CONV,
        "(const float*)part, nullptr, (bf16*)dx, nullptr, parts, (int)n, 0);",
        "(const float*)part, nullptr, (bf16*)dx, nullptr, parts - 1, (int)n, "
        "0);"),
    # K5-dgrad drops a stride-2 conv's one-tap parity class (its pixels
    # are never written).
    "dgrad_parity_class": (
        CONV,
        "        if (c.ntaps != want || c.Hc <= 0 || c.Wc <= 0) continue;",
        "        if (c.ntaps != want || c.Hc <= 0 || c.Wc <= 0 ||\n"
        "            (stride == 2 && want == 1)) {\n          continue;\n"
        "        }"),
}

RUN = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from shapy_tpu_torch.flagship import build_flagship, spread_init_
cs.time_ms = lambda fn, iters=20, warmup=3: (fn(), 1.0)[1]
base = build_flagship(subdivisions=5, exact_counts=True, device="cpu",
                      seed=cs.SEED)
spread_init_(base, seed=cs.SEED, beta_scale=0.25)
convs = cs.train_step_calls(base, torch.device("cuda", 0))[0]
cs.check_conv_backward_kernels(convs)
print("K5 backward check passed")
"""


def copy_with(fault: str) -> Path:
    dst = OUT / fault
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(REPO / "shapy_tpu_torch", dst / "shapy_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(REPO / "chip_smoke.py", dst / "chip_smoke.py")
    change = FAULTS[fault]
    if change is not None:
        path, old, new = change
        text = (dst / path).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{fault}: the planted line is not in {path}")
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
    caught = not passed and "outside its tolerance" in log
    failed = [ln for ln in log.splitlines() if "outside" in ln]
    print(f"{fault}: rc {proc.returncode}; "
          f"{failed[-1][-600:] if failed else log[-600:]}", flush=True)
    return {"rc": proc.returncode, "passed": passed, "caught": caught,
            "as_expected": passed if fault == "none" else caught}


def main(names) -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    names = names or list(FAULTS)
    # Three copies at a time: each builds its kernels and records a train
    # step (~10 GiB of the card); the check's timings are skipped.
    with ThreadPoolExecutor(3) as pool:
        summary = dict(zip(names, pool.map(run, names)))
    print(json.dumps(summary))
    return 0 if all(v["as_expected"] for v in summary.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
