"""The port's learning proof on the card: ``tests/test_torch_learning.py``'s
task trained through ``cli/train.py`` (300 steps, killed at 150 and
resumed in a fresh ``main``), one seed a subprocess
(``chip_harness.run_script``), each seed moving the archives' draws and
the regressor's initial weights. Prints one JSON line a seed (the
held-out v2v at steps 0, 150 and 300, their ratio against the
pre-registered 0.65, the run's wall) and a last line with the card's name
and power limit; exits 1 if a seed fails or misses the bound.

    cd tools && python learning_proof.py [--seeds 0 1 2] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys

from chip_harness import REPO, card, run_script

SCRIPT = r"""
import json, os, sys, tempfile, time
sys.path.insert(0, ".")
os.environ.update({"SHAPY_TPU_SYNTHETIC_BODY": "1",
                   "SHAPY_TPU_TEST_SUBDIV": "1"})
import torch
from tests.test_torch_learning import BOUND, learning_run, write_archives

seed = int(sys.argv[1])
t = time.perf_counter()
with tempfile.TemporaryDirectory() as tmp:
    write_archives(os.path.join(tmp, "synth"), "cuda", seed)
    rows = learning_run(os.path.join(tmp, "synth"), os.path.join(tmp, "out"),
                        "cuda", seed)
v = {s: rows[s]["v2v"] for s in (0, 150, 300)}
print(json.dumps({"seed": seed, "v2v_0_mm": v[0] * 1e3,
                  "v2v_150_mm": v[150] * 1e3, "v2v_300_mm": v[300] * 1e3,
                  "ratio": v[300] / v[0], "bound": BOUND,
                  "passed": v[300] <= BOUND * v[0],
                  "wall_s": time.perf_counter() - t,
                  "device": torch.cuda.get_device_name(0)}))
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--out", default="")
    args = parser.parse_args()
    rows, failed = [], False
    for seed in args.seeds:
        proc = run_script(SCRIPT, REPO, [str(seed)], timeout=1200)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(f"seed {seed}: rc {proc.returncode}\n{proc.stderr[-3000:]}")
            failed = True
            continue
        row = json.loads(lines[-1])
        rows.append(row)
        failed |= not row["passed"]
        print(json.dumps(row), flush=True)
    last = {"card": card(), "seeds": len(rows),
            "passed": not failed and len(rows) == len(args.seeds)}
    if args.out:
        with open(args.out, "w") as f:
            for row in rows + [last]:
                f.write(json.dumps(row) + "\n")
    print(json.dumps(last))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
