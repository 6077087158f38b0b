"""The ResNet train steps on two trees, in turns on one card.

Needs one CUDA card. Each tree given is a checkout of the repository (this
one, and for instance ``git archive`` of its parent unpacked under
``chip_archive/``). For each tree in turn a subprocess with that tree first
on ``sys.path`` builds the tree's own kernels and, for ResNet-50 and then
ResNet-18, the regressor that ``chip_smoke.py``'s phase 11 trains (bf16
backbone, random weights from a seed, batch 48 on one synthetic batch,
``Trainer.fit`` with the flagship's losses and optimizer), and times:

* ``first4_step_ms``: 4 steps after 1 warm-up step, per step, on the host
  clock (phase 11's own protocol);
* ``step_wall_ms``: the median of 3 windows of 10 steps, per step, after
  those (what a trainer sees once warm);
* ``step_host_ms``: the host's time to launch one step while a spin kernel
  holds the device, so that no launch waits for the device (the median of
  5): the host's own cost per step;
* ``device_busy_ms`` and ``kernels``: the device time of one step's kernels
  and their number (``chip_smoke.device_time``), and the idle share
  1 - busy / wall;
* ``python_top``: where the host's time goes in one step launched behind a
  spin kernel, by each Python function's own time (``cProfile``).

The timing helpers are this repository's own, whichever tree is timed. The
trees run in the order given, three times over (a b a b a b), each run
printing one JSON line; the last line gives each tree's median of each
number.

    python tools/perf_train_compare.py TREE [TREE ...]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"
RUN = r"""
import cProfile, importlib.util, json, pstats, statistics, sys, time, torch
from pathlib import Path
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from shapy_tpu_torch.flagship import (FLAGSHIP_OPTIM_CFG,
                                      FLAGSHIP_TRAIN_LOSS_CFG,
                                      synthetic_train_batches)
from shapy_tpu_torch.train.losses import RegressorLosses
from shapy_tpu_torch.train.trainer import Trainer

dev = torch.device("cuda", 0)
SPIN = int(4e8)  # ~0.2 s, longer than a step's launches
out = {"card": cs.gpu_line()}
for depth in (50, 18):
    reg = cs._train_regressor(cs.resnet_base(depth), dev)
    batch = {"train": synthetic_train_batches(reg, 1, cs.TRAIN_B, cs.CROP,
                                              cs.SEED + 9)}
    trainer = Trainer(reg, RegressorLosses(FLAGSHIP_TRAIN_LOSS_CFG),
                      FLAGSHIP_OPTIM_CFG, summary_steps=10 ** 9, device=dev)

    def steps(k):
        trainer.fit(batch, k, seed=cs.SEED)

    def window(k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(k)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / k

    row = {}
    steps(1)
    row["first4_step_ms"] = window(4)
    walls = [window(10) for _ in range(3)]
    row["step_wall_ms"] = statistics.median(walls)
    row["step_wall_windows_ms"] = walls
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN)
        t0 = time.perf_counter()
        steps(1)
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    row["step_host_ms"] = statistics.median(host)
    row["step_host_runs_ms"] = host
    busy, kernels = cs.device_time(lambda: steps(1))
    row.update(device_busy_ms=busy, kernels=kernels,
               device_idle_share=max(0.0, 1 - busy / row["step_wall_ms"]))
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN)
    prof.enable()
    steps(1)
    prof.disable()
    torch.cuda.synchronize()
    top = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])
    row["python_top"] = [[f"{Path(f).name}:{line}({name})", v[2] * 1e3,
                          v[0]] for (f, line, name), v in top[:12]]
    out[f"resnet{depth}"] = row
    del trainer, reg, batch
    torch.cuda.empty_cache()
print(json.dumps(out))
"""

KEYS = ("first4_step_ms", "step_wall_ms", "step_host_ms", "device_busy_ms",
        "device_idle_share", "kernels")


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+")
    args = parser.parse_args(argv)
    runs = {tree: [] for tree in args.trees}
    for tree in args.trees * 3:
        proc = subprocess.run(
            [sys.executable, "-c", RUN, str(SMOKE)],
            cwd=Path(tree).resolve(), capture_output=True, text=True,
            timeout=900)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(f"{tree}: rc {proc.returncode}\n{proc.stderr[-3000:]}")
            return 1
        row = json.loads(lines[-1])
        row["tree"] = tree
        runs[tree].append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"median": {
        tree: {f"resnet{d}": {k: statistics.median(r[f"resnet{d}"][k]
                                                   for r in rows)
                              for k in KEYS} for d in (50, 18)}
        for tree, rows in runs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
