"""The served request on two trees, in turns on one card.

Needs one CUDA card. Each tree given is a checkout of the repository (this
one, and for instance ``git archive`` of its parent unpacked under
``chip_archive/``). For each tree in turn a subprocess with that tree first
on ``sys.path`` builds the tree's own kernels and its flagship as
``utils/profiling.py`` does (HRNet-W48, SMPL-X at the real counts, bf16
backbone, random weights from a seed), and times ``apply_from_full_images``
at batch B on synthetic requests:

* ``request_wall_ms``: the host clock over 10 requests launched back to
  back after 3 warm-up ones, per request (what a client sees);
* ``request_host_ms``: the host's time to launch one request while a spin
  kernel holds the device, so that no launch waits for the device (the
  median of 7): the host's own cost per request;
* ``device_busy_ms`` and ``kernels``: the device time of one request's
  kernels and their number (``chip_smoke.device_time``: a profiler trace
  checked for dropped kernels), and the idle share 1 - busy / wall;
* ``python_top`` and ``cpu_top``: where the host's time goes in one
  request launched behind a spin kernel, by each Python function's own
  time (``cProfile``) and by the profiler's CPU-side events (operators
  and CUDA runtime calls; the spin's own wait among them).

The timing helpers are this repository's own, whichever tree is timed. The
trees run in the order given, three times over (a b a b a b), each run
printing one JSON line; the last line gives each tree's median.

    python tools/perf_request_compare.py [--batch 32] TREE [TREE ...]
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
import cProfile, importlib.util, json, pstats, sys, time, torch
from pathlib import Path
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from shapy_tpu_torch.flagship import (build_flagship, spread_init_,
                                      synthetic_requests)

batch = int(sys.argv[2])
dev = torch.device("cuda", 0)
reg = build_flagship(subdivisions=5, exact_counts=True, device="cpu")
spread_init_(reg, seed=0, beta_scale=0.25)
reg = reg.to(dev).prepare_for_eval_(torch.bfloat16)
images, affines = synthetic_requests(batch, 360, 480, 256, seed=0)
images = torch.from_numpy(images).to(dev)
affines = torch.from_numpy(affines).to(dev)

def request():
    return reg.apply_from_full_images(images, affines, 256)

out = {"card": cs.gpu_line(), "batch": batch}
with torch.inference_mode():
    for _ in range(3):
        request()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        request()
    torch.cuda.synchronize()
    out["request_wall_ms"] = (time.perf_counter() - t0) * 1e3 / 10
    host = []
    for _ in range(7):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(4e8))  # ~0.2 s, longer than the launches
        t0 = time.perf_counter()
        request()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    out["request_host_ms"] = sorted(host)[3]
    out["request_host_runs_ms"] = host
    busy, kernels = cs.device_time(request)
    # Where the host's time goes in one request launched behind a spin
    # kernel: each Python function's own time (cProfile), and the
    # profiler's CPU-side events (operators and CUDA runtime calls) by
    # their own time.
    prof = cProfile.Profile()
    torch.cuda._sleep(int(4e8))
    prof.enable()
    request()
    prof.disable()
    torch.cuda.synchronize()
    top = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])
    out["python_top"] = [[f"{Path(f).name}:{line}({name})", v[2] * 1e3,
                          v[0]] for (f, line, name), v in top[:15]]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as tp:
        torch.cuda._sleep(int(4e8))
        request()
        torch.cuda.synchronize()
    cpu = sorted((e for e in tp.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU),
                 key=lambda e: -e.self_cpu_time_total)
    out["cpu_top"] = [[e.key, e.self_cpu_time_total / 1e3, e.count]
                      for e in cpu[:15]]
out.update(device_busy_ms=busy, kernels=kernels,
           device_idle_share=max(0.0, 1 - busy / out["request_wall_ms"]))
print(json.dumps(out))
"""

KEYS = ("request_wall_ms", "request_host_ms", "device_busy_ms",
        "device_idle_share", "kernels")


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("trees", nargs="+")
    args = parser.parse_args(argv)
    runs = {tree: [] for tree in args.trees}
    for tree in args.trees * 3:
        proc = subprocess.run(
            [sys.executable, "-c", RUN, str(SMOKE), str(args.batch)],
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
        tree: {k: statistics.median(r[k] for r in rows) for k in KEYS}
        for tree, rows in runs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
