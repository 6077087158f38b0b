"""K8b's and K8a's device time at each split of a body's points, in
variants of their sources, at the evaluator's shapes on one card: the
data behind ``align_plan``'s and ``regress_plan``'s constants, the
kernels' ``__launch_bounds__`` and thread counts, and the cost of K8b's
serial 3x3 solve.

Needs one CUDA card. For each variant named (``VARIANTS``: ``as_is``, the
sources as they are; others change them, e.g. ``no_solve`` sets R = I
where thread 0 solves the Procrustes problem, so that its time is the
difference) a copy of the port under ``shapy_tpu_torch/_build/k8_sweep/``
runs, in a subprocess, with ``_ALIGN_CTA_POINTS`` / ``_REGRESS_CTA_POINTS``
set to each value given:

* K8b: the eval batch's group (B = 32: two pairs of 10475 points asked
  scale + translation and procrustes + scale + translation, 55 and 14
  joints asked root + procrustes) of random clouds;
* K8a: P2P-20k (P = 20000, K = 3, rows of the synthetic SMPL-X mesh's
  faces, sorted by the regressor) on two meshes of B = 32 bodies.

Each time is the device time of one call from a ``torch.profiler`` trace
of 20 calls. Prints one JSON line a variant with the plans, the times and
the kernels' registers (``ptxas``).

    python tools/perf_k8_sweep.py [--variants as_is no_solve ...]
        [--align-points 1536 2620 5240] [--regress-points 2500 5000]
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "shapy_tpu_torch" / "_build" / "k8_sweep"
ALIGN = "csrc/align_error.cu"
REGRESS = "csrc/point_regress.cu"
METRICS = "eval/metrics.py"
K8B_BOUNDS = "__launch_bounds__(kThreads, 3) align_group_kernel("
K8A_BOUNDS = "__launch_bounds__(kThreads) regress_cluster_kernel("
# variant -> [(file under shapy_tpu_torch/, text, replacement)]
VARIANTS = {
    "as_is": [],
    # K8b without the occupancy bound (96 registers: two CTAs an SM).
    "k8b_unbounded": [(ALIGN, K8B_BOUNDS,
                       "__launch_bounds__(kThreads) align_group_kernel(")],
    "k8b_bound_4": [(ALIGN, K8B_BOUNDS,
                     "__launch_bounds__(kThreads, 4) align_group_kernel(")],
    # K8b with R = I in place of thread 0's 3x3 solve.
    "no_solve": [(ALIGN, "    procrustes_rotation(t + 2, R);\n",
                  "    for (int k = 0; k < 9; ++k) R[k] = k % 4 == 0;\n")],
    # K8a at 256 threads a CTA, and at 512 with 3 CTAs an SM's registers.
    "k8a_256_threads": [(REGRESS, "constexpr int kThreads = 512;",
                         "constexpr int kThreads = 256;")],
    "k8a_bound_3": [(REGRESS, K8A_BOUNDS,
                     "__launch_bounds__(kThreads, 3) "
                     "regress_cluster_kernel(")],
    # K8a's rows sorted by their largest vertex, not their first (a third
    # fewer distinct 32-byte sectors a CTA at P2P-20k's rows).
    "k8a_sort_max": [(METRICS, "np.argsort(indices[:, 0], ",
                      "np.argsort(indices.max(axis=1), ")],
    # K8a's loop over a thread's points unrolled, and also over K.
    "k8a_unroll": [(REGRESS, "  for (int j = tid; j < n; j += kThreads) {\n"
                    "    float* a = p1 + 3 * j;\n",
                    "#pragma unroll 4\n"
                    "  for (int j = tid; j < n; j += kThreads) {\n"
                    "    float* a = p1 + 3 * j;\n")],
    # K8a writing each error at its slot, not its row (wrong outputs:
    # the cost of the scattered stores).
    "k8a_slot_stores": [(REGRESS,
                         "    ob[order ? __ldg(order + lo + j) : lo + j] =\n",
                         "    ob[lo + j] =\n")],
    "k8a_unroll_k": [(REGRESS, "  for (int j = tid; j < n; j += kThreads) {\n"
                      "    float* a = p1 + 3 * j;\n",
                      "#pragma unroll 4\n"
                      "  for (int j = tid; j < n; j += kThreads) {\n"
                      "    float* a = p1 + 3 * j;\n"),
                     (REGRESS, "  for (int k = 0; k < K; ++k) {\n"
                      "    const int v = __ldg(idx + j * K + k);\n",
                      "#pragma unroll 3\n"
                      "  for (int k = 0; k < K; ++k) {\n"
                      "    const int v = __ldg(idx + j * K + k);\n")],
}

RUN = r"""
import json, re, sys, numpy as np, torch
sys.path.insert(0, ".")
from shapy_tpu_torch.eval import metrics
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data

B, CALLS = 32, 20
align_points, regress_points = json.loads(sys.argv[1]), json.loads(sys.argv[2])
dev = torch.device("cuda", 0)
gen = torch.Generator().manual_seed(0)


def cloud(P):
    x = torch.randn((B, P, 3), generator=gen) * torch.tensor([0.8, 0.3, 0.15])
    return x.to(dev).contiguous()


group = [(cloud(10475), cloud(10475), ("scale", "translation"), None),
         (cloud(10475), cloud(10475), ("procrustes", "scale", "translation"),
          None),
         (cloud(55), cloud(55), ("root", "procrustes"), (0,)),
         (cloud(14), cloud(14), ("root", "procrustes"), (2, 3))]
faces = make_synthetic_model_data("smplx", subdivisions=5,
                                  exact_counts=True, seed=0)["f"]
rng = np.random.default_rng(0)
tri = faces[rng.integers(0, len(faces), size=20000)]
reg = metrics.SparsePointRegressor(tri, rng.dirichlet(np.ones(3), 20000),
                                   device=dev)
v_in = cloud(10475)
v_tgt = (v_in + 0.01).contiguous()


def device_ms(fn, name):
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and name in e.name]
    if len(times) != CALLS:
        raise RuntimeError(f"{len(times)} {name} events for {CALLS} calls")
    return sum(times) / CALLS / 1e3


out = {"card": sys.argv[3]}
for points in align_points:
    metrics._ALIGN_CTA_POINTS = points
    out[f"k8b_{points}"] = {
        "plan": metrics.align_plan(10475, B),
        "ms": device_ms(lambda: metrics.aligned_point_errors(group),
                        "align_group_kernel")}
for points in regress_points:
    metrics._REGRESS_CTA_POINTS = points
    out[f"k8a_{points}"] = {
        "plan": metrics.regress_plan(20000, B),
        "ms": device_ms(lambda: reg(v_in, v_tgt), "regress_cluster_kernel")}
for k in (metrics.ALIGN_KERNEL, metrics.REGRESS_KERNEL):
    out[f"{k.source}_ptxas"] = [ln.split(":")[-1].strip()
                                for ln in k.build_log.splitlines()
                                if "registers" in ln or "spill" in ln]
print(json.dumps(out))
"""


def variant(name: str) -> Path:
    dst = OUT / name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(REPO / "shapy_tpu_torch", dst / "shapy_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for source, old, new in VARIANTS[name]:
        path = dst / "shapy_tpu_torch" / source
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old[:50]!r} not once in {source}")
        path.write_text(text.replace(old, new))
    return dst


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", nargs="+", default=["as_is"],
                        choices=list(VARIANTS))
    parser.add_argument("--align-points", type=int, nargs="+",
                        default=[2620])
    parser.add_argument("--regress-points", type=int, nargs="+",
                        default=[2048])
    args = parser.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    rc = 0
    for name in args.variants:
        proc = subprocess.run(
            [sys.executable, "-c", RUN, json.dumps(args.align_points),
             json.dumps(args.regress_points), card], cwd=variant(name),
            capture_output=True, text=True, timeout=600)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(f"{name}: rc {proc.returncode}\n{proc.stderr[-3000:]}")
            rc = 1
            continue
        row = json.loads(lines[-1])
        row["variant"] = name
        print(json.dumps(row), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
