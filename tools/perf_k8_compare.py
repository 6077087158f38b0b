"""K8b and K8a (the evaluator's point errors) and the eval step on two
trees, in turns on one card.

Needs one CUDA card. Each tree given is a checkout of the repository (this
one, and for instance ``git archive`` of its parent unpacked under
``chip_archive/``). For each tree in turn a subprocess with that tree first
on ``sys.path`` builds the tree's own kernels and its flagship as
``utils/profiling.py`` does (HRNet-W48, bf16 backbone, SMPL-X at the real
counts, random weights from a seed), serves one synthetic eval batch of 32
and times, on that batch's outputs against its synthetic GT
(``flagship.synthetic_eval_data``, the reference's metric sets):

* ``k8b``: the device time of each launch of ``align_error.cu`` that one
  ``Evaluator.compute_batch_metrics`` makes, in launch order, their sum,
  and the wrapper's launches a batch (the count of the tree's
  ``CudaKernel``);
* ``k8a``: the same for ``point_regress.cu`` (the P2P-20k error), and
  ``k8a_unsorted_ms``: one ``point_regress_error`` on the regressor's
  rows as built (unsorted), the same outputs;
* ``metrics``: the device time and kernels of the whole
  ``compute_batch_metrics``;
* ``eval_step``: the served request, the metrics and the device-to-host
  copy ``Evaluator.run`` makes a batch: the host-clock wall over 10 steps
  after a synchronise, and, from a ``torch.profiler`` trace of 3 steps
  (``utils/profiling._trace``), device busy time, idle share and kernels a
  step.

Device times come from ``chip_harness.trace`` (``torch.profiler`` traces
of 5 calls between spin kernels, checked). The trees run in turns
(``chip_harness.in_turns``, ``--rounds 3``: a b b a a b), each run
printing one JSON line; the last line gives each tree's median of each
number.

With ``--staged``, a copy of this repository's port whose K8a stages
each body's meshes in its cluster's shared memory (rank r holding
vertices [r vs, (r + 1) vs), every gather a distributed-shared-memory
load; ``STAGED`` below) runs as one more tree, under
``shapy_tpu_torch/_build/k8_staged/``: the other way to serve K8a's
gathers.

    python tools/perf_k8_compare.py [--rounds N] [--staged] TREE [TREE ...]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from chip_harness import BUILD, in_turns, planted_copy

STAGED_DIR = BUILD / "k8_staged"
REGRESS = "shapy_tpu_torch/csrc/point_regress.cu"
# K8a with each body's two meshes staged across its cluster's shared
# memory: (text, replacement) in point_regress.cu.
STAGED = [
    ("__global__ void __launch_bounds__(kThreads) regress_cluster_kernel(",
     """__device__ __forceinline__ float ld_cluster(const float* local,
                                            unsigned rank) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(local);
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(remote));
  return v;
}

// Vertex v lies in rank v / vs's slice `st`, at (v mod vs).
__device__ __forceinline__ void regress_staged(
    const float* st, int vs, const int* __restrict__ idx,
    const float* __restrict__ w, int K, int j, float* out) {
  float x = 0.f, y = 0.f, z = 0.f;
  for (int k = 0; k < K; ++k) {
    const int v = __ldg(idx + j * K + k);
    const float wk = __ldg(w + j * K + k);
    const unsigned r = v / vs;
    const float* q = st + (v - (int)r * vs) * 3;
    x += wk * ld_cluster(q, r);
    y += wk * ld_cluster(q + 1, r);
    z += wk * ld_cluster(q + 2, r);
  }
  out[0] = x;
  out[1] = y;
  out[2] = z;
}

__global__ void __launch_bounds__(kThreads) regress_cluster_kernel("""),
    ("  if (clustered) cluster_arrive_relaxed();\n",
     """  const int vs1 = (V1 + ranks - 1) / ranks, vs2 = (V2 + ranks - 1) / ranks;
  float* st1 = p2 + 3 * span;
  float* st2 = st1 + 3 * vs1;
  {
    const int a1 = min(V1, (int)rank * vs1), n1 = min(V1, a1 + vs1) - a1;
    const int a2 = min(V2, (int)rank * vs2), n2 = min(V2, a2 + vs2) - a2;
    const float* m1 = v_in + ((size_t)b * V1 + a1) * 3;
    const float* m2 = v_tgt + ((size_t)b * V2 + a2) * 3;
    if (clustered) {
      for (int k = threadIdx.x; k < 3 * n1; k += kThreads) st1[k] = m1[k];
      for (int k = threadIdx.x; k < 3 * n2; k += kThreads) st2[k] = m2[k];
    }
  }
  if (clustered) cluster_sync();  // every rank's slices are staged
"""),
    ("    regress_point(vi, idx1, w1, K1, lo + j, a);\n"
     "    regress_point(vt, idx2, w2, K2, lo + j, c);\n",
     """    if (clustered) {
      regress_staged(st1, vs1, idx1, w1, K1, lo + j, a);
      regress_staged(st2, vs2, idx2, w2, K2, lo + j, c);
    } else {
      regress_point(vi, idx1, w1, K1, lo + j, a);
      regress_point(vt, idx2, w2, K2, lo + j, c);
    }
"""),
    ("  if (clustered) cluster_wait();  // every rank has started\n", ""),
    ("        sqrtf(dx * dx + dy * dy + dz * dz);\n  }\n}\n",
     "        sqrtf(dx * dx + dy * dy + dz * dz);\n  }\n"
     "  if (clustered) cluster_sync();  // no rank leaves while read\n}\n"),
    ("  const size_t smem = sizeof(Shared) + (size_t)6 * span * sizeof(float);"
     "\n",
     "  const size_t smem = sizeof(Shared) + (size_t)6 * span * sizeof(float)"
     " + (cluster > 1 ? (size_t)3 * sizeof(float) * ((V1 + cluster - 1) / "
     "cluster + (V2 + cluster - 1) / cluster) : 0);\n"),
]

RUN = r"""
import json, statistics, sys, time, torch
sys.path.insert(0, ".")
from chip_harness import PASSES, by_source, card, trace
from shapy_tpu_torch.eval.evaluator import build_evaluator
from shapy_tpu_torch.eval.metrics import point_regress_error
from shapy_tpu_torch.flagship import (REFERENCE_EVAL_CFG, build_flagship,
                                      spread_init_, synthetic_eval_data)
from shapy_tpu_torch.utils import profiling
from shapy_tpu_torch.utils.cuda_kernels import CudaKernel

B = 32
SOURCES = {"k8b": "align_error.cu", "k8a": "point_regress.cu"}
dev = torch.device("cuda", 0)
reg = build_flagship(subdivisions=5, exact_counts=True, device="cpu")
spread_init_(reg, seed=0, beta_scale=0.25)
reg = reg.to(dev).prepare_for_eval_(torch.bfloat16)
data = synthetic_eval_data(reg, 1, B, 360, 480, 256, seed=5)
gt = data["batches"][0]
images, affines = gt["images"], gt["crop_to_image_affines"]
targets = {"gt_v_shaped": gt["gt_v_shaped"], "gt_vertices": gt["gt_vertices"],
           "gt_joints3d": gt["joints3d"], "gt_joints14": gt["joints14"],
           "joints14_valid": gt["joints14_valid"],
           **{k: gt[f"{k}_gt"] for k in
              ("height", "chest", "waist", "hips", "mass")}}
evaluator = build_evaluator(REFERENCE_EVAL_CFG, device=dev,
                            point_regressor=data["p2p"],
                            j14_regressor=data["j14"])


def request():
    return reg.apply_from_full_images(images, affines, 256)


def metrics():
    return evaluator.compute_batch_metrics(outputs, targets)


def eval_step():
    m = evaluator.compute_batch_metrics(request(), targets)
    return torch.stack(list(m.values())).cpu()


def k8_trace(fn):
    # (launches of each source in order with their ms, busy ms, kernels),
    # per call of fn
    events = trace(fn)
    by = by_source(events)
    busy, end = 0.0, float("-inf")
    for start, stop, _ in events:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    per = {}
    for key, src in SOURCES.items():
        ms = by.get(src, [])
        n = len(ms) // PASSES
        calls = [statistics.mean(ms[i::n]) for i in range(n)] if n else []
        per[key] = {"calls_ms": calls, "ms": sum(calls),
                    "device_kernels": n}
    return per, busy / 1e3 / PASSES, len(events) // PASSES


out = {"card": card(), "batch": B}
with torch.inference_mode():
    for _ in range(3):
        eval_step()
    outputs = request()
    torch.cuda.synchronize()
    for key, src in SOURCES.items():
        kernel = CudaKernel.registry[src]
        before = kernel.launches
        metrics()
        out.setdefault("launches_a_batch", {})[key] = (kernel.launches
                                                       - before)
    per, busy, kernels = k8_trace(metrics)
    out.update(per)
    p2p = data["p2p"]
    v_s, gt_s = outputs["stage_02"]["v_shaped"], targets["gt_v_shaped"]
    out["k8a_unsorted_ms"] = k8_trace(lambda: point_regress_error(
        v_s.contiguous(), gt_s, p2p.indices, p2p.weights, p2p.indices,
        p2p.weights, True))[0]["k8a"]["ms"]
    out["metrics"] = {"busy_ms": busy, "kernels": kernels}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        eval_step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 10
    traced = profiling._trace(eval_step, "eval_step", None)
out["eval_step"] = {
    "wall_ms": wall, "busy_ms": traced["device_busy_ms"],
    "idle_share_traced": traced["device_idle_share"],
    "kernels": traced["cuda_kernel_launches"],
    **{f"{src}_ms": traced["hand_kernels"].get(src, [0.0])[0]
       for src in SOURCES.values()}}
print(json.dumps(out))
"""


def staged_copy() -> Path:
    """A copy of the port whose K8a gathers from staged meshes."""
    return planted_copy(STAGED_DIR, [(REGRESS, old, new)
                                     for old, new in STAGED])


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--staged", action="store_true")
    parser.add_argument("trees", nargs="+")
    args = parser.parse_args(argv)
    if args.staged:
        args.trees.append(str(staged_copy()))
    return in_turns(RUN, args.trees, args.rounds)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
