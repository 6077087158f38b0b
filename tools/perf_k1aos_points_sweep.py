"""K1-AoS's slice points (``measure_points``) and their backward
(``measure_points_backward``) in variants of ``csrc/measure.cu`` and of
their plan, on one card: what holds the two kernels back.

Needs one CUDA card. Each variant is a copy of this tree's port under
``shapy_tpu_torch/_build/k1aos_points_sweep/<variant>/`` with some text
replaced (``chip_harness.planted_copy``). A subprocess per variant builds
the copy and times, as device time from ``chip_harness.trace``
(``torch.profiler`` traces of 5 calls between spin kernels, checked), on
the forward's saves of the flagship's SMPL-X triangles at batch 32
(seeded bodies of 1.5 sigma, a seeded cotangent), in both slice modes:
each device kernel's time a call (``measure_points_kernel``,
``measure_points_backward_kernel``, ``measure_points_heights``) and the
outputs' hashes (a variant that leaves a part out times the rest and
nothing else; one that changes a tile size or a register bound must keep
the hashes).

Variants: ``as_is``; ``bwd_min_blocks_<n>`` (``__launch_bounds__(256,
n)`` on the backward's kernel: at most 65536 / (256 n) registers a
thread); ``bwd_no_hits`` (no hit recomputed, loaded or differentiated);
``bwd_no_y`` (reference mode: no y-cotangent loaded); ``bwd_no_store`` (no
gradient stored); ``points_tile_1024`` (1024 slots a block of
``measure_points``, in the kernel and the plan); ``points_no_hits`` (no
hit searched for or placed).

    python tools/perf_k1aos_points_sweep.py [--variants NAME ...]

Prints a JSON line a variant.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys

from chip_harness import BUILD, planted_copy, run_script

OUT = BUILD / "k1aos_points_sweep"
MEASURE = "shapy_tpu_torch/csrc/measure.cu"
MEAS_PY = "shapy_tpu_torch/measure/measurements.py"
BWD = ("__launch_bounds__(kThreads) measure_points_backward_kernel(")


def _min_blocks(n: int) -> list:
    return [(MEASURE, BWD, BWD.replace("(kThreads)", f"(kThreads, {n})"))]


# name -> [(file, text, replacement)]
VARIANTS = {
    "as_is": [],
    "bwd_min_blocks_4": _min_blocks(4),
    "bwd_min_blocks_5": _min_blocks(5),
    "bwd_min_blocks_6": _min_blocks(6),
    "bwd_no_hits": [(MEASURE, "      if (!hit_here[p]) continue;\n",
                     "      if (!hit_here[p] || F > 0) continue;\n")],
    "bwd_no_y": [(MEASURE, "        gy[p][0] = gp[3 * (size_t)f + 1];\n"
                  "        gy[p][1] = gp[3 * ((size_t)F + f) + 1];\n", "")],
    "bwd_no_store": [(
        MEASURE, "  copy_span<float, float4>(grad + (fa - fs), tri, fs, "
        "fs + fn);", "  if (F < 0) copy_span<float, float4>(grad + (fa - "
        "fs), tri, fs, fs + fn);")],
    "points_tile_1024": [
        (MEASURE, "constexpr int kPointsTile = 2048;",
         "constexpr int kPointsTile = 1024;"),
        (MEAS_PY, "_POINTS_TILE = 2048", "_POINTS_TILE = 1024")],
    "points_no_hits": [(
        MEASURE, "    const int j = warp_lower_bound(cr, 0, n, 16 * (warp & 1 "
        "? hi : lo));", "    const int j = 0 * warp_lower_bound(cr, 0, 0, "
        "16 * (warp & 1 ? hi : lo));")],
}

RUN = r"""
import hashlib, json, sys, torch
sys.path.insert(0, ".")
from chip_harness import PASSES, body_model, card, trace
from shapy_tpu_torch.measure import measurements as M

dev = torch.device("cuda", 0)
model, anchors = body_model(dev)
gen = torch.Generator().manual_seed(12)
B = 32
betas = torch.randn((B, model.num_betas), generator=gen) * 1.5
v = model.forward_shape(betas.to(dev))["v_shaped"].detach().contiguous()
tri = v[:, model.faces_tensor.long()].contiguous()
F = tri.shape[1]
g_points = torch.randn((B, 3, 6 * F), generator=gen).to(dev)
out = {"card": card()}


def digest(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[
        :16]


NAMES = ("measure_points_kernel", "measure_points_backward_kernel",
         "measure_points_heights")


def per_kernel(fn):
    spans = {}
    for a, b, name in trace(fn):
        key = next((k for k in NAMES if k in name), name)
        spans[key] = spans.get(key, 0.0) + (b - a) / 1e3 / PASSES
    return spans


for mode in ("reference", "exact"):
    meas = M.BodyMeasurements(anchors, model.faces, 256,
                              slice_mode=mode).to(dev)
    got = meas(tri.clone().requires_grad_())["measurements"]
    saved = got["mass"]["tensor"]._base.grad_fn.saved_tensors
    fwd = lambda: M.measure_points(saved, mode)
    bwd = lambda: M.measure_points_backward(saved, g_points, (F,) * 3, mode)
    points, valid = fwd()
    grad, g_h = bwd()
    out[mode] = {"points": per_kernel(fwd), "backward": per_kernel(bwd),
                 "hashes": [digest(t) for t in (points, valid, grad, g_h)]}
print(json.dumps(out))
"""


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", nargs="*", default=list(VARIANTS))
    args = parser.parse_args(argv)
    rc = 0
    for name in args.variants:
        dst = planted_copy(OUT / name, VARIANTS[name])
        proc = run_script(RUN, dst)
        shutil.rmtree(dst)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode or not lines:
            print(json.dumps({"variant": name, "rc": proc.returncode,
                              "error": proc.stderr[-2000:]}), flush=True)
            rc = 1
            continue
        row = json.loads(lines[-1])
        print(json.dumps({"variant": name, **row}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
