"""Show that ``chip_smoke.py``'s checks of K1's and K1-exact's backward
catch planted faults.

Needs one CUDA card. For each fault, the port and ``chip_smoke.py`` are
copied into ``shapy_tpu_torch/_build/k1_backward_faults/<fault>/`` with one
part of the copy's ``csrc/measure.cu`` changed
(``chip_harness.run_faults``), and the copy runs phase 2's
``check_measure_kernels`` (both slice modes on all faces at batch 48, 32
and 1 against the plain version in f32 and f64, two calls bit-equal; then
``check_measure_backward_routes``: a body with no hit on any plane, the
hits past the records, the kernel against ``measure_backward_replay`` bit
for bit, and saves whose centroid is moved off the hits, where the clamp
and the centroid's share act) on the flagship's SMPL-X
(``chip_harness.body_model``), with
the timings reduced to one call. Before the checks the copy fills and
frees 8 GiB of device memory with a large finite value, so that scratch
the kernels leave unwritten holds it. The unplanted copy must pass and
every planted one fail, in a check of K1's backward.

    python tools/k1_backward_faults.py [fault ...]

Each copy's output goes to
``shapy_tpu_torch/_build/k1_backward_faults/<fault>.log``; the last line
is a JSON summary of return codes and verdicts. The copies run two at a
time.
"""

from __future__ import annotations

import sys

from chip_harness import BUILD, run_faults

MEASURE = "shapy_tpu_torch/csrc/measure.cu"

# fault -> [(file, text, replacement)]: changes to a copy.
FAULTS = {
    "none": [],
    # A hit tied with another at a pair's max is not counted: the max's
    # share is not split among its ties.
    "tie_counted_once": [
        (MEASURE, "kx = pr[u] > mx ? 1 : kx + (pr[u] == mx);",
         "kx = pr[u] > mx ? 1 : kx;"),
        (MEASURE, "kx = pr > mx ? 1 : kx + (pr == mx);",
         "kx = pr > mx ? 1 : kx;")],
    # The centroid's share of every hit's point cotangent left out.
    "centroid_share_dropped": [(
        MEASURE, "  const float cgx = -block_sum(tx, sh.red) / cnt;\n"
        "  const float cgz = -block_sum(tz, sh.red) / cnt;\n",
        "  const float cgx = 0.f * block_sum(tx, sh.red);\n"
        "  const float cgz = 0.f * block_sum(tz, sh.red);\n")],
    # The last hit of each warp's group of 32 skipped: no chain, no record,
    # no plane-height term.
    "group_last_hit_skipped": [(
        MEASURE, "    float gh = 0.f;\n    if (j < n) {\n",
        "    float gh = 0.f;\n    if (j < n && lane != kGroup - 1) {\n")],
    # A hit's VJP taken at the next corner of its face.
    "vjp_wrong_corner": [(
        MEASURE, "            const float* q = rec + (size_t)j * kRecord + 3 "
        "* c;", "            const float* q = rec + (size_t)j * kRecord + 3 "
        "* (c == 2 ? 0 : c + 1);")],
    # The groups' plane-height sums added out of order (each run of 8
    # backwards).
    "group_sum_out_of_order": [(
        MEASURE, "      if (k + i < groups) s += v[i];",
        "      if (k + 7 - i < groups) s += v[7 - i];")],
    # Exact mode: the crossing's dependence on the edge's y (through s = y
    # - h) left out of the vertices' gradient.
    "exact_y_chain_dropped": [
        (MEASURE, "  g[3 * a + 1] = gy != 0.f ? gsa + (gy - gy * t) : gsa;\n"
         "  g[3 * b + 1] = gy != 0.f ? gsb + gy * t : gsb;\n",
         "  g[3 * a + 1] = gy != 0.f ? gsa + (gy - gy * t) : 0.f;\n"
         "  g[3 * b + 1] = gy != 0.f ? gsb + gy * t : 0.f;\n")],
}

RUN = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from chip_harness import body_model
cs.time_ms = lambda fn, iters=20, warmup=3, windows=3: (fn(), 1.0)[1]
dev = torch.device("cuda", 0)
poison = torch.full((8 << 30,), 0x7F, dtype=torch.uint8, device=dev)
del poison  # cached, and handed out again unwritten
model, anchors = body_model(dev)
try:
    cs.check_measure_kernels(model, anchors, dev)
    print("K1 backward checks passed")
except RuntimeError as e:
    print("caught: K1:", str(e)[:400])
    sys.exit(1)
"""

if __name__ == "__main__":
    sys.exit(run_faults(BUILD / "k1_backward_faults", FAULTS, RUN,
                        sys.argv[1:], caught_by={f: "K1" for f in FAULTS},
                        workers=2))
