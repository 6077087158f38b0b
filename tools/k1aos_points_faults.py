"""Show that ``chip_smoke.py``'s checks of K1-AoS's slice points
(``measure_points``) and their backward (``measure_points_backward``)
catch planted faults.

Needs one CUDA card. For each fault, the port and ``chip_smoke.py`` are
copied into ``shapy_tpu_torch/_build/k1aos_points_faults/<fault>/``
(``chip_harness.run_faults``; the tree itself is never edited) with one
part of the copy's ``csrc/measure.cu`` changed, and the copy runs phase
2's ``check_aos_kernel`` on the flagship's SMPL-X
(``chip_harness.body_model``): K1-AoS at batch 32 on all faces in both
slice modes (the points against the plain slices, ``measure_points_replay``
and the parent kernel's fill-and-scatter layout, the backward against the
f64 plain slice and ``measure_points_backward_replay``), then the small
cases (odd F, F % 8 = 6, batch 1, a row with no hit, an unwalked plane),
with the window timings reduced to one call. Before the checks the copy
fills and frees 8 GiB of device memory with a large finite value, so that
bytes a kernel leaves unwritten hold it. The unplanted copy must pass and
every planted one fail, in a check of K1-AoS.

    python tools/k1aos_points_faults.py [fault ...]

Each copy's output goes to
``shapy_tpu_torch/_build/k1aos_points_faults/<fault>.log``; the last line
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
    # measure_points: each tile places all its hits but its last (in both
    # slice modes), which keeps the fill.
    "tile_drops_last_hit": [
        (MEASURE, "    for (int t = tid; t < c0 + c1; t += kThreads) {",
         "    for (int t = tid; t < c0 + c1 - 1; t += kThreads) {"),
        (MEASURE, "    for (int t = tid; t < c; t += kThreads) {\n"
         "      const int j = j0 + t, code = cr[j]",
         "    for (int t = tid; t < c - 1; t += kThreads) {\n"
         "      const int j = j0 + t, code = cr[j]")],
    # measure_points: a tile's points that follow its last 16-byte
    # boundary are never stored.
    "unaligned_tail_unwritten": [(
        MEASURE, "copy_span<float, float4>(points + (pa - ps), pts, ps, "
        "ps + pn);", "copy_span<float, float4>(points + (pa - ps), pts, ps, "
        "(ps + pn) & ~3);")],
    # measure_points_heights: each lane sums its partials from the last
    # down: the same terms out of the fixed order.
    "partials_out_of_order": [(
        MEASURE, "  for (int i = lane; i < tiles; i += 32) s += pr[i];",
        "  for (int i = (tiles - 1 - lane) / 32 * 32 + lane; i >= lane && "
        "i < tiles; i -= 32) s += pr[i];")],
    # measure_points_backward, reference mode: the y-cotangents of the
    # faces' slots (every slot's y is the plane height) left out of g_h.
    "reference_y_cotangents_dropped": [(
        MEASURE, "        s[p] += gy[p][0];\n        s[p] += gy[p][1];\n",
        "")],
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
    cs.check_aos_kernel(model, anchors, dev)
    print("K1-AoS points checks passed")
except RuntimeError as e:
    print("caught: K1-AoS:", str(e)[:400])
    sys.exit(1)
"""

if __name__ == "__main__":
    sys.exit(run_faults(BUILD / "k1aos_points_faults", FAULTS, RUN,
                        sys.argv[1:], caught_by={f: "K1-AoS" for f in FAULTS},
                        workers=2))
