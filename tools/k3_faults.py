"""Show that ``chip_smoke.py``'s K3 checks catch planted faults.

Needs one CUDA card. For each fault, the port and ``chip_smoke.py`` are
copied into ``shapy_tpu_torch/_build/k3_faults/<fault>/`` with one part
of the copy's ``csrc/skinning.cu`` changed (``chip_harness.run_faults``),
and the copy builds the flagship's body model as ``chip_smoke.py`` does
and runs phase 2's ``check_k3`` (the forward at batch 32 and 48, the
backward at 48: each against the plain version, across two calls, for a
body alone and against its order replay), with the timings reduced to one
call. The unplanted copy must pass and every planted one fail.

    python tools/k3_faults.py [fault ...]

Each copy's output goes to ``shapy_tpu_torch/_build/k3_faults/<fault>.log``;
the last line is a JSON summary of return codes and verdicts. The copies
run four at a time.
"""

from __future__ import annotations

import sys

from chip_harness import BUILD, run_faults

SKIN = "shapy_tpu_torch/csrc/skinning.cu"

# fault -> [(file, text, replacement)]: changes to a copy.
FAULTS = {
    "none": [],
    # The forward: each vertex tile one vertex short (its last vertex's
    # weights left zero and its output never written).
    "tile_last_vertex_skipped": [(
        SKIN,
        "  const int v0 = blockIdx.x * kTile, nv = min(kTile, V - v0);\n",
        "  const int v0 = blockIdx.x * kTile, nv = min(kTile, V - v0) - 1;\n")],
    # Both kernels: a run's last body staged with the transforms of the
    # body before it.
    "run_last_body_previous_transforms": [(
        SKIN,
        "    const float* src = transforms + ((size_t)(b0 + r) * J + j) * 16;\n",
        "    const float* src = transforms + ((size_t)(b0 + (r > 0 && r == nb "
        "- 1 ? r - 1 : r)) * J + j) * 16;\n")],
    # The backward: partitions 1 and 2's partials summed in the other
    # order (the same sum up to rounding).
    "partials_out_of_order": [(
        SKIN,
        "    for (int k = 1; k < nparts; ++k) s += p[(size_t)k * J * 12];\n",
        "    for (int k = 1; k < nparts; ++k) {\n"
        "      s += p[(size_t)(nparts > 2 && k < 3 ? 3 - k : k) * J * 12];\n"
        "    }\n")],
}

RUN = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from shapy_tpu_torch.flagship import build_flagship
cs.time_ms = lambda fn, iters=20, warmup=3: (fn(), 1.0)[1]
dev = torch.device("cuda", 0)
model = build_flagship(subdivisions=5, exact_counts=True, device="cpu",
                       seed=cs.SEED).model.to(dev)
try:
    cs.check_k3(model, dev)
    print("K3 checks passed")
except RuntimeError as e:
    print("caught: K3:", str(e)[:400])
    sys.exit(1)
"""

if __name__ == "__main__":
    sys.exit(run_faults(BUILD / "k3_faults", FAULTS, RUN, sys.argv[1:]))
