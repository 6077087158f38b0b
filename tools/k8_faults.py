"""Show that ``chip_smoke.py``'s K8 checks catch planted faults.

Needs one CUDA card. For each fault, the port and ``chip_smoke.py`` are
copied into ``shapy_tpu_torch/_build/k8_faults/<fault>/`` with one part of
the copy changed (``chip_harness.run_faults``), and the copy builds the
flagship's eval data as ``chip_smoke.py`` does and runs phase 2's K8
checks: ``check_k8a`` (the P2P-20k error in its three cases) and
``check_k8b`` (the eval batch's group of nine point errors at B = 32),
with the timings reduced to one call. The unplanted copy must pass, every planted one fail, and a fault
must be caught by the check of its own kernel.

    python tools/k8_faults.py [fault ...]

Each copy's output goes to ``shapy_tpu_torch/_build/k8_faults/<fault>.log``;
the last line is a JSON summary of return codes and verdicts. The copies
run four at a time.
"""

from __future__ import annotations

import sys

from chip_harness import BUILD, run_faults

ALIGN = "shapy_tpu_torch/csrc/align_error.cu"
REGRESS = "shapy_tpu_torch/csrc/point_regress.cu"

# fault -> [(file, text, replacement)]: changes to a copy.
FAULTS = {
    "none": [],
    # K8b: a cluster's totals leave out the last rank's partials.
    "k8b_last_rank_dropped": [(
        ALIGN,
        "    for (unsigned r = 0; r < ranks; ++r) s += peer[r][tid];\n",
        "    for (unsigned r = 0; r + 1 < ranks; ++r) s += peer[r][tid];\n")],
    # K8b: ranks 1 and 2's partials taken in the other order (the same
    # totals up to rounding: the centred moments' double sums; the
    # coordinate sums of f32 points are exact in double in any order, so
    # that K8a's translation cannot show such a fault, and ranks 0 and 1
    # round alike, the sum starting from 0).
    "k8b_ranks_out_of_order": [(
        ALIGN,
        "    for (unsigned r = 0; r < ranks; ++r) s += peer[r][tid];\n",
        "    for (unsigned r = 0; r < ranks; ++r) {\n"
        "      s += peer[ranks > 2 && r == 1 ? 2 : ranks > 2 && r == 2 ? 1 "
        ": r][tid];\n"
        "    }\n")],
    # K8a: every CTA's run of slots stops one point short (its last point
    # neither regressed, summed nor written).
    "k8a_run_last_point_skipped": [(
        REGRESS,
        "  const int n = min(P, lo + span) - lo;\n",
        "  const int n = max(0, min(P, lo + span) - lo - 1);\n")],
}
# What a planted fault's failure must name.
CAUGHT_BY = {"k8b_last_rank_dropped": "K8b",
             "k8b_ranks_out_of_order": "K8b",
             "k8a_run_last_point_skipped": "K8a"}

RUN = """
import copy, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from shapy_tpu_torch.flagship import (build_flagship, spread_init_,
                                      synthetic_eval_data)
cs.time_ms = lambda fn, iters=20, warmup=3: (fn(), 1.0)[1]
dev = torch.device("cuda", 0)
base = build_flagship(subdivisions=5, exact_counts=True, device="cpu",
                      seed=cs.SEED)
spread_init_(base, seed=cs.SEED, beta_scale=0.25)
reg = copy.deepcopy(base).to(dev).prepare_for_eval_(torch.bfloat16)
eval_data = synthetic_eval_data(reg, 1, cs.B, cs.IMAGE_H, cs.IMAGE_W,
                                cs.CROP, cs.SEED + 5, cs.P2P_POINTS)
gen = torch.Generator().manual_seed(cs.SEED + 1)
failed = []
for name, run in (("K8a", lambda: cs.check_k8a(eval_data, gen, dev)),
                  ("K8b", lambda: cs.check_k8b(reg.model, eval_data, gen,
                                               dev))):
    try:
        run()
        print(f"{name} check passed")
    except RuntimeError as e:
        failed.append(f"{name}: {e}")
for f in failed:
    print("caught:", f[:400])
sys.exit(1 if failed else 0)
"""


if __name__ == "__main__":
    sys.exit(run_faults(BUILD / "k8_faults", FAULTS, RUN, sys.argv[1:],
                        CAUGHT_BY))
