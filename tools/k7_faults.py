"""Show that ``chip_smoke.py``'s checks of K7, the repulsion loss's
forward and backward (``csrc/repulsion.cu``), catch planted faults.

Needs one CUDA card. For each fault, the port and ``chip_smoke.py`` are
copied into ``shapy_tpu_torch/_build/k7_faults/<fault>/``
(``chip_harness.run_faults``; the tree itself is never edited) with one
part of the copy's ``csrc/repulsion.cu`` changed, and the copy runs phase
2's ``check_k7`` on phase 9's contacts (``chip_smoke.contact_bodies``:
four SMPL-X body pairs of the flagship's synthetic body model, K6's hits
at 256 slots as pairs), with the window timings reduced to one call: the
kernels through ``repulsion_loss`` and autograd against the plain version,
their device kernels a call, and ``k7_case`` on those inputs and the
planted cases against the replays. Before the checks the copy fills and
frees 8 GiB of device memory with a large finite value, so that bytes a
kernel leaves unwritten hold it. The unplanted copy must pass and every
planted one fail, in a check of K7.

    python tools/k7_faults.py [fault ...]

Each copy's output goes to ``shapy_tpu_torch/_build/k7_faults/<fault>.log``;
the last line is a JSON summary of return codes and verdicts. The copies
run two at a time.
"""

from __future__ import annotations

import sys

from chip_harness import BUILD, run_faults

K7 = "shapy_tpu_torch/csrc/repulsion.cu"

# fault -> [(file, text, replacement)]: changes to a copy.
FAULTS = {
    "none": [],
    # the face pass keeps each walk's ids in the order the walk meets
    # them (the reverse of the pushes), not ascending: each face's entries
    # summed in arrival order
    "bucket_arrival_order": [(
        K7, "          const int lo = min(ids[j], v);\n"
        "          v = max(ids[j], v);\n          ids[j] = lo;\n",
        "          if (ids[j] == INT_MAX) {\n            ids[j] = v;\n"
        "            break;\n          }\n")],
    # a pair counts as live only where both cones hold a point: pairs
    # with nonzero fields in one cone alone are skipped
    "nonzero_pair_skipped": [(
        K7, "      live[pc] = in || in_other;",
        "      live[pc] = in && in_other;")],
    # the last block adds the tile sums from the last tile down
    "tiles_out_of_order": [(
        K7, "for (int k = 0; k < tiles; ++k) s += __ldcg(row + k);",
        "for (int k = tiles - 1; k >= 0; --k) s += __ldcg(row + k);")],
    # the forward reads a pair whose intruder is padded, as face 0
    "padded_pair_read": [
        (K7, "    valid = r >= 0 && i >= 0;", "    valid = r >= 0;"),
        (K7, "(size_t)b * F + (side ? i : r)) * 9, cone_tri);",
         "(size_t)b * F + (side ? max(i, 0) : r)) * 9, cone_tri);"),
        (K7, "(size_t)b * F + (side ? r : i)) * 9, points);",
         "(size_t)b * F + (side ? r : max(i, 0))) * 9, points);")],
    # the last block leaves its body's ticket at the tile count: the next
    # call's blocks never find themselves last
    "ticket_not_reset": [(K7, "    tickets[b] = 0u;\n", "")],
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
model, _ = body_model(dev)
bodies = cs.contact_bodies(model, dev)
from shapy_tpu_torch.ops.tri_tri import mesh_mesh_intersection
with torch.no_grad():
    faces, _ = mesh_mesh_intersection(bodies["a"], bodies["b"], cs.CONTACT_M)
F = bodies["a"].shape[1]
tris = torch.cat([bodies["a"], bodies["b"]], dim=1).contiguous()
try:
    cs.check_k7(tris, cs.contact_pairs(faces, cs.CONTACT_M, F), dev)
    torch.cuda.synchronize()
    print("K7 checks passed")
except RuntimeError as e:
    print("caught: K7:", str(e)[:400])
    sys.exit(1)
"""

if __name__ == "__main__":
    sys.exit(run_faults(BUILD / "k7_faults", FAULTS, RUN, sys.argv[1:],
                        caught_by={f: "K7" for f in FAULTS}, workers=2))
