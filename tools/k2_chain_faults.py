"""Show that ``chip_smoke.py``'s K2 and K3-chain checks catch planted
faults.

Needs one CUDA card. For each fault, the port and ``chip_smoke.py`` are
copied into ``shapy_tpu_torch/_build/k2_chain_faults/<fault>/`` with one
part of the copy's ``csrc/ingest.cu`` or ``csrc/kinematic_chain.cu``
changed (``chip_harness.run_faults``), and the copy runs phase 2's
``check_k2`` (the served requests at batch 32 and 128 and the extreme
affines, uint8 and f32 in, f32 and bf16 out, each bit-equal to the plain
version) and ``check_k3chain`` (three trees at batch 32 and 48: the plain
version in f64 and f32, the replays, two calls, a body alone), with the
timings reduced to one call. The unplanted copy must pass and every
planted one fail, in the check that its kernel belongs to.

    python tools/k2_chain_faults.py [fault ...]

Each copy's output goes to
``shapy_tpu_torch/_build/k2_chain_faults/<fault>.log``; the last line is a
JSON summary of return codes and verdicts. The copies run four at a time.
"""

from __future__ import annotations

import sys

from chip_harness import BUILD, run_faults

INGEST = "shapy_tpu_torch/csrc/ingest.cu"
CHAIN = "shapy_tpu_torch/csrc/kinematic_chain.cu"

# fault -> [(file, text, replacement)]: changes to a copy.
FAULTS = {
    "none": [],
    # K2: each tile's last column left unwritten (the tile one column
    # narrower, so it leaves element by element).
    "k2_tile_last_column": [(
        INGEST,
        "  const int w = min(kTile, S - tx), h = min(kTile, S - ty);\n",
        "  const int w = min(kTile, S - tx) - 1, h = min(kTile, S - ty);\n")],
    # K2: the staged box's last row not copied (its corners read what the
    # shared memory held before).
    "k2_box_row_short": [(
        INGEST,
        "    const int chunks = pitch / 16, n = chunks * bh;\n",
        "    const int chunks = pitch / 16, n = chunks * (bh - 1);\n")],
    # K3-chain's forward: the last joint (the last of its level) never
    # composed.
    "chain_level_last_joint": [(
        CHAIN,
        "    if (nd.depth == l) {\n",
        "    if (nd.depth == l && j != J - 1) {\n")],
    # K3-chain's backward: a parent's first two children added in the
    # other order (the same sum up to rounding).
    "chain_children_order": [(
        CHAIN,
        "        const int c = s.children[nd.first + n];\n"
        "        const float* R = Rs + c * 9;\n",
        "        const int c = s.children[nd.first + (\n"
        "            nd.count > 1 && n < 2 ? 1 - n : n)];\n"
        "        const float* R = Rs + c * 9;\n")],
}

CAUGHT_BY = {"k2_tile_last_column": "K2", "k2_box_row_short": "K2",
             "chain_level_last_joint": "K3-chain",
             "chain_children_order": "K3-chain"}

RUN = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from shapy_tpu_torch.flagship import build_flagship, synthetic_requests
cs.time_ms = lambda fn, iters=20, warmup=3: (fn(), 1.0)[1]
dev = torch.device("cuda", 0)
images, affines = synthetic_requests(cs.B, cs.IMAGE_H, cs.IMAGE_W, cs.CROP,
                                     cs.SEED)
requests = (torch.from_numpy(images).to(dev),
            torch.from_numpy(affines).to(dev))
model = build_flagship(subdivisions=5, exact_counts=True, device="cpu",
                       seed=cs.SEED).model.to(dev)
failed = False
for name, check in (("K2", lambda: cs.check_k2(requests, dev)),
                    ("K3-chain", lambda: cs.check_k3chain(model, dev))):
    try:
        check()
        print(f"{name} checks passed")
    except RuntimeError as e:
        print(f"caught: {name}:", str(e)[:400])
        failed = True
sys.exit(1 if failed else 0)
"""

if __name__ == "__main__":
    sys.exit(run_faults(BUILD / "k2_chain_faults", FAULTS, RUN, sys.argv[1:],
                        caught_by=CAUGHT_BY))
