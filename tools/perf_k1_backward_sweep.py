"""K1's and K1-exact's backward in variants of ``csrc/measure.cu`` and of
its plan, on one card: what holds the two kernels back.

Needs one CUDA card. Each variant is a copy of a tree's port (``--tree``:
this repository, or a checkout of another commit such as its parent under
``chip_archive/``) under ``shapy_tpu_torch/_build/k1_backward_sweep/
<variant>/`` with some text replaced (``chip_harness.planted_copy``). A
subprocess per variant builds the copy and times, as device time from
``chip_harness.trace`` (``torch.profiler`` traces of 5 calls between spin
kernels, checked), one backward of the measurements on all faces of the
flagship's SMPL-X (``chip_harness.body_model``; seeded bodies of 1.5
sigma and seeded cotangents on all eight outputs, K = 256) at batch 1, 32
and 48 in both slice modes: each kernel's device time
(``measure_backward_planes``, ``measure_backward_vertices``), the busy
time of the call (their union) and the gradient's hash (a variant that
leaves a part out times the rest and nothing else; one that changes a
plan constant must keep the hash).

    python tools/perf_k1_backward_sweep.py [--tree TREE] [--variants NAME ...]

Variants of the parent's kernels (``--tree`` its checkout; names
``parent_*``): ``parent_as_is``; ``parent_no_tie_sweep`` (no thread sweeps
the hits for its directions' extremes and ties); ``parent_no_hit_vjp``
(no hit's chain taken, in either kernel, nor its triangle loaded);
``parent_no_plane_probes`` (the vertices kernel probes no plane's slot
map); ``parent_no_mass`` (no mass term). The parts are left out by a
condition false at run time. Variants of this tree's kernels: ``as_is``;
``no_tie_sweep``, ``no_hit_vjp`` (nor the triangle's loads),
``no_plane_probes`` (no word of the hit map read, no record),
``no_mass`` (nor its vertex loads) as above, ``no_marks`` (no hit's face
marked for the vertices pass, which then has nothing to do);
``marked_ctas_4`` (4 CTAs a body for the marked vertices, not 8);
``blocks_1``, ``blocks_8`` (at most 1 or 8 CTAs a row in
``measure_backward_plan``, not 4), ``rows_of_2`` (at least 2). A variant
of the plan or of a grid keeps the hashes. Prints a JSON line a
variant.
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

from chip_harness import BUILD, REPO, planted_copy, run_script

OUT = BUILD / "k1_backward_sweep"
MEASURE = "shapy_tpu_torch/csrc/measure.cu"


# name -> [(file, text, replacement)]
MEAS_PY = "shapy_tpu_torch/measure/measurements.py"


def _blocks(n: int) -> list:
    return [(MEAS_PY, "_K1B_MAX_BLOCKS = 4", f"_K1B_MAX_BLOCKS = {n}")]


VARIANTS = {
    "as_is": [],
    "no_tie_sweep": [(MEASURE, "      int i = share;\n",
                      "      int i = V < 0 ? share : m;\n")],
    "no_hit_vjp": [(
        MEASURE, "      hit_vjp<kMode>(T, h, in.code & 15, pg.x + cgx, pg.y + "
        "cgz, g9, gh);\n",
        "      for (int i = 0; i < kRecord; ++i) g9[i] = pg.x;\n"
        "      gh = pg.y;\n      if (V < 0) hit_vjp<kMode>(T, h, in.code & "
        "15, pg.x + cgx, pg.y + cgz, g9, gh);\n")],
    "no_plane_probes": [(
        MEASURE, "    for (int p = 0; p < 3; ++p) {\n      if (!(marks >> p & "
        "1u)) continue;", "    for (int p = 0; p < 3 * (V < 0); ++p) {\n"
        "      if (!(marks >> p & 1u)) continue;")],
    "no_mass": [(
        MEASURE, "      if (at + k < e1) {\n        gx += gm * (u[k][1]",
        "      if (at + k < e1 && V < 0) {\n        gx += gm * (u[k][1]")],
    "no_marks": [(
        MEASURE, "  return atomicOr(&flags[(size_t)b * V + u], bits);",
        "  return V < 0 ? atomicOr(&flags[(size_t)b * V + u], bits) : 1u;")],
    "marked_ctas_4": [(
        MEASURE, "constexpr int kMarkedCtas = 8;",
        "constexpr int kMarkedCtas = 4;")],
    "blocks_1": _blocks(1),
    "rows_of_2": [(MEAS_PY, "max(1, min(_K1B_MAX_BLOCKS,",
                   "max(2, min(_K1B_MAX_BLOCKS,")],
    "blocks_8": _blocks(8),
    "parent_as_is": [],
    "parent_no_tie_sweep": [(
        MEASURE, "  for (int start = 0; start < n; start += kChunk) {\n"
        "    const int m = min(kChunk, n - start);\n"
        "    __syncthreads();  // the previous chunk is consumed\n",
        "  for (int start = 0; start < n * (V < 0); start += kChunk) {\n"
        "    const int m = min(kChunk, n - start);\n"
        "    __syncthreads();  // the previous chunk is consumed\n")],
    "parent_no_hit_vjp": [
        (MEASURE, "    hit_vjp<kMode>(T, h, code & 15, ga, gb, gv, gh);\n",
         "    gh = 0.f;\n    if (V < 0) hit_vjp<kMode>(T, h, code & 15, ga, "
         "gb, gv, gh);\n"),
        (MEASURE, "        hit_vjp<kMode>(T, h, cp[j] & 15, gp[j].x, "
         "gp[j].y, g9, gh);\n",
         "        for (int k = 0; k < 9; ++k) g9[k] = gp[j].x;\n"
         "        if (V < 0) hit_vjp<kMode>(T, h, cp[j] & 15, gp[j].x, "
         "gp[j].y, g9, gh);\n")],
    "parent_no_plane_probes": [(
        MEASURE, "  // Circumferences: the hits of each plane in the faces "
        "around v.\n  for (int p = 0; p < 3; ++p) {\n",
        "  // Circumferences: the hits of each plane in the faces "
        "around v.\n  for (int p = 0; p < 3 * (V < 0); ++p) {\n")],
    "parent_no_mass": [(
        MEASURE, "  for (int e = face_ptr[v]; e < face_ptr[v + 1]; ++e) {\n"
        "    const int ent = face_idx[e], c = ent & 3;\n",
        "  for (int e = face_ptr[v]; e < face_ptr[v + 1] * (V > 0 ? 0 : 1); "
        "++e) {\n    const int ent = face_idx[e], c = ent & 3;\n")],
}

RUN = r"""
import hashlib, json, sys, torch
sys.path.insert(0, ".")
from chip_harness import PASSES, body_model, busy_ms, card, trace
from shapy_tpu_torch.measure.measurements import BodyMeasurements

dev = torch.device("cuda", 0)
model, anchors = body_model(dev)
out = {"variant": sys.argv[1], "card": card()}
gen = torch.Generator().manual_seed(10)
for batch in (1, 32, 48):
    betas = torch.randn((batch, model.num_betas), generator=gen) * 1.5
    v = model.forward_shape(betas.to(dev))["v_shaped"].detach().contiguous()
    g = (torch.randn((batch, 5), generator=gen).to(dev),
         torch.randn((batch, 3), generator=gen).to(dev))
    for mode in ("reference", "exact"):
        meas = BodyMeasurements(anchors, model.faces, 256,
                                slice_mode=mode).to(dev)
        x = v.clone().requires_grad_()
        outs = meas.measure(x, use_face_subsets=False)

        def bwd():
            return torch.autograd.grad(outs, x, g, retain_graph=True)[0]

        grad = bwd()
        events = trace(bwd)
        out[f"{mode}_b{batch}"] = {
            **{k: sum(b - a for a, b, n in events if f"backward_{k}" in n)
               / 1e3 / PASSES for k in ("planes", "vertices")},
            "busy": busy_ms(events),
            "hash": hashlib.sha256(grad.cpu().numpy().tobytes()).hexdigest()[
                :16]}
print(json.dumps(out))
"""


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=str(REPO))
    parser.add_argument("--variants", nargs="+", default=list(VARIANTS))
    args = parser.parse_args(argv)
    failed = 0
    for name in args.variants:
        dst = planted_copy(OUT / name, VARIANTS[name],
                           root=Path(args.tree).resolve())
        proc = run_script(RUN, dst, (name,), timeout=600)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(f"{name}: rc {proc.returncode}\n{proc.stderr[-2000:]}")
            failed += 1
        else:
            print(lines[-1], flush=True)
        shutil.rmtree(dst)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
