"""K1's and K1-exact's backward and the shape fit that runs them, on two
trees, in turns on one card.

Needs one CUDA card. Each tree given is a checkout of the repository (this
one, and for instance ``git archive`` of its parent unpacked under
``chip_archive/``). For each tree in turn a subprocess with that tree first
on ``sys.path`` builds the tree's own kernels and times, as device time
from ``chip_harness.trace`` (``torch.profiler`` traces of 5 calls between
spin kernels, checked), on the flagship's SMPL-X (``chip_harness
.body_model``: 10475 vertices, 20908 faces, K = 256 hull directions):

* ``reference_b<B>``, ``exact_b<B>``: one backward of the measurements
  on all faces (``BodyMeasurements.measure``, seeded bodies of 1.5 sigma
  and seeded cotangents on all eight outputs) at batch 1, 32 (the fit's)
  and 48 (the train step's): ``planes_ms`` and ``vertices_ms``, each
  kernel's device time (``measure_backward_planes``,
  ``measure_backward_vertices``), ``busy_ms``, the time at least one of
  the call's kernels runs (the two overlap where the second is a
  programmatic dependent), ``kernels`` a call, ``peak_mb``, the memory
  the call allocates at its peak (the gradient included), and ``hash``,
  the gradient's bytes', so that bit-equality across the trees shows;
* ``fit_<mode>_b<B>``: ``fit_betas_to_measurements`` as phase 8 of
  ``chip_smoke.py`` runs it (both slice modes, batch 1 from zero betas,
  batch 32 from seeded betas): ``busy_ms_per_step`` and
  ``kernels_per_step`` from a trace of 5 fits of 5 steps (the fit's set-up
  and last measurement spread over its steps, as in ``PERF.md`` §5),
  ``steps_per_s`` over 200 steps on the host clock;
* ``fit_peak_mb_b<B>``: the peak memory of a 2-step fit at batch 32 and
  48 in each mode (``torch.cuda.max_memory_allocated``, the body model
  included).

The trees run in turns (``chip_harness.in_turns``, ``--rounds 2``: a b b
a), each run printing one JSON line; the last line gives each tree's
median of each number.

    python tools/perf_k1_backward_compare.py [--rounds N] TREE [TREE ...]
"""

from __future__ import annotations

import argparse
import sys

from chip_harness import in_turns

RUN = r"""
import hashlib, json, sys, time, numpy as np, torch
sys.path.insert(0, ".")
from chip_harness import PASSES, body_model, busy_ms, card, smoke, trace
from shapy_tpu_torch.measure.fit_measurements import (
    fit_betas_to_measurements)
from shapy_tpu_torch.measure.measurements import BodyMeasurements

cs = smoke()
dev = torch.device("cuda", 0)
model, anchors = body_model(dev)
out = {"card": card()}
metas = {m: BodyMeasurements(anchors, model.faces, 256,
                             slice_mode=m).to(dev)
         for m in ("reference", "exact")}


def kernel_ms(events, name):
    return sum(b - a for a, b, n in events if name in n) / 1e3 / PASSES


gen = torch.Generator().manual_seed(cs.SEED + 10)
for batch in (1, cs.FIT_B, cs.TRAIN_B):
    betas = torch.randn((batch, model.num_betas), generator=gen) * 1.5
    v = model.forward_shape(betas.to(dev))["v_shaped"].detach().contiguous()
    g = (torch.randn((batch, 5), generator=gen).to(dev),
         torch.randn((batch, 3), generator=gen).to(dev))
    for mode, meas in metas.items():
        x = v.clone().requires_grad_()
        outs = meas.measure(x, use_face_subsets=False)

        def bwd():
            return torch.autograd.grad(outs, x, g, retain_graph=True)[0]

        grad = bwd()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        bwd()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        events = trace(bwd)
        out[f"{mode}_b{batch}"] = {
            "planes_ms": kernel_ms(events, "measure_backward_planes"),
            "vertices_ms": kernel_ms(events, "measure_backward_vertices"),
            "busy_ms": busy_ms(events), "kernels": len(events) // PASSES,
            "peak_mb": peak / 1e6,
            "hash": hashlib.sha256(grad.cpu().numpy().tobytes()).hexdigest()[
                :16]}
        del outs, x

rng = np.random.default_rng(cs.SEED + 11)
target_betas = torch.tensor(rng.normal(size=(1, model.num_betas)),
                            dtype=torch.float32, device=dev)
inits = {batch: torch.tensor(rng.normal(size=(batch, model.num_betas)) * 0.5,
                             dtype=torch.float32)
         for batch in (cs.FIT_B, cs.TRAIN_B)}
inits[1] = None
for mode, meas in metas.items():
    with torch.no_grad():
        m = meas.forward_from_vertices(
            model.forward_shape(target_betas)["v_shaped"],
            use_face_subsets=False)["measurements"]
    targets = {k: float(m[k]["tensor"][0]) for k in cs.MEASURED}
    for batch in (1, cs.FIT_B, cs.TRAIN_B):

        def fit(steps):
            return fit_betas_to_measurements(
                model, meas, targets, init_betas=inits[batch],
                batch_size=batch, num_steps=steps,
                learning_rate=cs.FIT_LR, shape_prior_weight=cs.FIT_PRIOR)

        fit(2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fit(2)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e6
        if batch != 1:
            out[f"fit_peak_mb_b{batch}"] = dict(
                out.get(f"fit_peak_mb_b{batch}", {}), **{mode: peak})
        if batch == cs.TRAIN_B:
            continue
        events = trace(lambda: fit(5))
        t0 = time.perf_counter()
        fit(cs.FIT_STEPS)
        torch.cuda.synchronize()
        out[f"fit_{mode}_b{batch}"] = {
            "busy_ms_per_step": busy_ms(events) / 5,
            "kernels_per_step": len(events) / PASSES / 5,
            "steps_per_s": cs.FIT_STEPS / (time.perf_counter() - t0)}
print(json.dumps(out))
"""


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("trees", nargs="+")
    args = parser.parse_args(argv)
    return in_turns(RUN, args.trees, args.rounds)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
