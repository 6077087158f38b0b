"""K5-fuse's backward, K1's forward, the fit and the HRNet train step on
two trees, in turns on one card.

Needs one CUDA card. Each tree given is a checkout of the repository (this
one, and for instance ``git archive`` of its parent unpacked under
``chip_archive/``). For each tree in turn a subprocess with that tree first
on ``sys.path`` builds the tree's own kernels and times, with this
repository's ``chip_smoke.py`` helpers whichever tree is timed:

* ``fuse_bwd_26_ms``: the device time of one HRNet-W48 train step's 26
  fusion backwards at batch 48, recorded from the step and replayed
  (``train_step_calls``, ``device_ms``: phase 2's protocol);
* ``k1_fwd_ms``: the device time of one K1 forward (``meas.measure`` on
  bodies that need no gradient) on all faces at batch 1 and 48 in both
  slice modes, on the candidate subsets at the served batch 32, and of K1
  alone on the scorer's triangles at batch 32 in both modes (K1-AoS's
  walk);
* ``fit_steps_per_s``: phase 8's fits (``fit_betas_to_measurements``, 200
  steps after a warm-up fit) at batch 1 in both modes and at batch 32 in
  reference mode, on the host clock, and ``fit_busy_ms_per_step``: the
  device time of 5 fit steps at batch 1 (reference), per step;
* ``train``: ``utils/profiling.profile_train_step`` of the tree at batch
  48: the step's device busy time, idle share and ``hr_fuse.cu``'s time
  and share of the busy time.

The trees run in turns (``--rounds 3``: a b b a a b), each run printing
one JSON line; the last line gives each tree's median of each number.

    python tools/perf_fuse_k1_compare.py [--rounds N] TREE [TREE ...]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"
RUN = r"""
import copy, importlib.util, json, sys, time, numpy as np, torch
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from shapy_tpu_torch.flagship import build_flagship, spread_init_
from shapy_tpu_torch.measure.fit_measurements import (
    fit_betas_to_measurements)
from shapy_tpu_torch.measure.measurements import (
    BodyMeasurements, _MeasureKernel)
from shapy_tpu_torch.models.backbones.hrnet import _hr_fuse_backward_cuda
from shapy_tpu_torch.utils.profiling import profile_train_step

dev = torch.device("cuda", 0)
out = {"card": cs.gpu_line()}
base = build_flagship(subdivisions=5, exact_counts=True, device="cpu",
                      seed=cs.SEED)
spread_init_(base, seed=cs.SEED, beta_scale=0.25)
_, fuses, _, _ = cs.train_step_calls(base, dev)
out["fuse_bwd_26_ms"] = cs.device_ms(cs.replay(_hr_fuse_backward_cuda, fuses))
del fuses
torch.cuda.empty_cache()

model = copy.deepcopy(base.model).to(dev)
served = copy.deepcopy(base.body_measurements).to(dev)
anchors, F = served.anchors, served.faces.shape[0]
gen = torch.Generator().manual_seed(cs.SEED + 10)
k1 = {}
for batch in (1, cs.TRAIN_B, cs.B):
    betas = torch.randn((batch, model.num_betas), generator=gen) * 1.5
    v = model.forward_shape(betas.to(dev))["v_shaped"].detach().contiguous()
    if batch == cs.B:
        k1[f"subsets_b{batch}"] = cs.device_ms(lambda: served.measure(v))
        tri = v[:, model.faces_tensor.long()].contiguous()
    for mode in ("reference", "exact"):
        meas = BodyMeasurements(anchors, model.faces, 256,
                                slice_mode=mode).to(dev)
        if batch != cs.B:
            k1[f"{mode}_all_b{batch}"] = cs.device_ms(
                lambda: meas.measure(v, False))
            continue
        walk = meas._triangle_walk(F, dev, tuple(anchors.ordered()),
                                   (F,) * 3)
        k1[f"{mode}_aos_walk_b{batch}"] = cs.device_ms(
            lambda: _MeasureKernel.apply(tri.view(batch, 3 * F, 3), meas,
                                         walk, False))
out["k1_fwd_ms"] = k1

rng = np.random.default_rng(cs.SEED + 11)
target_betas = torch.tensor(rng.normal(size=(1, model.num_betas)),
                            dtype=torch.float32, device=dev)
init32 = torch.tensor(rng.normal(size=(cs.FIT_B, model.num_betas)) * 0.5,
                      dtype=torch.float32)
kwargs = dict(learning_rate=cs.FIT_LR, shape_prior_weight=cs.FIT_PRIOR)
fits = {}
for mode, batch, init in (("reference", 1, None), ("exact", 1, None),
                          ("reference", cs.FIT_B, init32)):
    meas = BodyMeasurements(anchors, model.faces, 256,
                            slice_mode=mode).to(dev)
    with torch.no_grad():
        m = meas.forward_from_vertices(
            model.forward_shape(target_betas)["v_shaped"],
            use_face_subsets=False)["measurements"]
    targets = {k: float(m[k]["tensor"][0]) for k in cs.MEASURED}

    def fit(steps):
        return fit_betas_to_measurements(model, meas, targets,
                                         init_betas=init, batch_size=batch,
                                         num_steps=steps, **kwargs)

    fit(cs.FIT_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit(cs.FIT_STEPS)
    torch.cuda.synchronize()
    fits[f"{mode}_b{batch}"] = cs.FIT_STEPS / (time.perf_counter() - t0)
    if mode == "reference" and batch == 1:
        out["fit_busy_ms_per_step"] = cs.device_ms(lambda: fit(5)) / 5
out["fit_steps_per_s"] = fits

train = profile_train_step(batch=cs.TRAIN_B, iters=3)
traced = train["traced_per_step"]
fuse = traced["hand_kernels"]["hr_fuse.cu"]
out["train"] = {"step_wall_ms": train["step_wall_ms"],
                "device_busy_ms": traced["device_busy_ms"],
                "device_idle_share": traced["device_idle_share"],
                "hr_fuse_cu": dict(zip(("ms", "launches", "share"), fuse))}
print(json.dumps(out))
"""


def _flat(row: dict, prefix: str = "") -> dict:
    flat = {}
    for k, v in row.items():
        if isinstance(v, dict):
            flat.update(_flat(v, f"{prefix}{k}."))
        elif isinstance(v, (int, float)):
            flat[f"{prefix}{k}"] = v
    return flat


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("trees", nargs="+")
    args = parser.parse_args(argv)
    runs = {tree: [] for tree in args.trees}
    order = []
    for i in range(args.rounds):
        order += args.trees if i % 2 == 0 else args.trees[::-1]
    for tree in order:
        proc = subprocess.run(
            [sys.executable, "-c", RUN, str(SMOKE)],
            cwd=Path(tree).resolve(), capture_output=True, text=True,
            timeout=900)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(f"{tree}: rc {proc.returncode}\n{proc.stderr[-3000:]}")
            return 1
        row = json.loads(lines[-1])
        row["tree"] = tree
        runs[tree].append(row)
        print(json.dumps(row), flush=True)
    medians = {}
    for tree, rows in runs.items():
        flats = [_flat(r) for r in rows]
        medians[tree] = {k: statistics.median(f[k] for f in flats)
                         for k in flats[0]}
    print(json.dumps({"median": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
