#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``shapy_tpu_torch``) on one NVIDIA
GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):

1. Prints the card's name and power limit, and builds the three
   hand-written CUDA kernels (K1 measure, K2 ingest, K3 skinning) from
   ``shapy_tpu_torch/csrc/`` with nvcc.
2. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (batch 32, SMPL-X 10475 vertices / 20908 faces,
   K=256 hull directions, 480x360 uint8 images -> 256x256 crops) and
   times both with CUDA events.
3. Serves the flagship (HRNet-W48 at full width, 3-stage head with MLP
   (1024, 1024), SMPL-X, measurements; bf16 backbone) through
   ``apply_from_full_images``: one warm-up, then 3 requests of batch 32.
   Weights are random from a seed. Checks that every output is finite,
   that betas vary per image inside the candidate-face bound, and that
   every kernel was launched by this run.
4. Cross-device parity: the same weights at batch 2 with an f32 backbone
   and TF32 off, the CPU port (plain versions) against the CUDA port
   (kernels).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without CUDA, or without
the repository beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

B = 32
IMAGE_H, IMAGE_W = 360, 480
CROP = 256
SEED = 0
BETA_BOUND = 8.0  # candidate_faces' bound: the subsets are exact inside it


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time per call from CUDA events around ``iters`` calls.

    The calls are queued behind a spin kernel that outlasts their host-side
    launching, so the events time the device work back to back and not the
    host's launch rate (a kernel of tens of microseconds launches slower
    than it runs)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0  # bounds one call's launch time
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * 1.5 * iters * host_s))  # cycles at <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def kernels():
    """(name, CudaKernel, source, replaced TPU-side function) of the path."""
    from shapy_tpu_torch.data.crop import INGEST_KERNEL
    from shapy_tpu_torch.measure.measurements import MEASURE_KERNEL
    from shapy_tpu_torch.models.body.lbs import SKIN_KERNEL

    return [
        ("K1_measure", MEASURE_KERNEL, "shapy_tpu_torch/csrc/measure.cu",
         "shapy_tpu/ops/plane_slice.py:74"),
        ("K2_ingest", INGEST_KERNEL, "shapy_tpu_torch/csrc/ingest.cu",
         "shapy_tpu/data/crop.py:96"),
        ("K3_skinning", SKIN_KERNEL, "shapy_tpu_torch/csrc/skinning.cu",
         "shapy_tpu/models/body/lbs.py:97"),
    ]


def check_kernels(regressor, requests, dev):
    """Each kernel against its plain version at the main path's shapes.
    Returns {name: (max_abs_err, ms, plain_ms)}."""
    import torch

    from shapy_tpu_torch.core.kinematics import batch_rigid_transform
    from shapy_tpu_torch.core.rotations import aa_to_rotmat
    from shapy_tpu_torch.data.crop import crop_normalize, crop_normalize_plain
    from shapy_tpu_torch.measure.measurements import (
        PLANES,
        measure_plain,
        measure_reference,
    )
    from shapy_tpu_torch.models.body.lbs import skin, skin_plain

    results = {}
    gen = torch.Generator().manual_seed(SEED + 1)
    model = regressor.model
    meas = regressor.body_measurements

    # K1: bodies with ||beta|| <= 8, on the candidate subsets (the main
    # path) and on all faces. Tolerances: mass / height rel 1e-5 (f32 sums
    # in another order), circumferences atol 1e-5 m (identical hit tests
    # without FMA; centroid and hull sums in another order).
    betas = torch.randn((B, model.num_betas), generator=gen) * 1.5
    betas = betas * torch.clamp(6.0 / betas.norm(dim=1, keepdim=True), max=1)
    v_shaped = model.forward_shape(betas.to(dev))["v_shaped"].contiguous()
    subsets = [getattr(meas, f"subset_{n}") for n in PLANES]
    k1_err = 0.0
    for plane_faces in (subsets, None):
        args = (v_shaped, meas.faces, plane_faces, meas.anchors)
        got, got_h = measure_reference(*args, meas.anchor_face,
                                       meas.anchor_bary, meas.hull_cos,
                                       meas.hull_sin, meas.density)
        want, want_h = measure_plain(*args, meas.num_hull_directions,
                                     meas.density)
        torch.cuda.synchronize()
        rel = ((got[:, :2] - want[:, :2]).abs() / want[:, :2].abs()).max()
        circ = max_err(got[:, 2:], want[:, 2:])
        print(f"K1 measure ({'subsets' if plane_faces else 'all faces'}): "
              f"mass/height rel err {float(rel):.3e} (tol 1e-5), "
              f"circumference err {circ:.3e} m (tol 1e-5)")
        check(float(rel) <= 1e-5, f"K1 mass/height rel err {float(rel)}")
        check(circ <= 1e-5, f"K1 circumference err {circ} m")
        check(max_err(got_h, want_h) <= 1e-6, "K1 plane heights")
        check(bool((got[:, 2:] > 0.5).all()), "K1 empty slices")
        k1_err = max(k1_err, max_err(got, want))
    k1 = (v_shaped, meas.faces, subsets, meas.anchors)
    results["K1_measure"] = (
        k1_err,
        time_ms(lambda: measure_reference(
            *k1, meas.anchor_face, meas.anchor_bary, meas.hull_cos,
            meas.hull_sin, meas.density)),
        time_ms(lambda: measure_plain(*k1, meas.num_hull_directions,
                                      meas.density)))

    # K2: uint8 images -> f32 (tolerance 1e-5: the same operations in the
    # same order, the kernel without FMA) and bf16 (the backbone's input;
    # tolerance one bf16 rounding step of values up to |2.7|).
    images, affines = requests
    err32 = max_err(crop_normalize(images, affines, CROP),
                    crop_normalize_plain(images, affines, CROP))
    bf = crop_normalize(images, affines, CROP, out_dtype=torch.bfloat16)
    bf_plain = crop_normalize_plain(images, affines, CROP,
                                    out_dtype=torch.bfloat16)
    err16 = max_err(bf, bf_plain)
    torch.cuda.synchronize()
    print(f"K2 ingest: f32 err {err32:.3e} (tol 1e-5), bf16 err "
          f"{err16:.3e} (tol {2.0 ** -6:.3e})")
    check(err32 <= 1e-5, f"K2 f32 err {err32}")
    check(err16 <= 2.0 ** -6, f"K2 bf16 err {err16}")
    results["K2_ingest"] = (
        err16,
        time_ms(lambda: crop_normalize(images, affines, CROP,
                                       out_dtype=torch.bfloat16)),
        time_ms(lambda: crop_normalize_plain(images, affines, CROP,
                                             out_dtype=torch.bfloat16)))

    # K3: posed bodies at SMPL-X size. Tolerance atol 1e-5 m: sums of 55
    # weighted transforms in another order.
    aa = (torch.randn((B, model.num_joints, 3), generator=gen) * 0.3).to(dev)
    joints = torch.matmul(model.J_regressor, v_shaped)
    _, rel, _ = batch_rigid_transform(aa_to_rotmat(aa), joints,
                                      model.parents, model.levels)
    rel = rel.contiguous()
    v_posed = (v_shaped + 0.01 * torch.randn(v_shaped.shape, generator=gen)
               .to(dev)).contiguous()
    err = max_err(skin(model.lbs_weights, rel, v_posed),
                  skin_plain(model.lbs_weights, rel, v_posed))
    torch.cuda.synchronize()
    print(f"K3 skinning: err {err:.3e} m (tol 1e-5)")
    check(err <= 1e-5, f"K3 err {err}")
    results["K3_skinning"] = (
        err,
        time_ms(lambda: skin(model.lbs_weights, rel, v_posed)),
        time_ms(lambda: skin_plain(model.lbs_weights, rel, v_posed)))
    for name, (e, ms, plain_ms) in results.items():
        print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return results


def serve(regressor, requests):
    """The main path: warm-up, then 3 requests of batch B. Returns the
    launch counts of this run and images/s."""
    import torch

    images, affines = requests
    with torch.inference_mode():
        regressor.apply_from_full_images(images, affines, CROP)
        torch.cuda.synchronize()
        for _, kernel, _, _ in kernels():
            kernel.launches = 0
        start = time.perf_counter()
        outs = [regressor.apply_from_full_images(images, affines, CROP)
                for _ in range(3)]
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        launches = {name: kernel.launches for name, kernel, _, _ in kernels()}

    for out in outs:
        last = out["stage_02"]
        tensors = [out["features"], out["proj_joints"], last["vertices"],
                   last["joints"], last["v_shaped"], last["betas"],
                   *out["measurements"].values()]
        check(all(bool(torch.isfinite(t).all()) for t in tensors),
              "non-finite output")
        check(last["vertices"].shape == (B, regressor.model.num_verts, 3),
              "vertices shape")
    betas = outs[-1]["stage_02"]["betas"]
    beta_norm = float(betas.norm(dim=1).max())
    spread = float(betas.std(dim=0).max())
    check(beta_norm < BETA_BOUND, f"||beta|| {beta_norm} outside the bound")
    check(spread > 1e-3, "betas do not vary per image")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by the main path")
    rate = 3 * B / elapsed
    meas = {k: [round(float(v.min()), 4), round(float(v.max()), 4)]
            for k, v in outs[-1]["measurements"].items()}
    print(f"slice: 3 requests of {B} in {elapsed * 1e3:.1f} ms = "
          f"{rate:.1f} images/s; max ||beta|| {beta_norm:.3f}, "
          f"betas std over batch up to {spread:.4f}; launches {launches}")
    print(f"measurements (min, max): {json.dumps(meas)}")
    return launches, rate


def parity(base, requests, dev):
    """CPU port (plain versions) vs CUDA port (kernels), f32, no TF32."""
    import torch

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        images, affines = (t[:2] for t in requests)
        outs = []
        for device in ("cpu", dev):
            reg = copy.deepcopy(base).to(device).prepare_for_eval_()
            with torch.inference_mode():
                out = reg.apply_from_full_images(images.to(device),
                                                 affines.to(device), CROP)
            last = out["stage_02"]
            outs.append({"betas": last["betas"].cpu(),
                         "vertices": last["vertices"].cpu(),
                         **{k: v.cpu() for k, v in
                            out["measurements"].items()}})
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    cpu, gpu = outs
    # Tolerances: ~100 f32 conv layers in another order on each side
    # drift the features by ~1e-5 relative.
    scale = float(cpu["betas"].norm(dim=1).max())
    errs = {"betas": max_err(cpu["betas"], gpu["betas"]) / scale,
            "vertices": max_err(cpu["vertices"], gpu["vertices"])}
    for k in ("mass", "height", "chest", "waist", "hips"):
        errs[k] = float(((cpu[k] - gpu[k]).abs() / cpu[k].abs()).max())
    tols = {"betas": 1e-3, "vertices": 1e-4, "mass": 1e-4, "height": 1e-4,
            "chest": 1e-4, "waist": 1e-4, "hips": 1e-4}
    print("cross-device parity (betas rel to max ||beta||, vertices m, "
          "measurements rel): " + ", ".join(
              f"{k} {errs[k]:.3e} (tol {tols[k]:g})" for k in errs))
    for k, e in errs.items():
        check(e <= tols[k], f"cross-device parity {k}: {e} > {tols[k]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from shapy_tpu_torch.flagship import (
        build_flagship,
        spread_init_,
        synthetic_requests,
    )

    print(gpu_line())
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    for name, kernel, _, _ in kernels():
        t = time.perf_counter()
        kernel.build()
        regs = [ln.strip() for ln in kernel.build_log.splitlines()
                if "registers" in ln]
        print(f"built {name} in {time.perf_counter() - t:.1f} s; "
              f"{' | '.join(regs) or 'cached build'}")

    base = build_flagship(subdivisions=5, exact_counts=True, device="cpu",
                          seed=SEED)
    spread_init_(base, seed=SEED, beta_scale=0.25)
    regressor = copy.deepcopy(base).to(dev).prepare_for_eval_(torch.bfloat16)
    images, affines = synthetic_requests(B, IMAGE_H, IMAGE_W, CROP, SEED)
    requests = (torch.from_numpy(images).to(dev),
                torch.from_numpy(affines).to(dev))

    checked = check_kernels(regressor, requests, dev)
    launches, _ = serve(regressor, requests)
    parity(base, tuple(t.cpu() for t in requests), dev)

    entries = []
    for name, _, source, replaces in kernels():
        err, ms, plain_ms = checked[name]
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
        check(math.isfinite(ms) and math.isfinite(plain_ms), "timing")
    print(gpu_line())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
