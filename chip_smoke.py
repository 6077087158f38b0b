#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``shapy_tpu_torch``) on one NVIDIA
GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):

1. Prints the card's name and power limit, and builds the five
   hand-written CUDA kernels (K1 measure, K2 ingest, K3 skinning, K8a P2P
   point error, K8b aligned point error) from ``shapy_tpu_torch/csrc/``,
   one nvcc process each, all started together.
2. Holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes (batch 32, SMPL-X 10475 vertices / 20908 faces,
   K=256 hull directions, 480x360 uint8 images -> 256x256 crops, a
   P2P regressor of 20000 points x 3 vertices, alignments over 10475
   vertices) and times both with CUDA events; computes each kernel's
   bound (bytes or FLOPs of this run's inputs at 3.35 TB/s / 67 TFLOP/s).
3. Serves the flagship (HRNet-W48 at full width, 3-stage head with MLP
   (1024, 1024), SMPL-X, measurements; bf16 backbone) through
   ``apply_from_full_images``: one warm-up, then 3 requests of batch 32.
   Weights are random from a seed. Checks that every output is finite,
   that betas vary per image inside the candidate-face bound, and that
   K1, K2 and K3 were launched by this run.
4. Cross-device parity: the same weights at batch 2 with an f32 backbone
   and TF32 off, the CPU port (plain versions) against the CUDA port
   (kernels): outputs, and the evaluator's metrics on them.
5. Evaluates the flagship of phase 3 at batch 32: 3 batches of synthetic
   ground truth (shaped and posed SMPL-X bodies from seeded betas and
   poses, GT measurements from K1 on all faces, genders and BMI buckets,
   a P2P regressor of 20000 barycentric points, a (14, V) J14 regressor)
   through ``eval.loop.make_eval_fn`` -> ``Evaluator.run`` with the
   reference's alignment sets. Checks finite metrics and group means,
   that K1, K2, K3, K8a and K8b were each launched by this run, and that
   each batch's metrics equal those of the kernels' plain versions on
   the card; prints images/s of forward + metrics.
6. Scores a synthetic HBW submission of 64 fitted bodies against their GT
   with ``cli.evaluate_hbw.evaluate_submission`` (K8b V2V, K8a P2P, K1 on
   all faces); checks the launches, finite errors and the plain versions'
   numbers.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

B = 32
IMAGE_H, IMAGE_W = 360, 480
CROP = 256
SEED = 0
BETA_BOUND = 8.0  # candidate_faces' bound: the subsets are exact inside it
EVAL_BATCHES = 3
P2P_POINTS = 20000
SUBMISSION = 64
# The H100 SXM's published peaks (at its 700 W limit): HBM bytes/s and
# f32 FLOP/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
# Kernel vs plain version on the card: per-sample mean errors in m (sums
# in another order), measurement errors exact (the same outputs).
METRIC_TOL = 1e-5


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


def bound(nbytes: float, flops: float) -> tuple:
    """(least ms, "bytes" or "operations") for the work on one H100."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernels():
    """(name, CudaKernel, source, replaced TPU-side function) of the
    paths."""
    from shapy_tpu_torch.data.crop import INGEST_KERNEL
    from shapy_tpu_torch.eval.metrics import ALIGN_KERNEL, REGRESS_KERNEL
    from shapy_tpu_torch.measure.measurements import MEASURE_KERNEL
    from shapy_tpu_torch.models.body.lbs import SKIN_KERNEL

    return [
        ("K1_measure", MEASURE_KERNEL, "shapy_tpu_torch/csrc/measure.cu",
         "shapy_tpu/ops/plane_slice.py:74"),
        ("K2_ingest", INGEST_KERNEL, "shapy_tpu_torch/csrc/ingest.cu",
         "shapy_tpu/data/crop.py:96"),
        ("K3_skinning", SKIN_KERNEL, "shapy_tpu_torch/csrc/skinning.cu",
         "shapy_tpu/models/body/lbs.py:97"),
        ("K8a_point_regress", REGRESS_KERNEL,
         "shapy_tpu_torch/csrc/point_regress.cu",
         "shapy_tpu/eval/metrics.py:228"),
        ("K8b_align_error", ALIGN_KERNEL,
         "shapy_tpu_torch/csrc/align_error.cu",
         "shapy_tpu/eval/metrics.py:123"),
    ]


def reset_launches() -> None:
    for _, kernel, _, _ in kernels():
        kernel.launches = 0


def read_launches() -> dict:
    return {name: kernel.launches for name, kernel, _, _ in kernels()}


def check_kernels(regressor, requests, eval_data, dev):
    """Each kernel against its plain version at the main paths' shapes.
    Returns {name: dict(max_abs_err, ms, plain_ms, bound_ms, bound_by)}."""
    import torch

    from shapy_tpu_torch.core.kinematics import batch_rigid_transform
    from shapy_tpu_torch.core.rotations import aa_to_rotmat
    from shapy_tpu_torch.data.crop import crop_normalize, crop_normalize_plain
    from shapy_tpu_torch.eval.metrics import (
        aligned_point_error,
        aligned_point_error_plain,
        point_regress_error,
        point_regress_error_plain,
    )
    from shapy_tpu_torch.measure.measurements import (
        PLANES,
        _soa,
        measure_plain,
        measure_reference,
    )
    from shapy_tpu_torch.models.body.lbs import skin, skin_plain
    from shapy_tpu_torch.ops.plane_slice import plane_slice_reference_soa

    results = {}
    gen = torch.Generator().manual_seed(SEED + 1)
    model = regressor.model
    meas = regressor.body_measurements

    def record(name, err, fn, plain_fn, nbytes, flops):
        ms, plain_ms = time_ms(fn), time_ms(plain_fn)
        bound_ms, bound_by = bound(nbytes, flops)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}; {nbytes / 1e6:.2f} MB, "
              f"{flops / 1e6:.1f} MFLOP), kernel at "
              f"{bound_ms / ms:.1%} of its bound")

    # K1: bodies with ||beta|| <= 6, on the candidate subsets (the main
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
        if plane_faces is subsets:
            heights = want_h
    # The work these bodies need on the subsets: the signed volume of all
    # F faces (17 FLOP each), ~150 FLOP of ray and edge tests per candidate
    # face, and 5 FLOP per (slice point, antipodal direction pair) for the
    # hull's projections and max / min (the points counted from the data).
    tx, ty, tz = _soa(v_shaped, meas.faces)
    points = 0
    for p, ids in enumerate(subsets):
        ids = ids.long()
        _, _, mask = plane_slice_reference_soa(
            ty[..., ids], tx[..., ids], tz[..., ids], heights[:, p],
            face_ids=ids)
        points += int(mask.sum())
    F = meas.faces.shape[0]
    n_cand = sum(int(ids.shape[0]) for ids in subsets)
    k1 = (v_shaped, meas.faces, subsets, meas.anchors)
    record("K1_measure", k1_err,
           lambda: measure_reference(*k1, meas.anchor_face, meas.anchor_bary,
                                     meas.hull_cos, meas.hull_sin,
                                     meas.density),
           lambda: measure_plain(*k1, meas.num_hull_directions, meas.density),
           v_shaped.numel() * 4 + F * 12 + n_cand * 4 + B * 8 * 4,
           B * F * 17 + B * n_cand * 150
           + points * (meas.num_hull_directions // 2) * 5)

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
    # Per output pixel: the affine map (8 FLOP) and, per channel, the
    # bilinear blend (11) and the normalisation (2).
    record("K2_ingest", err16,
           lambda: crop_normalize(images, affines, CROP,
                                  out_dtype=torch.bfloat16),
           lambda: crop_normalize_plain(images, affines, CROP,
                                        out_dtype=torch.bfloat16),
           images.numel() + affines.numel() * 4 + bf.numel() * 2,
           B * CROP * CROP * (8 + 3 * 13))

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
    V, J = model.lbs_weights.shape
    # Per vertex: 12 multiply-adds per joint, then the 3x4 transform.
    record("K3_skinning", err,
           lambda: skin(model.lbs_weights, rel, v_posed),
           lambda: skin_plain(model.lbs_weights, rel, v_posed),
           (V * J + rel.numel() + 2 * v_posed.numel()) * 4,
           B * V * (24 * J + 18))

    # K8a: the P2P-20k error of predicted-like against GT v_shaped.
    # Tolerance atol 1e-5 m: the translation's means summed in another
    # order (f64 in the kernel).
    reg = eval_data["p2p"]
    gt_v = eval_data["batches"][0]["gt_v_shaped"]
    pred_v = (gt_v + 0.01 * torch.randn(gt_v.shape, generator=gen).to(dev)
              + 0.02).contiguous()
    k8a = (pred_v, gt_v, reg.indices, reg.weights, reg.indices, reg.weights)
    err = 0.0
    for align in (True, False):
        e = max_err(point_regress_error(*k8a, align),
                    point_regress_error_plain(*k8a, align))
        print(f"K8a point regress (align={align}): err {e:.3e} m (tol 1e-5)")
        check(e <= 1e-5, f"K8a err {e}")
        err = max(err, e)
    P, K = reg.indices.shape
    # Per (body, point): two K-term regressions (6K FLOP each), the
    # translation and the distance (~15 FLOP).
    record("K8a_point_regress", err,
           lambda: point_regress_error(*k8a, True),
           lambda: point_regress_error_plain(*k8a, True),
           (pred_v.numel() + gt_v.numel()) * 4 + P * K * 8 + B * P * 4,
           B * P * (12 * K + 15))

    # K8b: every alignment over the posed GT vertices against a rotated,
    # scaled, shifted and perturbed copy (the v2v shapes), and procrustes
    # over an exact similarity (error ~0). Tolerance atol 1e-5 m: sums in
    # another order (f64 in the kernel).
    gt_p = eval_data["batches"][0]["gt_vertices"]
    R = torch.linalg.qr(torch.randn((B, 3, 3), generator=gen))[0]
    R = (R * torch.linalg.det(R).sign()[:, None, None]).to(dev)
    moved = (1.1 * torch.einsum("bij,bpj->bpi", R, gt_p)
             + torch.tensor([0.1, -0.3, 2.0], device=dev))
    est = (moved + 0.005 * torch.randn(gt_p.shape, generator=gen).to(dev)
           ).contiguous()
    err = 0.0
    for alignment in ("none", "root", "translation", "scale", "procrustes"):
        e = max_err(aligned_point_error(est, gt_p, alignment, (2, 3)),
                    aligned_point_error_plain(est, gt_p, alignment, (2, 3)))
        print(f"K8b align error ({alignment}): err {e:.3e} m (tol 1e-5)")
        check(e <= 1e-5, f"K8b {alignment} err {e}")
        err = max(err, e)
    exact = float(aligned_point_error(moved.contiguous(), gt_p,
                                      "procrustes").max())
    print(f"K8b procrustes of an exact similarity: max err {exact:.3e} m "
          "(tol 1e-5)")
    check(exact <= 1e-5, f"K8b similarity not recovered: {exact}")
    Pv = gt_p.shape[1]
    # Per (body, point), procrustes: means (6), centred moments (~24) and
    # the rotated, scaled point and its error (~40).
    record("K8b_align_error", err,
           lambda: aligned_point_error(est, gt_p, "procrustes"),
           lambda: aligned_point_error_plain(est, gt_p, "procrustes"),
           (est.numel() + gt_p.numel()) * 4 + B * Pv * 4,
           B * Pv * 70)
    return results


def serve(regressor, requests):
    """The main path: warm-up, then 3 requests of batch B. Returns the
    launch counts of this run and images/s."""
    import torch

    images, affines = requests
    with torch.inference_mode():
        regressor.apply_from_full_images(images, affines, CROP)
        torch.cuda.synchronize()
        reset_launches()
        start = time.perf_counter()
        outs = [regressor.apply_from_full_images(images, affines, CROP)
                for _ in range(3)]
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        launches = read_launches()

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
    for name in ("K1_measure", "K2_ingest", "K3_skinning"):
        check(launches[name] > 0, f"{name} was not launched by serving")
    rate = 3 * B / elapsed
    meas = {k: [round(float(v.min()), 4), round(float(v.max()), 4)]
            for k, v in outs[-1]["measurements"].items()}
    print(f"serve: 3 requests of {B} in {elapsed * 1e3:.1f} ms = "
          f"{rate:.1f} images/s; max ||beta|| {beta_norm:.3f}, "
          f"betas std over batch up to {spread:.4f}; launches {launches}")
    print(f"measurements (min, max): {json.dumps(meas)}")
    return launches, rate


def parity(base, requests, eval_data, dev):
    """CPU port (plain versions) vs CUDA port (kernels), f32, no TF32: the
    outputs, and the evaluator's metrics on them against the first two
    GT bodies of the first eval batch."""
    import torch

    from shapy_tpu_torch.eval.evaluator import build_evaluator
    from shapy_tpu_torch.flagship import REFERENCE_EVAL_CFG

    gt = eval_data["batches"][0]
    targets = {"gt_v_shaped": gt["gt_v_shaped"][:2],
               "gt_vertices": gt["gt_vertices"][:2],
               "gt_joints3d": gt["joints3d"][:2],
               "gt_joints14": gt["joints14"][:2],
               "joints14_valid": gt["joints14_valid"][:2],
               **{k: gt[f"{k}_gt"][:2] for k in
                  ("height", "chest", "waist", "hips", "mass")}}
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        images, affines = (t[:2] for t in requests)
        outs, metrics = [], []
        for device in ("cpu", dev):
            reg = copy.deepcopy(base).to(device).prepare_for_eval_()
            evaluator = build_evaluator(
                REFERENCE_EVAL_CFG, device=device,
                point_regressor=eval_data["p2p"],
                j14_regressor=eval_data["j14"])
            with torch.inference_mode():
                out = reg.apply_from_full_images(images.to(device),
                                                 affines.to(device), CROP)
                m = evaluator.compute_batch_metrics(
                    out, {k: v.to(device) for k, v in targets.items()})
            metrics.append({k: v.cpu() for k, v in m.items()})
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
    # Metrics: the vertices' 1e-4 m tolerance bounds the point errors'
    # difference; the measurements' rel 1e-4 bounds their errors' (1e-2
    # kg on ~100 kg).
    mcpu, mgpu = metrics
    check(set(mcpu) == set(mgpu) and len(mcpu) == 15, "metric keys")
    worst = {}
    for k in mcpu:
        tol = 1e-2 if k == "mass_error" else 1e-4
        both_nan = torch.isnan(mcpu[k]) & torch.isnan(mgpu[k])
        e = float(torch.where(both_nan, 0.0, (mcpu[k] - mgpu[k]).abs())
                  .max())
        worst[k] = e
        check(e <= tol, f"cross-device metric {k}: {e} > {tol}")
    check(bool(torch.isnan(mgpu["mpjpe14_root"]).any()),
          "the invalid mpjpe14 sample is not NaN")
    print("cross-device metrics (max |cpu - cuda|; m, mass kg): "
          + ", ".join(f"{k} {e:.2e}" for k, e in sorted(worst.items())))


def evaluate(regressor, eval_data, serve_rate):
    """Phase 5: the flagship through make_eval_fn -> Evaluator.run."""
    import torch

    from shapy_tpu_torch.eval.loop import make_eval_fn
    from shapy_tpu_torch.flagship import REFERENCE_EVAL_CFG

    eval_fn = make_eval_fn(regressor, {"hbw_synthetic": eval_data["batches"]},
                           REFERENCE_EVAL_CFG,
                           point_regressor=eval_data["p2p"],
                           j14_regressor=eval_data["j14"])
    eval_fn()  # warm-up
    torch.cuda.synchronize()
    seen = []
    reset_launches()
    start = time.perf_counter()
    results = eval_fn(on_batch=lambda *a: seen.append(a))["hbw_synthetic"]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = read_launches()

    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by the eval path")
    metric_names = [k for k in results if "/" not in k]
    check(len(metric_names) == 15, f"metrics {sorted(metric_names)}")
    check(all(math.isfinite(v) for v in results.values()),
          "non-finite accumulated metric")
    for name in metric_names:
        check(any(k.startswith(name + "/") for k in results),
              f"no group means for {name}")
    # The kernels' metrics against the plain versions' on the card.
    evaluator = eval_fn.evaluator
    worst = 0.0
    for outputs, targets, metrics in seen:
        plain = evaluator.compute_batch_metrics(outputs, targets, plain=True)
        check(set(plain) == set(metrics), "metric keys differ from plain")
        for k, v in metrics.items():
            both_nan = torch.isnan(v) & torch.isnan(plain[k])
            check(bool((torch.isnan(v) == torch.isnan(plain[k])).all()),
                  f"{k}: NaN pattern differs from plain")
            e = float(torch.where(both_nan, 0.0, (v - plain[k]).abs()).max())
            tol = 0.0 if k.endswith("_error") else METRIC_TOL
            check(e <= tol, f"{k}: kernel vs plain {e} > {tol}")
            worst = max(worst, e)
    rate = EVAL_BATCHES * B / elapsed
    show = {k: round(v, 5) for k, v in results.items() if "/" not in k}
    print(f"evaluate: {EVAL_BATCHES} batches of {B} in "
          f"{elapsed * 1e3:.1f} ms = {rate:.1f} images/s forward + metrics "
          f"(serve only: {serve_rate:.1f} images/s); launches {launches}; "
          f"kernel vs plain metrics max err {worst:.2e} (tol {METRIC_TOL})")
    print(f"eval means: {json.dumps(show)}")
    print(f"eval group means: {sum('/' in k for k in results)}")
    return launches, rate


def score(regressor, eval_data, dev):
    """Phase 6: the offline HBW scorer on a synthetic submission."""
    import torch

    from shapy_tpu_torch.cli.evaluate_hbw import evaluate_submission
    from shapy_tpu_torch.eval.metrics import (
        aligned_point_error_plain,
        point_regress_error_plain,
    )
    from shapy_tpu_torch.measure.measurements import measure_plain

    rng = np.random.default_rng(SEED + 6)
    model, meas, reg = (regressor.model, regressor.body_measurements,
                        eval_data["p2p"])
    betas = rng.normal(size=(SUBMISSION, model.num_betas)) * 1.5
    betas *= np.minimum(1.0, 6.0 / np.linalg.norm(betas, axis=1,
                                                  keepdims=True))
    fit_betas = betas + rng.normal(size=betas.shape) * 0.1
    with torch.inference_mode():
        gt, fits = (model.forward_shape(torch.tensor(
            b, dtype=torch.float32, device=dev))["v_shaped"].cpu().numpy()
            for b in (betas, fit_betas))
    fits = fits + rng.normal(size=fits.shape).astype(np.float32) * 0.002
    labels = [f"test/{i:03d}_synthetic/img.jpg" for i in range(SUBMISSION)]
    lookup = dict(zip(labels, gt))

    reset_launches()
    results = evaluate_submission(labels, fits, lookup.__getitem__,
                                  "smplx", reg, reg, meas, meas,
                                  batch_size=B, device=dev)
    launches = read_launches()
    for name in ("K1_measure", "K8a_point_regress", "K8b_align_error"):
        check(launches[name] > 0, f"{name} was not launched by the scorer")
    check(all(math.isfinite(v) for v in results.values()) and
          len(results) == 7, f"scorer results {results}")
    # The plain versions on the card, all 64 bodies at once.
    fit_t = torch.from_numpy(np.ascontiguousarray(fits, np.float32)).to(dev)
    gt_t = torch.from_numpy(gt).to(dev)
    with torch.inference_mode():
        m_fit, _ = measure_plain(fit_t, meas.faces, None, meas.anchors,
                                 meas.num_hull_directions, meas.density)
        m_gt, _ = measure_plain(gt_t, meas.faces, None, meas.anchors,
                                meas.num_hull_directions, meas.density)
        errs = (m_gt - m_fit).abs().mean(dim=0)
        plain = {
            "v2v_t": float(aligned_point_error_plain(
                fit_t, gt_t, "translation").mean()),
            "p2p_t": float(point_regress_error_plain(
                fit_t, gt_t, reg.indices, reg.weights, reg.indices,
                reg.weights).mean()),
            **{f"{k}_error": float(errs[i]) for i, k in enumerate(
                ("mass", "height", "chest", "waist", "hips"))}}
    # Tolerances: means of per-body errors summed in another order;
    # lengths 1e-5 m, mass 1e-3 kg (rel 1e-5 of ~100 kg).
    for k, v in plain.items():
        tol = 1e-3 if k == "mass_error" else 1e-5
        check(abs(results[k] - v) <= tol,
              f"scorer {k}: {results[k]} vs plain {v}")
    print(f"score: {SUBMISSION} bodies; V2V {results['v2v_t'] * 1e3:.2f} mm, "
          f"P2P-20k {results['p2p_t'] * 1e3:.2f} mm, "
          + ", ".join(f"{k} {results[k + '_error'] * 1e3:.2f} mm"
                      for k in ("chest", "waist", "hips", "height"))
          + f", mass {results['mass_error']:.3f} kg; launches {launches}; "
          f"max |kernel - plain| "
          f"{max(abs(results[k] - v) for k, v in plain.items()):.2e}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from shapy_tpu_torch.flagship import (
        build_flagship,
        spread_init_,
        synthetic_eval_data,
        synthetic_requests,
    )

    print(gpu_line())
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    def build(entry):
        name, kernel, _, _ = entry
        t = time.perf_counter()
        kernel.build()
        return name, time.perf_counter() - t, kernel.build_log

    with ThreadPoolExecutor(len(kernels())) as pool:
        for name, secs, log in pool.map(build, kernels()):
            regs = [ln.strip() for ln in log.splitlines()
                    if "registers" in ln]
            print(f"built {name} in {secs:.1f} s; "
                  f"{' | '.join(regs) or 'cached build'}")

    base = build_flagship(subdivisions=5, exact_counts=True, device="cpu",
                          seed=SEED)
    spread_init_(base, seed=SEED, beta_scale=0.25)
    regressor = copy.deepcopy(base).to(dev).prepare_for_eval_(torch.bfloat16)
    images, affines = synthetic_requests(B, IMAGE_H, IMAGE_W, CROP, SEED)
    requests = (torch.from_numpy(images).to(dev),
                torch.from_numpy(affines).to(dev))
    eval_data = synthetic_eval_data(regressor, EVAL_BATCHES, B, IMAGE_H,
                                    IMAGE_W, CROP, SEED + 5, P2P_POINTS)

    checked = check_kernels(regressor, requests, eval_data, dev)
    serve_launches, serve_rate = serve(regressor, requests)
    parity(base, tuple(t.cpu() for t in requests), eval_data, dev)
    eval_launches, _ = evaluate(regressor, eval_data, serve_rate)
    score(regressor, eval_data, dev)

    entries = []
    for name, _, source, replaces in kernels():
        c = checked[name]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            # this slice's main path: the eval phase (phase 5)
            "launches": eval_launches[name],
            "launches_serve": serve_launches[name],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"],
            # no single PyTorch call computes any of these functions
            "library_ms": None})
        check(all(math.isfinite(c[k]) for k in ("ms", "plain_ms",
                                                "bound_ms")), "timing")
    print(gpu_line())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
