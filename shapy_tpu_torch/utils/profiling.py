"""Where the served flagship forward, and its evaluation step, spend
their time on the card (the port's counterpart of
``shapy_tpu/utils/profiling.py``).

    python -m shapy_tpu_torch.utils.profiling [--batch 32] [--trace-dir D]

Builds the flagship as ``chip_smoke.py`` does (HRNet-W48, SMPL-X at the
real template's counts, bf16 backbone, random weights from a seed), then:

* times each phase of ``apply_from_full_images`` with CUDA events, idle
  gaps included (ingest K2, backbone, head + body model + camera +
  measurements), the evaluator's metrics on its outputs against
  synthetic GT (``flagship.synthetic_eval_data``, the reference's metric
  sets), and a whole request with the host clock after a synchronise;
* traces 3 requests, and 3 evaluation steps (request + metrics + the
  one device-to-host copy ``Evaluator.run`` makes per batch), with
  ``torch.profiler`` (CPU + CUDA) and reports for each the device-busy
  time (sum of kernel times; one stream, so kernels do not overlap), the
  device's idle share of the wall time, the kernels launched, and the
  kernels that take the most device time. ``--trace-dir`` also writes
  the Chrome traces there.

Prints one JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

from shapy_tpu_torch.data.crop import crop_normalize
from shapy_tpu_torch.eval.evaluator import build_evaluator
from shapy_tpu_torch.flagship import (
    REFERENCE_EVAL_CFG,
    build_flagship,
    spread_init_,
    synthetic_eval_data,
    synthetic_requests,
)
from shapy_tpu_torch.utils.device import full_f32_matmul, get_device


def _event_ms(fn, iters: int) -> float:
    """Stream time per call between CUDA events, host-induced idle gaps
    included: what the phase costs the served request."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _trace(fn, name: str, trace_dir: str | None, steps: int = 3) -> dict:
    """Device busy / idle share, launches and top kernels per step of
    ``fn`` from a ``torch.profiler`` trace of ``steps`` steps."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:15]
    if trace_dir:
        Path(trace_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(trace_dir) / f"{name}_trace.json"))
    return {
        "traced_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "cuda_kernel_launches": sum(e.count for e in events) / steps,
        "top_kernels_ms": [
            [e.key[:90], e.self_device_time_total / 1e3 / steps,
             e.count // steps] for e in top],
    }


def profile_flagship(batch: int = 32, iters: int = 10,
                     trace_dir: str | None = None) -> dict:
    dev = get_device("cuda")
    reg = build_flagship(subdivisions=5, exact_counts=True, device="cpu")
    spread_init_(reg, seed=0, beta_scale=0.25)
    reg = reg.to(dev).prepare_for_eval_(torch.bfloat16)
    images, affines = synthetic_requests(batch, 360, 480, 256, seed=0)
    images = torch.from_numpy(images).to(dev)
    affines = torch.from_numpy(affines).to(dev)

    def request():
        return reg.apply_from_full_images(images, affines, 256)

    data = synthetic_eval_data(reg, 1, batch, 360, 480, 256, seed=5)
    gt = data["batches"][0]
    targets = {"gt_v_shaped": gt["gt_v_shaped"],
               "gt_vertices": gt["gt_vertices"],
               "gt_joints3d": gt["joints3d"], "gt_joints14": gt["joints14"],
               "joints14_valid": gt["joints14_valid"],
               **{k: gt[f"{k}_gt"] for k in
                  ("height", "chest", "waist", "hips", "mass")}}
    evaluator = build_evaluator(REFERENCE_EVAL_CFG, device=dev,
                                point_regressor=data["p2p"],
                                j14_regressor=data["j14"])

    def eval_step():
        metrics = evaluator.compute_batch_metrics(request(), targets)
        return torch.stack(list(metrics.values())).cpu()

    with torch.inference_mode():
        for _ in range(3):
            eval_step()
        torch.cuda.synchronize()
        crops = crop_normalize(images, affines, 256,
                               out_dtype=torch.bfloat16)
        feats = reg.compute_features(crops)
        outputs = request()

        def head():
            with full_f32_matmul():
                reg._apply_head(feats)

        phases = {
            "ingest_K2": _event_ms(lambda: crop_normalize(
                images, affines, 256, out_dtype=torch.bfloat16), iters),
            "backbone": _event_ms(lambda: reg.compute_features(crops), iters),
            "head_body_measure": _event_ms(head, iters),
            "metrics": _event_ms(lambda: evaluator.compute_batch_metrics(
                outputs, targets), iters),
            "request": _event_ms(request, iters),
        }
        walls = {}
        for name, fn in (("request", request), ("eval_step", eval_step)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            walls[name] = (time.perf_counter() - t0) * 1e3 / iters
        traces = {name: _trace(fn, name, trace_dir)
                  for name, fn in (("request", request),
                                   ("eval_step", eval_step))}

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return {
        "card": card,
        "batch": batch,
        "phase_ms_cuda_events": phases,
        "request_wall_ms": walls["request"],
        "images_per_s": batch / walls["request"] * 1e3,
        "eval_step_wall_ms": walls["eval_step"],
        "eval_images_per_s": batch / walls["eval_step"] * 1e3,
        "traced_per_step": traces,
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--trace-dir", default=None)
    args = parser.parse_args()
    print(json.dumps(profile_flagship(args.batch, args.iters,
                                      args.trace_dir), indent=1))


if __name__ == "__main__":
    main()
