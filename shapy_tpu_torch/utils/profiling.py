"""Where the served flagship forward spends its time on the card (the
port's counterpart of ``shapy_tpu/utils/profiling.py``).

    python -m shapy_tpu_torch.utils.profiling [--batch 32] [--trace-dir D]

Builds the flagship as ``chip_smoke.py`` does (HRNet-W48, SMPL-X at the
real template's counts, bf16 backbone, random weights from a seed), then:

* times each phase of ``apply_from_full_images`` with CUDA events, idle
  gaps included (ingest K2, backbone, head + body model + camera +
  measurements), and a whole request with the host clock after a
  synchronise;
* traces 3 requests with ``torch.profiler`` (CPU + CUDA) and reports the
  device-busy time (sum of kernel times; one stream, so kernels do not
  overlap), the device's idle share of the wall time, and the kernels
  that take the most device time. ``--trace-dir`` also writes the Chrome
  trace there.

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
from shapy_tpu_torch.flagship import (
    build_flagship,
    spread_init_,
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

    with torch.inference_mode():
        for _ in range(3):
            request()
        torch.cuda.synchronize()
        crops = crop_normalize(images, affines, 256,
                               out_dtype=torch.bfloat16)
        feats = reg.compute_features(crops)

        def head():
            with full_f32_matmul():
                reg._apply_head(feats)

        phases = {
            "ingest_K2": _event_ms(lambda: crop_normalize(
                images, affines, 256, out_dtype=torch.bfloat16), iters),
            "backbone": _event_ms(lambda: reg.compute_features(crops), iters),
            "head_body_measure": _event_ms(head, iters),
            "request": _event_ms(request, iters),
        }
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            request()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                request()
            torch.cuda.synchronize()
            traced_wall_ms = (time.perf_counter() - t0) * 1e3 / 3

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / 3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:15]
    if trace_dir:
        Path(trace_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(trace_dir) / "flagship_trace.json"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return {
        "card": card,
        "batch": batch,
        "phase_ms_cuda_events": phases,
        "request_wall_ms": wall_ms,
        "images_per_s": batch / wall_ms * 1e3,
        "traced_request_wall_ms": traced_wall_ms,
        "device_busy_ms_per_request": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / traced_wall_ms),
        "cuda_kernel_launches_per_request": sum(e.count for e in events) / 3,
        "top_kernels_ms_per_request": [
            [e.key[:90], e.self_device_time_total / 1e3 / 3, e.count // 3]
            for e in top],
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
