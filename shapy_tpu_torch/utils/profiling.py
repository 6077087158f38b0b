"""Where the served flagship forward, its evaluation step and its train
step spend their time on the card (the port's counterpart of
``shapy_tpu/utils/profiling.py``).

    python -m shapy_tpu_torch.utils.profiling [--batch 32] [--trace-dir D]
    python -m shapy_tpu_torch.utils.profiling --train [--batch 48]
    python -m shapy_tpu_torch.utils.profiling --backbone resnet50 [--train]

Builds the flagship as ``chip_smoke.py`` does (HRNet-W48, or the ResNet
that ``--backbone`` names, SMPL-X at the real template's counts, bf16
backbone, random weights from a seed), then:

* times each phase of ``apply_from_full_images`` with CUDA events, idle
  gaps included (ingest K2, backbone, head + body model + camera +
  measurements), the evaluator's metrics on its outputs against
  synthetic GT (``flagship.synthetic_eval_data``, the reference's metric
  sets), and a whole request with the host clock after a synchronise;
* traces 3 requests, and 3 evaluation steps (request + metrics + the
  one device-to-host copy ``Evaluator.run`` makes per batch), with
  ``torch.profiler`` (CPU + CUDA) and reports for each the device-busy
  time (sum of kernel times; one stream, so kernels do not overlap), the
  device's idle share of the wall time, the kernels launched, the
  kernels that take the most device time, and the time and launches of
  each of the port's hand-written kernel sources (``conv.cu`` for
  K5-conv and ``hr_fuse.cu`` for K5-fuse, the backbone's, among them)
  with their share of the busy time; a source whose kernels launched in
  the traced steps but show in no trace event is an error.
  ``--trace-dir`` also writes the Chrome traces there.

With ``--train``, :func:`profile_train_step` does the same for one train
step of the flagship (bf16 backbone, dropout 0.5, the losses and the Adam
optimizer of ``configs/train_shapy.yaml`` that need no files, on
``flagship.synthetic_train_batches``): phase times of forward (train-mode
``apply`` + losses), backward and optimizer, the host-clock step time,
the traced device idle share (and, as an estimate, the untraced one:
traced device-busy time over the untraced step time), launches and top
kernels per step, and the peak device memory.

Prints one JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import time
from pathlib import Path

import torch

from shapy_tpu_torch.data.crop import crop_normalize
from shapy_tpu_torch.eval.evaluator import build_evaluator
from shapy_tpu_torch.flagship import (
    FLAGSHIP_OPTIM_CFG,
    FLAGSHIP_TRAIN_LOSS_CFG,
    REFERENCE_EVAL_CFG,
    build_flagship,
    spread_init_,
    synthetic_eval_data,
    synthetic_requests,
)
from shapy_tpu_torch.utils.cuda_kernels import CudaKernel
from shapy_tpu_torch.utils.device import full_f32_matmul, get_device

def _hand_kernel_sources() -> dict:
    """The source of each of the port's hand-written device functions, by
    the function's name, from every kernel made so far
    (:attr:`CudaKernel.registry`)."""
    return {fn: source for source, kernel in CudaKernel.registry.items()
            for fn in kernel.device_functions()}


def _hand_kernel(name: str, sources: dict) -> str | None:
    """The source of a trace's kernel ``name`` ("void (anonymous
    namespace)::conv_bf16_kernel<128, 8, 2, true>(...)"), or None."""
    for word in re.findall(r"\w+", name):
        if word in sources:
            return sources[word]
    return None


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


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


def _busy_ms(prof, ranges) -> float:
    """The time at least one CUDA kernel or copy of the trace runs (the
    union of their spans: K4's split forward launches its second and
    third passes as programmatic dependents, which start before the pass
    they wait for ends)."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(
            (e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in ranges):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy / 1e3


def _trace(fn, name: str, trace_dir: str | None, steps: int = 3) -> dict:
    """Device busy / idle share, launches and top kernels per step of
    ``fn`` from a ``torch.profiler`` trace of ``steps`` steps."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    launched = {k: c.launches for k, c in CudaKernel.registry.items()}
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    averages = prof.key_averages()
    # a record_function range (the optimizer's step) also shows on the
    # device, under its CPU event's name, spanning kernels counted anyway
    ranges = {e.key for e in averages
              if e.device_type == torch.autograd.DeviceType.CPU}
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.key not in ranges]
    busy_ms = _busy_ms(prof, ranges) / steps
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:15]
    sources, hand = _hand_kernel_sources(), {}
    for e in events:
        label = _hand_kernel(e.key, sources)
        if label is not None:
            ms, n = hand.get(label, (0.0, 0))
            hand[label] = (ms + e.self_device_time_total / 1e3 / steps,
                           n + e.count // steps)
    # every source launched in the traced steps must show in the trace
    missing = [k for k, c in CudaKernel.registry.items()
               if c.launches > launched.get(k, 0) and k not in hand]
    if missing:
        raise RuntimeError(f"{name}: no traced kernel of {missing}, which "
                           "launched")
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
        # per source of hand-written kernels (csrc/conv.cu is K5-conv,
        # hr_fuse.cu K5-fuse, ...): [ms, launches, share of the busy time]
        "hand_kernels": {k: [ms, n, ms / busy_ms if busy_ms else 0.0]
                         for k, (ms, n) in sorted(hand.items())},
    }


def profile_flagship(batch: int = 32, iters: int = 10,
                     trace_dir: str | None = None,
                     backbone: str = "hrnet") -> dict:
    dev = get_device("cuda")
    reg = build_flagship(subdivisions=5, exact_counts=True, device="cpu",
                         backbone=backbone)
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

    return {
        "card": _card(),
        "backbone": backbone,
        "batch": batch,
        "phase_ms_cuda_events": phases,
        "backbone_share_of_request": phases["backbone"] / phases["request"],
        "request_wall_ms": walls["request"],
        "images_per_s": batch / walls["request"] * 1e3,
        "eval_step_wall_ms": walls["eval_step"],
        "eval_images_per_s": batch / walls["eval_step"] * 1e3,
        "traced_per_step": traces,
    }


def profile_train_step(batch: int = 48, iters: int = 5,
                       trace_dir: str | None = None,
                       backbone: str = "hrnet") -> dict:
    """Phase times, idle share, launches, top kernels and peak memory of
    one train step of the flagship at ``batch``."""
    from shapy_tpu_torch.flagship import synthetic_train_batches
    from shapy_tpu_torch.train.losses import RegressorLosses
    from shapy_tpu_torch.train.step import init_train_state, make_train_step

    dev = get_device("cuda")
    reg = build_flagship(subdivisions=5, exact_counts=True, device="cpu",
                         backbone=backbone)
    spread_init_(reg, seed=0, beta_scale=0.25)
    reg = reg.to(dev).prepare_for_train_(torch.bfloat16)
    data = synthetic_train_batches(reg, 1, batch, 256, seed=9)[0]
    images = data.pop("images")
    step = make_train_step(reg, RegressorLosses(FLAGSHIP_TRAIN_LOSS_CFG),
                           init_train_state(reg, FLAGSHIP_OPTIM_CFG))
    gen = torch.Generator(device=dev).manual_seed(0)

    def full():
        return step(images, data, gen)

    for _ in range(2):
        full()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    phases = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    t0 = time.perf_counter()
    for _ in range(iters):
        events[0].record()
        loss = step.forward(images, data, gen)
        events[1].record()
        step.backward(loss)
        events[2].record()
        step.update()
        events[3].record()
        events[3].synchronize()
        for i, name in enumerate(phases):
            phases[name] += events[i].elapsed_time(events[i + 1]) / iters
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        full()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / iters
    traced = _trace(full, "train_step", trace_dir)
    return {
        "card": _card(),
        "backbone": backbone,
        "batch": batch,
        "phase_ms_cuda_events": phases,
        "phased_step_wall_ms": wall_ms,
        "step_wall_ms": step_ms,
        "images_per_s": batch / step_ms * 1e3,
        "peak_memory_gib": peak / 2 ** 30,
        "traced_per_step": traced,
        # an estimate, not a measurement: the traced device-busy time
        # over the untraced step's host-clock time
        "device_idle_share_untraced_estimate": max(
            0.0, 1.0 - traced["device_busy_ms"] / step_ms),
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=None,
                        help="32 for serving, 48 for --train")
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--train", action="store_true",
                        help="profile one train step instead")
    parser.add_argument("--trace-dir", default=None)
    parser.add_argument("--backbone", default="hrnet",
                        choices=("hrnet", "resnet18", "resnet50"),
                        help="HRNet-W48 (the flagship's) or a ResNet")
    args = parser.parse_args()
    if args.train:
        out = profile_train_step(args.batch or 48, args.iters, args.trace_dir,
                                 args.backbone)
    else:
        out = profile_flagship(args.batch or 32, args.iters, args.trace_dir,
                               args.backbone)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
