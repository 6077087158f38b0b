"""What the tools that time or check the port's kernels on one card share.

In turns (``in_turns``): a script runs once a tree a round, each run a
subprocess whose working directory is that tree (the script puts ``"."``
first on ``sys.path``, so the tree's own port and kernels are the ones
built and timed), in the order a b b a a b ... A run's last line of
standard output is a JSON object; each is printed with its tree, and the
last line gives each tree's median of every number. ``Tee`` copies a
tool's standard output to its ``--out`` file.

In such a subprocess (this directory is on its ``PYTHONPATH``):
``trace(fn)`` takes the device kernels of ``PASSES`` calls of ``fn``
from a ``torch.profiler`` trace between spin kernels, taken again (at most
3 times) unless it holds kernels and every source's kernels number a
multiple of the calls;
``by_source`` groups them by the ``csrc`` file whose kernel each is,
``busy_ms`` gives the time at least one of them runs;
``grids(fn)`` gives each kernel's grid and block, and ``empty_ms`` the
device time of an empty kernel on such a grid (a launch's floor);
``body_model`` builds the flagship's SMPL-X body model and anchors alone,
``flagship``, ``eval_step`` and ``train_step`` the flagship and its
eval step at batch 32 and HRNet train step at 48, ``resnet_request`` and
``resnet_train_step`` the ResNet flagship's served request and train
step as phase 11 of ``chip_smoke.py`` builds them, and ``step_numbers``
times a step (wall, busy, idle, kernels).

Planted copies (``planted_copy``, ``run_faults``): the port (and
``chip_smoke.py``) copied under ``shapy_tpu_torch/_build/`` (a directory
that git ignores; the tree itself is never edited) with some of its text
replaced, each replaced text found exactly once.
"""

from __future__ import annotations

import collections
import json
import os
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

TOOLS = Path(__file__).resolve().parent
REPO = TOOLS.parent
BUILD = REPO / "shapy_tpu_torch" / "_build"
PASSES = 5


# --- in the subprocess: device time from profiler traces ---------------

def pad():
    """Spin kernels that keep the traced calls off the trace's edges."""
    import torch

    for _ in range(8):
        torch.cuda._sleep(1000)


_PAD_NAMES: set = set()


def _pad_names() -> set:
    import torch

    if not _PAD_NAMES:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            pad()
            torch.cuda.synchronize()
        _PAD_NAMES.update(e.name for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA)
    return _PAD_NAMES


def by_source(events) -> dict:
    """{``csrc`` file, or the kernel's own name for a library kernel:
    [ms, ...] in launch order} of ``trace``'s events."""
    from shapy_tpu_torch.utils import profiling

    sources = profiling._hand_kernel_sources()
    by = collections.defaultdict(list)
    for start, stop, name in events:
        by[profiling._hand_kernel(name, sources)].append((stop - start) / 1e3)
    return by


def busy_ms(events, passes: int = PASSES) -> float:
    """The time at least one of ``trace``'s events runs (the union of
    their spans: a programmatic dependent starts before the kernel it
    waits for ends), per call, in ms."""
    busy, end = 0.0, float("-inf")
    for start, stop, _ in events:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy / 1e3 / passes


def trace(fn, passes: int = PASSES) -> list:
    """(start us, end us, name) of each device kernel of ``passes`` calls
    of ``fn``, in launch order, the spin kernels left out."""
    import torch

    skip = _pad_names()
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            pad()
            for _ in range(passes):
                fn()
            pad()
            torch.cuda.synchronize()
        events = sorted(
            (e.time_range.start, e.time_range.end, e.name)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in skip)
        if (events and len(events) % passes == 0 and all(
                len(v) % passes == 0 for v in by_source(events).values())):
            return events
        print(f"trace dropped kernels: {len(events)} events", flush=True)
    raise RuntimeError("traces dropped kernels 3 times")


def grids(fn) -> list:
    """(name, grid, block) of each device kernel of one call of ``fn``, in
    launch order, from a ``torch.profiler`` trace's chrome export (between
    spin kernels, as ``trace``)."""
    import tempfile

    import torch

    skip = _pad_names()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        pad()
        fn()
        pad()
        torch.cuda.synchronize()
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], tuple(e["args"]["grid"]), tuple(e["args"]["block"]))
            for e in sorted(events, key=lambda e: e.get("ts", 0))
            if e.get("cat") == "kernel" and "grid" in e.get("args", {})
            and e["name"] not in skip]


_EMPTY = """extern "C" __global__ void empty_kernel() {}
extern "C" int empty_launch(int gx, int gy, int gz, int bx, int by, int bz,
                            void* stream) {
  empty_kernel<<<dim3(gx, gy, gz), dim3(bx, by, bz), 0,
                 (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def empty_ms(grid, block) -> float:
    """The device time of an empty kernel launched on ``grid`` x ``block``
    (a launch's floor), traced as ``trace`` traces: the mean of
    ``PASSES`` launches."""
    import ctypes

    import torch

    from shapy_tpu_torch.utils.cuda_kernels import NVCC_FLAGS, _nvcc

    lib_path = BUILD / "libempty_launch.so"
    if not lib_path.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        src = BUILD / "empty_launch.cu"
        src.write_text(_EMPTY)
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib_path), str(src)],
                       check=True, capture_output=True)
    launch = ctypes.CDLL(str(lib_path)).empty_launch
    launch.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]

    def fn():
        stream = torch.cuda.current_stream().cuda_stream
        if launch(*grid, *block, stream):
            raise RuntimeError(f"empty kernel on {grid} x {block} refused")

    return sum(stop - start for start, stop, _ in trace(fn)) / 1e3 / PASSES


def step_numbers(fn, iters: int, *sources: str) -> dict:
    """A step's host-clock wall over ``iters`` calls after a synchronise
    and, from a ``torch.profiler`` trace of 3 (``utils/profiling._trace``),
    its device busy time, idle share, kernels and each of ``sources``'
    time (``<stem>_ms``: ``skinning_ms`` for ``skinning.cu``)."""
    import time

    import torch

    from shapy_tpu_torch.utils import profiling

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / iters
    traced = profiling._trace(fn, "step", None)
    return {"wall_ms": wall, "busy_ms": traced["device_busy_ms"],
            "idle_share_traced": traced["device_idle_share"],
            "kernels": traced["cuda_kernel_launches"],
            **{f"{Path(src).stem}_ms": traced["hand_kernels"].get(
                src, [0.0])[0] for src in sources}}


def body_model(dev):
    """The flagship's body model (synthetic SMPL-X at the real counts, 10475
    vertices and 20908 faces) on ``dev`` and its measurement anchors, as
    ``build_flagship`` makes them."""
    from shapy_tpu_torch.measure.measurements import MeasurementAnchors
    from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
    from shapy_tpu_torch.models.body.model import SMPLX

    model = SMPLX(make_synthetic_model_data("smplx", subdivisions=5,
                                            exact_counts=True))
    anchors = MeasurementAnchors.synthetic(model.faces,
                                           model.v_template.numpy())
    return model.to(dev), anchors


def flagship():
    """The flagship on the CPU as ``utils/profiling.py`` builds it
    (HRNet-W48, synthetic SMPL-X at the real counts, random weights from
    seed 0)."""
    from shapy_tpu_torch.flagship import build_flagship, spread_init_

    reg = build_flagship(subdivisions=5, exact_counts=True, device="cpu")
    return spread_init_(reg, seed=0, beta_scale=0.25)


def eval_step(reg, dev):
    """The flagship's eval step at batch 32, ``reg`` moved to ``dev`` with
    a bf16 backbone: the served request, the metrics against synthetic GT
    and the one device-to-host copy."""
    import torch

    from shapy_tpu_torch.eval.evaluator import build_evaluator
    from shapy_tpu_torch.flagship import (REFERENCE_EVAL_CFG,
                                          synthetic_eval_data,
                                          synthetic_requests)

    ev = reg.to(dev).prepare_for_eval_(torch.bfloat16)
    images, affines = synthetic_requests(32, 360, 480, 256, seed=0)
    images = torch.from_numpy(images).to(dev)
    affines = torch.from_numpy(affines).to(dev)
    data = synthetic_eval_data(ev, 1, 32, 360, 480, 256, seed=5)
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

    def step():
        m = evaluator.compute_batch_metrics(
            ev.apply_from_full_images(images, affines, 256), targets)
        return torch.stack(list(m.values())).cpu()

    return step


def train_step(dev):
    """One HRNet train step at batch 48 as ``utils/profiling.py --train``
    builds it (bf16 backbone, the flagship's losses and optimizer)."""
    import torch

    from shapy_tpu_torch.flagship import (FLAGSHIP_OPTIM_CFG,
                                          FLAGSHIP_TRAIN_LOSS_CFG,
                                          synthetic_train_batches)
    from shapy_tpu_torch.train.losses import RegressorLosses
    from shapy_tpu_torch.train.step import init_train_state, make_train_step

    tr = flagship().to(dev).prepare_for_train_(torch.bfloat16)
    batch = synthetic_train_batches(tr, 1, 48, 256, seed=9)[0]
    images = batch.pop("images")
    step = make_train_step(tr, RegressorLosses(FLAGSHIP_TRAIN_LOSS_CFG),
                           init_train_state(tr, FLAGSHIP_OPTIM_CFG))
    gen = torch.Generator(device=dev).manual_seed(0)
    return lambda: step(images, batch, gen)


def resnet_request(depth: int, batch: int, dev):
    """A served request of the flagship on ResNet-``depth`` at ``batch``,
    as ``chip_smoke.py``'s phase 11 builds it (``resnet_base``: seeded
    random weights, BN folded, bf16 backbone; uint8 480x360 images and
    their crop affines in, measurements out)."""
    import torch

    from shapy_tpu_torch.flagship import synthetic_requests

    cs = smoke()
    reg = cs.resnet_base(depth).to(dev).prepare_for_eval_(torch.bfloat16)
    images, affines = synthetic_requests(batch, cs.IMAGE_H, cs.IMAGE_W,
                                         cs.CROP, cs.SEED)
    images = torch.from_numpy(images).to(dev)
    affines = torch.from_numpy(affines).to(dev)

    def request():
        with torch.inference_mode():
            return reg.apply_from_full_images(images, affines, cs.CROP)

    return request


def resnet_train_step(depth: int, dev):
    """One train step of the flagship on ResNet-``depth`` at batch 48, as
    phase 11 trains it (bf16 backbone, the flagship's losses and
    optimizer)."""
    import torch

    from shapy_tpu_torch.flagship import (FLAGSHIP_OPTIM_CFG,
                                          FLAGSHIP_TRAIN_LOSS_CFG,
                                          synthetic_train_batches)
    from shapy_tpu_torch.train.losses import RegressorLosses
    from shapy_tpu_torch.train.step import init_train_state, make_train_step

    cs = smoke()
    tr = cs.resnet_base(depth).to(dev).prepare_for_train_(torch.bfloat16)
    batch = synthetic_train_batches(tr, 1, cs.TRAIN_B, cs.CROP,
                                    seed=cs.SEED + 9)[0]
    images = batch.pop("images")
    step = make_train_step(tr, RegressorLosses(FLAGSHIP_TRAIN_LOSS_CFG),
                           init_train_state(tr, FLAGSHIP_OPTIM_CFG))
    gen = torch.Generator(device=dev).manual_seed(0)
    return lambda: step(images, batch, gen)


def smoke():
    """This repository's ``chip_smoke.py`` as a module (its constants and
    checks; a subprocess's own tree may be another's)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("harness_chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


# --- on the host: runs in turns ----------------------------------------

def _flat(row: dict, prefix: str = "") -> dict:
    flat = {}
    for k, v in row.items():
        if isinstance(v, dict):
            flat.update(_flat(v, f"{prefix}{k}."))
        elif isinstance(v, (int, float)):
            flat[f"{prefix}{k}"] = v
    return flat


def run_script(script: str, cwd: Path, args=(), timeout: int = 900):
    """``script`` in a subprocess in ``cwd``, with this directory on its
    ``PYTHONPATH``."""
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(TOOLS)] + ([path] if path else [])))
    return subprocess.run([sys.executable, "-c", script, *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


class Tee:
    """Standard output, copied to a file (a tool's ``--out``)."""

    def __init__(self, path: Path):
        self.file = path.open("w")

    def write(self, text: str) -> int:
        sys.__stdout__.write(text)
        return self.file.write(text)

    def flush(self) -> None:
        sys.__stdout__.flush()
        self.file.flush()


def in_turns(script: str, trees, rounds: int) -> int:
    """Runs ``script`` in each tree, ``rounds`` times, in turns; 1 if a
    run fails (its errors printed), else 0. A median is over the runs that
    have the number."""
    runs = {tree: [] for tree in trees}
    order = []
    for i in range(rounds):
        order += trees if i % 2 == 0 else trees[::-1]
    for tree in order:
        proc = run_script(script, Path(tree).resolve())
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
        keys = dict.fromkeys(k for f in flats for k in f)
        medians[tree] = {k: statistics.median(f[k] for f in flats if k in f)
                         for k in keys}
    print(json.dumps({"median": medians}))
    return 0


# --- planted copies ----------------------------------------------------

def planted_copy(dst: Path, changes, smoke: bool = False,
                 root: Path = REPO) -> Path:
    """The port of ``root`` (and with ``smoke`` its ``chip_smoke.py``)
    copied to ``dst``, each (path, text, replacement) of ``changes`` made
    in the copy."""
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(root / "shapy_tpu_torch", dst / "shapy_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if smoke:
        shutil.copy(root / "chip_smoke.py", dst / "chip_smoke.py")
    for path, old, new in changes:
        text = (dst / path).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{dst.name}: {old[:60]!r} is not once in "
                               f"{path}")
        (dst / path).write_text(text.replace(old, new))
    return dst


def run_faults(out: Path, faults: dict, script: str, names,
               caught_by: dict | None = None, workers: int = 4) -> int:
    """Runs ``script`` in a planted copy of each fault of ``names`` (all
    of ``faults`` where none is named), ``workers`` at a time. The script
    exits 0 where its checks pass and prints a line ``caught: <check>:
    ...`` for each that fails. The unplanted copy (no changes) must pass
    and every planted one fail, in the check ``caught_by`` names for it
    where it names one. Each copy's output goes to ``out/<fault>.log``;
    the last line is a JSON summary. 0 if every copy did as it must."""
    out.mkdir(parents=True, exist_ok=True)
    caught_by = caught_by or {}

    def run(fault: str) -> dict:
        dst = planted_copy(out / fault, faults[fault], smoke=True)
        try:
            proc = run_script(script, dst)
            rc, log = proc.returncode, proc.stdout + proc.stderr
        except subprocess.TimeoutExpired as e:
            rc, log = 124, "".join(
                s.decode(errors="replace") if isinstance(s, bytes) else s
                for s in (e.stdout or "", e.stderr or "", "\ntimed out"))
        (out / f"{fault}.log").write_text(log)
        shutil.rmtree(dst)
        caught = [ln for ln in log.splitlines() if ln.startswith("caught:")]
        print(f"{fault}: rc {rc}; "
              f"{' | '.join(c[:300] for c in caught) if caught else log[-600:]}",
              flush=True)
        passed = rc == 0
        named = all(c.startswith("caught: " + caught_by.get(fault, ""))
                    for c in caught)
        return {"rc": rc, "passed": passed,
                "caught": len(caught),
                "as_expected": passed if not faults[fault]
                else bool(caught) and named}

    names = list(names) or list(faults)
    with ThreadPoolExecutor(workers) as pool:
        summary = dict(zip(names, pool.map(run, names)))
    print(json.dumps(summary))
    return 0 if all(v["as_expected"] for v in summary.values()) else 1
