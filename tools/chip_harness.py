"""What the tools that time or check the port's kernels on one card share.

In turns (``in_turns``): a script runs once a tree a round, each run a
subprocess whose working directory is that tree (the script puts ``"."``
first on ``sys.path``, so the tree's own port and kernels are the ones
built and timed), in the order a b b a a b ... A run's last line of
standard output is a JSON object; each is printed with its tree, and the
last line gives each tree's median of every number.

In such a subprocess (this directory is on its ``PYTHONPATH``):
``trace(fn)`` takes the device kernels of ``PASSES`` calls of ``fn``
from a ``torch.profiler`` trace between spin kernels, taken again (at most
3 times) unless every source's kernels number a multiple of the calls;
``by_source`` groups them by the ``csrc`` file whose kernel each is.

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
        if (len(events) % passes == 0 and all(
                len(v) % passes == 0 for v in by_source(events).values())):
            return events
        print(f"trace dropped kernels: {len(events)} events", flush=True)
    raise RuntimeError("traces dropped kernels 3 times")


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


def in_turns(script: str, trees, rounds: int) -> int:
    """Runs ``script`` in each tree, ``rounds`` times, in turns; 1 if a
    run fails (its errors printed), else 0."""
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
        medians[tree] = {k: statistics.median(f[k] for f in flats)
                         for k in flats[0]}
    print(json.dumps({"median": medians}))
    return 0


# --- planted copies ----------------------------------------------------

def planted_copy(dst: Path, changes, smoke: bool = False) -> Path:
    """The port (and with ``smoke`` ``chip_smoke.py``) copied to ``dst``,
    each (path, text, replacement) of ``changes`` made in the copy."""
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(REPO / "shapy_tpu_torch", dst / "shapy_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if smoke:
        shutil.copy(REPO / "chip_smoke.py", dst / "chip_smoke.py")
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
