"""Device selection without a silent fallback, f32 precision control,
and the CLIs' start-up guards (the open-file limit, exit code 3 when the
card is asked for and absent)."""

from __future__ import annotations

import contextlib
import sys

import torch

# A scheduler resubmits a run that exits with this code: the accelerator
# was asked for and is absent or fails to initialise (an infrastructure
# failure, not a fault of the job).
DEVICE_FAILURE_EXIT_CODE = 3


def get_device(name: str | torch.device = "cuda") -> torch.device:
    """The device asked for. Raises when CUDA is asked for and absent:
    a run meant for the card never quietly measures the CPU instead."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matmuls in full precision, no TF32, inside the block (the
    head, LBS and measurements: a TF32 product costs about a millimetre on
    a circumference). Restores the caller's setting on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def raise_open_file_limit() -> None:
    """Raise RLIMIT_NOFILE's soft limit to the hard limit: the data
    loaders hold many image files open. A no-op without the ``resource``
    module or without permission."""
    try:
        import resource

        _, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    except (ImportError, ValueError, OSError):
        pass


def exit_on_device_failure(device: str | torch.device = "cuda") -> None:
    """``sys.exit(3)`` when ``device`` is the card and CUDA is absent or
    fails to initialise. Exit code 3 never means carrying on on the CPU;
    a CPU ``device`` passes."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    try:
        ok = torch.cuda.is_available()
        if ok:
            torch.cuda.init()
    except RuntimeError as exc:
        print(f"CUDA initialisation failed: {exc}", file=sys.stderr)
        sys.exit(DEVICE_FAILURE_EXIT_CODE)
    if not ok:
        print(f"device {device} requested but CUDA is not available",
              file=sys.stderr)
        sys.exit(DEVICE_FAILURE_EXIT_CODE)
