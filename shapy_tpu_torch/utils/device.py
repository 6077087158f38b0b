"""Device selection without a silent fallback, and f32 precision
control."""

from __future__ import annotations

import contextlib

import torch


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
