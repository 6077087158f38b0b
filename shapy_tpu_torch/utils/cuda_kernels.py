"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exports plain C functions. At first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``shapy_tpu_torch/_build/`` (git-ignored), named by a hash of the source
and flags so that a stale build is never loaded, and bound with
``ctypes``. Nothing is built or imported when this module is imported.

Every exported function returns ``cudaGetLastError()`` after its launch;
:meth:`CudaKernel.launch` raises when that is not 0, because a refused
launch never runs and ``torch.cuda.synchronize()`` would not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # No contraction of a*b+c into FMA: K1's first-hit tests and K2's
    # validity edges then round exactly as their plain PyTorch versions.
    "--fmad=false",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

# ctypes argument kinds: "p" pointer or stream, "i" int, "f" float.
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


class CudaKernel:
    """One ``csrc/*.cu`` source, its exported C functions and a count of
    launches.

    ``functions`` maps each exported name to its argument kinds, e.g.
    ``{"skin_forward": "pppp iii p"}`` (spaces are ignored).
    ``launches`` is incremented by the wrapper where it launches the
    kernel, and nowhere else.
    """

    def __init__(self, source: str, functions: Dict[str, str]):
        self.source = source
        self.functions = {k: v.replace(" ", "") for k, v in functions.items()}
        self.launches = 0
        self.build_log = ""
        self._lib = None

    def _library_path(self) -> Path:
        text = (CSRC_DIR / self.source).read_bytes()
        digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
        stem = Path(self.source).stem
        return BUILD_DIR / f"lib{stem}-{digest.hexdigest()[:16]}.so"

    def build(self) -> ctypes.CDLL:
        """Compile (if needed) and load the library; idempotent."""
        if self._lib is not None:
            return self._lib
        path = self._library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / self.source)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {self.source}:\n"
                                   f"{self.build_log}")
            os.replace(tmp, path)  # atomic: readers never see half a file
        lib = ctypes.CDLL(str(path))
        for name, kinds in self.functions.items():
            fn = getattr(lib, name)
            fn.argtypes = [_CTYPES[k] for k in kinds]
            fn.restype = ctypes.c_int
        self._lib = lib
        return lib

    def launch(self, name: str, args: Sequence) -> None:
        """Call exported function ``name`` on PyTorch's current stream.

        Tensor arguments are passed by ``data_ptr()``; the caller keeps
        them alive for the duration of the call (the launch is
        asynchronous, but PyTorch's caching allocator does not reuse a
        block until the stream's later work is ordered after it)."""
        lib = self.build()
        call = []
        for a in args:
            call.append(a.data_ptr() if isinstance(a, torch.Tensor) else a)
        call.append(torch.cuda.current_stream().cuda_stream)
        err = getattr(lib, name)(*call)
        if err != 0:
            raise RuntimeError(f"{self.source}:{name} launch failed with "
                               f"cudaError {err}")


def check_cuda_input(t: torch.Tensor, name: str, dtype: torch.dtype,
                     shape: Sequence[int | None], device: torch.device
                     ) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` on
    ``device`` whose shape matches ``shape`` (None = any size), and it
    needs no gradient (the kernels are forward-only)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{name}: the CUDA kernel is forward-only; "
                           "call it under torch.no_grad()")
