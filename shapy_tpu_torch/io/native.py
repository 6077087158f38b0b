"""ctypes binding of the shared host C++ (``native/shapy_native.cpp``), the
port's own loader of ``native/libshapy_native.so`` (the JAX package's is
``shapy_tpu/io/native.py``, which the port does not import).

The library is built with ``make -C native`` on first use, as the JAX
package builds it: a no-op where it is fresh, one build at a time under
an exclusive lock. Only what the port calls is bound:
``rasterize_fragments``, the rasterizer's geometry pass. A build or load
that fails raises; nothing falls back to numpy here (the rasterizer's
numpy route is its own, asked for by name).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
LIB_PATH = NATIVE_DIR / "libshapy_native.so"

_lib = None


def load() -> ctypes.CDLL:
    """Build (``make``) and load the library; raises ``RuntimeError`` if
    either fails."""
    global _lib
    if _lib is not None:
        return _lib
    with open(NATIVE_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        proc = subprocess.run(["make", "-C", str(NATIVE_DIR)],
                              capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building {LIB_PATH} failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    try:
        lib = ctypes.CDLL(str(LIB_PATH))
    except OSError as exc:
        raise RuntimeError(f"loading {LIB_PATH} failed: {exc}") from exc
    f32, i32 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    lib.rasterize_fragments.argtypes = [
        f32, f32, i32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i32, f32, f32, ctypes.c_int64]
    lib.rasterize_fragments.restype = None
    _lib = lib
    return lib


def rasterize_fragments(pts: np.ndarray, z: np.ndarray, faces: np.ndarray,
                        H: int, W: int, num_threads: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The threaded z-buffer geometry pass: pts (V, 2) screen coords, z
    (V,) camera depths, faces (F, 3) -> dense (H W,) face ids (int32, -1
    where empty), (H W, 3) f32 barycentrics and (H W,) f32 depths (+inf
    where empty)."""
    lib = load()
    pts = np.ascontiguousarray(pts, np.float32)
    z = np.ascontiguousarray(z, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    face_id = np.empty(H * W, np.int32)
    bary = np.empty((H * W, 3), np.float32)
    depth = np.empty(H * W, np.float32)
    if num_threads <= 0:
        num_threads = min(os.cpu_count() or 1, 8)

    def ptr(a, kind):
        return a.ctypes.data_as(ctypes.POINTER(kind))

    lib.rasterize_fragments(
        ptr(pts, ctypes.c_float), ptr(z, ctypes.c_float),
        ptr(faces, ctypes.c_int32), faces.shape[0], H, W,
        ptr(face_id, ctypes.c_int32), ptr(bary, ctypes.c_float),
        ptr(depth, ctypes.c_float), num_threads)
    return face_id, bary, depth
