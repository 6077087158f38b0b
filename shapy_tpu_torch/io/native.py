"""ctypes binding of the shared host C++ (``native/shapy_native.cpp``), the
port's own loader of ``native/libshapy_native.so`` (the JAX package's is
``shapy_tpu/io/native.py``, which the port does not import).

The library is built with ``make -C native`` on first use, as the JAX
package builds it: a no-op where it is fresh, one build at a time under
an exclusive lock. Only what the port calls is bound:
``rasterize_fragments``, the rasterizer's geometry pass, and
``shade_fragments``, its two-sided Blinn-Phong fragment shading. A build
or load that fails raises; nothing falls back to numpy here (the
rasterizer's numpy route is its own, asked for by name).
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
    i64 = ctypes.POINTER(ctypes.c_int64)
    lib.shade_fragments.argtypes = [
        i64, i32, f32, ctypes.c_int64, f32, i32, f32, f32, ctypes.c_int64,
        f32, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_int64, ctypes.c_int32, f32,
        ctypes.c_int64]
    lib.shade_fragments.restype = None
    _lib = lib
    return lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(ctypes.POINTER(kind))


def _threads(num_threads: int) -> int:
    return num_threads if num_threads > 0 else min(os.cpu_count() or 1, 8)


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
    lib.rasterize_fragments(
        _ptr(pts, ctypes.c_float), _ptr(z, ctypes.c_float),
        _ptr(faces, ctypes.c_int32), faces.shape[0], H, W,
        _ptr(face_id, ctypes.c_int32), _ptr(bary, ctypes.c_float),
        _ptr(depth, ctypes.c_float), _threads(num_threads))
    return face_id, bary, depth


def shade_fragments(pix: np.ndarray, fid: np.ndarray, bary: np.ndarray,
                    vnormals: np.ndarray, faces: np.ndarray, base: np.ndarray,
                    lights: np.ndarray, spec_color: np.ndarray,
                    shininess: float, ambient: float, fx: float, fy: float,
                    cx: float, cy: float, W: int, ortho: bool = False,
                    num_threads: int = 0) -> np.ndarray:
    """The threaded two-sided Blinn-Phong shading of covered fragments:
    pix (N,) flat pixel ids, fid (N,) face ids, bary (N, 3), vertex
    normals (V, 3), faces (F, 3), base (3,) or (N, 3) diffuse colour,
    lights (L, 4) (unit direction, intensity) -> rgb (N, 3) f32 in [0, 1].
    The view ray is the pinhole's through (fx, fy, cx, cy), or -z with
    ``ortho``; the numpy oracle is the rasterizer's ``_blinn_phong``."""
    lib = load()
    n = pix.shape[0]
    pix = np.ascontiguousarray(pix, np.int64)
    fid = np.ascontiguousarray(fid, np.int32)
    bary = np.ascontiguousarray(bary, np.float32)
    vnormals = np.ascontiguousarray(vnormals, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    base = np.ascontiguousarray(np.broadcast_to(base, (n, 3)), np.float32)
    lights = np.ascontiguousarray(lights, np.float32).reshape(-1, 4)
    spec_color = np.ascontiguousarray(spec_color, np.float32).reshape(3)
    rgb = np.empty((n, 3), np.float32)
    lib.shade_fragments(
        _ptr(pix, ctypes.c_int64), _ptr(fid, ctypes.c_int32),
        _ptr(bary, ctypes.c_float), n, _ptr(vnormals, ctypes.c_float),
        _ptr(faces, ctypes.c_int32), _ptr(base, ctypes.c_float),
        _ptr(lights, ctypes.c_float), lights.shape[0],
        _ptr(spec_color, ctypes.c_float), float(shininess), float(ambient),
        float(fx), float(fy), float(cx), float(cy), int(W), int(bool(ortho)),
        _ptr(rgb, ctypes.c_float), _threads(num_threads))
    return rgb
