"""Minimal PLY mesh export (numpy; copy of ``shapy_tpu/render/ply.py``,
whose package imports jax). Binary little-endian vertices and faces, the
format the reference's trimesh export writes for fitted meshes."""

from __future__ import annotations

import numpy as np


def save_ply(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
    faces = np.asarray(faces, np.int32).reshape(-1, 3)
    with open(path, "wb") as f:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(vertices)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        f.write(header.encode("ascii"))
        f.write(vertices.astype("<f4").tobytes())
        counts = np.full((len(faces), 1), 3, np.uint8)
        face_rec = np.concatenate(
            [counts.view(np.uint8),
             faces.astype("<i4").view(np.uint8).reshape(len(faces), -1)],
            axis=1,
        )
        f.write(face_rec.tobytes())
