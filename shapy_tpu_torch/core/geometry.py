"""Mesh / landmark geometry (port of ``shapy_tpu/core/geometry.py``)."""

from __future__ import annotations

import numpy as np
import torch


def blend_shapes(betas: torch.Tensor, shape_dirs: torch.Tensor
                 ) -> torch.Tensor:
    """betas (B, L), shape_dirs (V, 3, L) -> displacements (B, V, 3)."""
    V, K, L = shape_dirs.shape
    return (betas @ shape_dirs.reshape(V * K, L).T).reshape(-1, V, K)


def vertices2joints(J_regressor: torch.Tensor, vertices: torch.Tensor
                    ) -> torch.Tensor:
    """J_regressor (J, V), vertices (B, V, 3) -> joints (B, J, 3)."""
    return torch.matmul(J_regressor, vertices)


def vertices2landmarks(vertices: torch.Tensor, faces: torch.Tensor,
                       lmk_faces_idx: torch.Tensor,
                       lmk_bary_coords: torch.Tensor) -> torch.Tensor:
    """Barycentric landmarks.

    vertices (B, V, 3); faces (F, 3) int; lmk_faces_idx (L,) or (B, L);
    lmk_bary_coords (L, 3) or (B, L, 3) -> (B, L, 3).
    """
    B = vertices.shape[0]
    if lmk_faces_idx.dim() == 1:
        lmk_faces_idx = lmk_faces_idx.expand(B, -1)
    if lmk_bary_coords.dim() == 2:
        lmk_bary_coords = lmk_bary_coords.expand(B, -1, -1)
    lmk_faces = faces[lmk_faces_idx].long()  # (B, L, 3)
    batch = torch.arange(B, device=vertices.device)[:, None, None]
    lmk_vertices = vertices[batch, lmk_faces]  # (B, L, 3, 3)
    return torch.sum(lmk_vertices * lmk_bary_coords[..., None], dim=-2)


def gather_triangles(vertices: torch.Tensor, faces: torch.Tensor
                     ) -> torch.Tensor:
    """vertices (B, V, 3), faces (F, 3) int -> triangles (B, F, 3, 3)."""
    return vertices[:, faces.long()]


def signed_volume(triangles: torch.Tensor) -> torch.Tensor:
    """|volume| of a closed mesh, (B, F, 3, 3) -> (B,): the tetrahedra of
    the divergence theorem, in the JAX package's term order."""
    x, y, z = triangles[..., 0], triangles[..., 1], triangles[..., 2]
    det = (-x[..., 2] * y[..., 1] * z[..., 0]
           + x[..., 1] * y[..., 2] * z[..., 0]
           + x[..., 2] * y[..., 0] * z[..., 1]
           - x[..., 0] * y[..., 2] * z[..., 1]
           - x[..., 1] * y[..., 0] * z[..., 2]
           + x[..., 0] * y[..., 1] * z[..., 2])
    return torch.abs(torch.sum(det, dim=-1)) / 6.0


def face_barycentric_point(triangles: torch.Tensor, face_idx: int,
                           bary) -> torch.Tensor:
    """The point at barycentric ``bary`` (3,) of face ``face_idx`` of
    (B, F, 3, 3) triangles -> (B, 3)."""
    bc = torch.as_tensor(bary, dtype=triangles.dtype,
                         device=triangles.device)
    return torch.sum(triangles[:, face_idx] * bc.reshape(1, 3, 1), dim=1)


def edge_vectors(vertices: torch.Tensor, edges: torch.Tensor
                 ) -> torch.Tensor:
    """vertices (B, V, 3), edges (E, 2) int -> (B, E, 3) edge vectors."""
    edges = torch.as_tensor(edges, device=vertices.device).long()
    return vertices[:, edges[:, 1]] - vertices[:, edges[:, 0]]


def faces_to_edges(faces) -> np.ndarray:
    """Unique undirected edges (E, 2), each sorted, in lexicographic order,
    from faces (F, 3); host-side numpy."""
    f = np.asarray(faces)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    return np.unique(np.sort(e, axis=1), axis=0)
