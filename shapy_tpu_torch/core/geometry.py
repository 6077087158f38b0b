"""Mesh / landmark geometry (port of ``shapy_tpu/core/geometry.py``)."""

from __future__ import annotations

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
