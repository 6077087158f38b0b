"""Rotation representations (port of ``shapy_tpu/core/rotations.py``).

Conventions as in the JAX package: Rodrigues with the ``norm(aa + eps)``
angle, column-major Zhou-6D, and the reference's Euler-y extraction.
All functions take arbitrary leading batch dimensions.
"""

from __future__ import annotations

import torch


def aa_to_rotmat(aa: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3) via Rodrigues."""
    batch_shape = aa.shape[:-1]
    aa = aa.reshape(-1, 3)
    angle = torch.linalg.norm(aa + eps, dim=-1, keepdim=True)
    axis = aa / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = axis[:, 0], axis[:, 1], axis[:, 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack(
        [zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=-1
    ).reshape(-1, 3, 3)
    ident = torch.eye(3, dtype=aa.dtype, device=aa.device)
    rot = ident + sin * K + (1.0 - cos) * (K @ K)
    return rot.reshape(*batch_shape, 3, 3)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """Zhou-6D (..., 6) -> rotation matrices (..., 3, 3), column-major:
    ``x.reshape(3, 2)[:, 0]`` is the unnormalised first column."""
    batch_shape = x.shape[:-1]
    m = x.reshape(-1, 3, 2)
    a1 = m[:, :, 0]
    a2 = m[:, :, 1]
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True),
                          min=1e-12)
    dot = torch.sum(b1 * a2, dim=-1, keepdim=True)
    u2 = a2 - dot * b1
    b2 = u2 / torch.clamp(torch.linalg.norm(u2, dim=-1, keepdim=True),
                          min=1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    R = torch.stack([b1, b2, b3], dim=-1)
    return R.reshape(*batch_shape, 3, 3)


def rotmat_to_euler_y(R: torch.Tensor) -> torch.Tensor:
    """``atan2(-R[2,0], sqrt(R[0,0]^2 + R[1,0]^2))`` (dynamic contour)."""
    sy = torch.sqrt(R[..., 0, 0] * R[..., 0, 0] + R[..., 1, 0] * R[..., 1, 0])
    return torch.atan2(-R[..., 2, 0], sy)
