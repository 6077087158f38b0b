"""Rotation representations (port of ``shapy_tpu/core/rotations.py``).

Conventions as in the JAX package: Rodrigues with the ``norm(aa + eps)``
angle, column-major Zhou-6D, the reference's Euler-y extraction, the
trace-based inverse Rodrigues with its small-angle / near-pi clamping,
the SVD projection onto SO(3) and unit quaternions.
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


def rotmat_to_aa(R: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3): the angle from
    the trace (its cosine clipped to ``[-1 + eps, 1 - eps]``), the axis
    from the skew-symmetric part; below an angle of 1e-5 the unnormalised
    skew part stands in for the axis."""
    batch_shape = R.shape[:-2]
    R = R.reshape(-1, 3, 3)
    cos = 0.5 * (torch.diagonal(R, dim1=-2, dim2=-1).sum(-1) - 1.0)
    cos = torch.clamp(cos, -1.0 + eps, 1.0 - eps)
    theta = torch.arccos(cos)
    m21 = R[:, 2, 1] - R[:, 1, 2]
    m02 = R[:, 0, 2] - R[:, 2, 0]
    m10 = R[:, 1, 0] - R[:, 0, 1]
    denom = torch.sqrt(m21 * m21 + m02 * m02 + m10 * m10 + eps)
    small = torch.abs(theta) < 1e-5
    axis = torch.stack([torch.where(small, m, m / denom)
                        for m in (m21, m02, m10)], dim=-1)
    return (theta[:, None] * axis).reshape(*batch_shape, 3)


def rotmat_to_rot6d(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> column-major 6D (..., 6): the
    first two columns, flattened row by row (the inverse of
    :func:`rot6d_to_rotmat`'s layout)."""
    batch_shape = R.shape[:-2]
    return R[..., :, :2].reshape(*batch_shape, 6)


def svd_project_rotation(M: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) matrices onto SO(3): ``U diag(1, 1, det(U V^T))
    V^T`` from the SVD ``M = U S V^T``."""
    U, _, Vh = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vh)
    fix = torch.cat([torch.ones(M.shape[:-2] + (2,), dtype=M.dtype,
                                device=M.device),
                     det[..., None].to(M.dtype)], dim=-1)
    return (U * fix[..., None, :]) @ Vh


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternions (..., 4) [w, x, y, z], normalised here -> (..., 3, 3)."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                        min=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = (
        (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    )
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
