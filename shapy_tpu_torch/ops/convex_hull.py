"""Support-function convex-hull perimeter, plain PyTorch (port of
``shapy_tpu/ops/convex_hull.py``).

Cauchy's formula: the perimeter of a convex body is the integral of its
support function over all directions, discretised with K midpoint
directions and antipodal pairing (K/2 projections give all K support
values through a max and a min). The points are centred on their masked
centroid first, so the support values are >= 0 and masked points,
collapsed to the centroid, can never win.

This is the plain version of kernel K1's hull (``csrc/measure.cu``).
Projections are elementwise f32 products, never a reduced-precision
matmul: TF32 would cost about a millimetre on a circumference.

``hull_perimeter_exact_np`` is the exact host-side check (scipy).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch


def hull_directions(num_directions: int, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin (K/2,) f32 of the first half-circle's midpoint angles
    ``(k + 0.5) * 2 pi / K``, shared by the plain version and the kernel."""
    if num_directions % 2:
        raise ValueError("num_directions must be even (antipodal pairing)")
    half = num_directions // 2
    theta = (torch.arange(half, dtype=torch.float32) + 0.5) * (
        2.0 * math.pi / num_directions)
    return torch.cos(theta).to(device), torch.sin(theta).to(device)


def hull_perimeter_support(points: torch.Tensor, mask: torch.Tensor,
                           num_directions: int = 256) -> torch.Tensor:
    """:func:`hull_perimeter_support_xz` of (..., N, 2) points."""
    return hull_perimeter_support_xz(points[..., 0], points[..., 1], mask,
                                     num_directions)


def hull_perimeter_support_xz(
    x: torch.Tensor,
    z: torch.Tensor,
    mask: torch.Tensor,
    num_directions: int = 256,
    centroid: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Perimeter of the convex hull of the masked points (x, z), each
    (..., N). Zero when fewer than 2 points are valid.

    ``centroid`` (cx, cz), each (...,), replaces the value of the masked
    centroid (its gradient still flows through the sums): with a
    kernel's centroid the projections round as the kernel's do, so that
    points whose projections tie within the sums' rounding split the
    gradient the same way on both sides."""
    cos, sin = hull_directions(num_directions, x.device)
    count = torch.clamp(torch.sum(mask, dim=-1, keepdim=True), min=1)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    cx = torch.sum(torch.where(mask, x, zero), dim=-1, keepdim=True) / count
    cz = torch.sum(torch.where(mask, z, zero), dim=-1, keepdim=True) / count
    if centroid is not None:  # x - x is exactly 0: the value is replaced
        cx = cx - cx.detach() + centroid[0][..., None].to(x.dtype)
        cz = cz - cz.detach() + centroid[1][..., None].to(x.dtype)
    xc = torch.where(mask, x - cx, zero)
    zc = torch.where(mask, z - cz, zero)

    proj = xc[..., None] * cos + zc[..., None] * sin  # (..., N, K/2)
    h_fwd = torch.clamp(torch.amax(proj, dim=-2), min=0.0)
    h_bwd = torch.clamp(-torch.amin(proj, dim=-2), min=0.0)
    perimeter = (torch.sum(h_fwd, dim=-1) + torch.sum(h_bwd, dim=-1)) * (
        2.0 * math.pi / num_directions)
    enough = torch.sum(mask, dim=-1) >= 2
    return torch.where(enough, perimeter, zero)


def hull_perimeter_exact_np(points: np.ndarray,
                            mask: Optional[np.ndarray] = None) -> float:
    """Exact perimeter of the convex hull of (N, 2) points (the masked
    ones), in f64 on the host with scipy: the sum of the hull's edge
    lengths. 0 with fewer than 3 points."""
    from scipy.spatial import ConvexHull

    pts = np.asarray(points, dtype=np.float64)
    if mask is not None:
        pts = pts[np.asarray(mask, dtype=bool)]
    if pts.shape[0] < 3:
        return 0.0
    seg = pts[ConvexHull(pts).simplices]  # (E, 2, 2)
    return float(np.linalg.norm(seg[:, 1] - seg[:, 0], axis=-1).sum())
