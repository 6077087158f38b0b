"""Plane-triangle slicing, plain PyTorch (port of
``shapy_tpu/ops/plane_slice.py``, structure-of-arrays forms).

Layout as in the JAX package: each coordinate is a ``(..., 3, F)`` plane
(vertex index, then face index). ``plane_slice_reference_soa`` is the
plain version of kernel K1's slice (``csrc/measure.cu``): the same
operations in the same order, so that the kernel, built without FMA
contraction, makes the same hit decisions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# The reference's two query triangles covering the [-1, 1]^2 plane quad,
# as (origin, direction) of their edges in the (a, b) plane.
_Q_EDGES = (
    (((-1.0, -1.0), (2.0, 0.0)), ((1.0, -1.0), (0.0, 2.0)),
     ((1.0, 1.0), (-2.0, -2.0))),
    (((-1.0, -1.0), (2.0, 2.0)), ((1.0, 1.0), (-2.0, 0.0)),
     ((-1.0, 1.0), (0.0, -2.0))),
)
_EPS = 1e-4  # the reference kernel's parallel reject


def plane_slice_reference_soa(
    s_coord: torch.Tensor,
    a_coord: torch.Tensor,
    b_coord: torch.Tensor,
    height: torch.Tensor,
    face_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference-semantics plane slice: one first-hit point per
    (quad triangle, body face) pair, face id 0 dropped.

    For each quad triangle: 3 Moller casts of its edges against the body
    triangle (``|det| >= 1e-4``), then 3 body-edge crossings tested
    against the quad triangle by half-planes; the first hit wins.

    s_coord (..., 3, F) the coordinate normal to the plane; a_coord,
    b_coord (..., 3, F) the in-plane coordinates; height (...,);
    face_ids (F,) the original face ids (for the face-0 rule) when the
    faces are a subset.

    Returns a_pts, b_pts, mask, each (..., 2F): quad triangle 0's points
    at [0, F), triangle 1's at [F, 2F); invalid points are 0.
    """
    h = height[..., None]
    ax0, ax1, ax2 = a_coord[..., 0, :], a_coord[..., 1, :], a_coord[..., 2, :]
    ay0, ay1, ay2 = s_coord[..., 0, :], s_coord[..., 1, :], s_coord[..., 2, :]
    az0, az1, az2 = b_coord[..., 0, :], b_coord[..., 1, :], b_coord[..., 2, :]
    e1x, e1y, e1z = ax1 - ax0, ay1 - ay0, az1 - az0
    e2x, e2y, e2z = ax2 - ax0, ay2 - ay0, az2 - az0

    def quad_edge_hit(ox, oz, dx, dz):
        px = -dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y
        det = e1x * px + e1y * py + e1z * pz
        ok = torch.abs(det) >= _EPS
        inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
        tx, ty, tz = ox - ax0, h - ay0, oz - az0
        u = (tx * px + ty * py + tz * pz) * inv
        ok = ok & (u >= 0.0) & (u <= 1.0)
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dz * qz) * inv
        ok = ok & (v >= 0.0) & (u + v <= 1.0)
        t = (e2x * qx + e2y * qy + e2z * qz) * inv
        ok = ok & (t >= 0.0) & (t <= 1.0)
        return ok, ox + t * dx, oz + t * dz

    def body_edge_hits(q_index):
        hits = []
        for (vax, vay, vaz, vbx, vby, vbz) in (
            (ax0, ay0, az0, ax1, ay1, az1),
            (ax1, ay1, az1, ax2, ay2, az2),
            (ax2, ay2, az2, ax0, ay0, az0),
        ):
            dy = vby - vay
            ok = torch.abs(4.0 * dy) >= _EPS
            t = (h - vay) / torch.where(ok, dy, torch.ones_like(dy))
            ok = ok & (t >= 0.0) & (t <= 1.0)
            cx = vax + t * (vbx - vax)
            cz = vaz + t * (vbz - vaz)
            if q_index == 0:  # corners (-1,-1) (1,-1) (1,1)
                ok = ok & (cx >= cz) & (cx - cz <= 2.0) & (cz >= -1.0) \
                    & (cx <= 1.0)
            else:  # corners (-1,-1) (1,1) (-1,1)
                ok = ok & (cx >= -1.0) & (cx <= 1.0) & (cz >= cx) \
                    & (cz <= 1.0)
            hits.append((ok, cx, cz))
        return hits

    out_a, out_b, out_m = [], [], []
    for q_index, edges in enumerate(_Q_EDGES):
        cands = [quad_edge_hit(o[0], o[1], d[0], d[1]) for (o, d) in edges]
        cands += body_edge_hits(q_index)
        pa = torch.zeros_like(ax0)
        pb = torch.zeros_like(ax0)
        found = torch.zeros(ax0.shape, dtype=torch.bool, device=ax0.device)
        for ok, ca, cb in cands:
            upd = ok & ~found
            pa = torch.where(upd, ca, pa)
            pb = torch.where(upd, cb, pb)
            found = found | upd
        out_a.append(pa)
        out_b.append(pb)
        out_m.append(found)

    F = ax0.shape[-1]
    ids = (torch.arange(F, device=ax0.device) if face_ids is None
           else face_ids)
    mask = torch.cat(out_m, dim=-1) & torch.cat([ids > 0] * 2)
    mz = mask.to(ax0.dtype)
    a_pts = torch.cat(out_a, dim=-1) * mz
    b_pts = torch.cat(out_b, dim=-1) * mz
    return a_pts, b_pts, mask


def plane_slice_soa(
    s_coord: torch.Tensor,
    a_coord: torch.Tensor,
    b_coord: torch.Tensor,
    height: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All-crossings slice ("exact" mode): both segment endpoints of every
    face the plane crosses at exactly two edges (vertex-on-plane is a
    miss). Same layout and returns as :func:`plane_slice_reference_soa`;
    face f's two points land at f and F + f."""
    h = height[..., None, None]
    s = s_coord - h

    def nxt(c):  # vertex v -> v+1 mod 3
        return torch.roll(c, -1, dims=-2)

    sa, sb = s, nxt(s)
    crossing = (sa * sb) < 0.0
    denom = sa - sb
    t = sa / torch.where(torch.abs(denom) > 1e-20, denom,
                         torch.full_like(denom, 1e-20))
    qa = a_coord + t * (nxt(a_coord) - a_coord)
    qb = b_coord + t * (nxt(b_coord) - b_coord)

    valid = torch.sum(crossing, dim=-2) == 2
    c0 = crossing[..., 0, :]
    c2 = crossing[..., 2, :]
    first_a = torch.where(c0, qa[..., 0, :], qa[..., 1, :])
    second_a = torch.where(c2, qa[..., 2, :], qa[..., 1, :])
    first_b = torch.where(c0, qb[..., 0, :], qb[..., 1, :])
    second_b = torch.where(c2, qb[..., 2, :], qb[..., 1, :])

    vz = valid.to(qa.dtype)
    a_pts = torch.cat([first_a * vz, second_a * vz], dim=-1)
    b_pts = torch.cat([first_b * vz, second_b * vz], dim=-1)
    mask = torch.cat([valid, valid], dim=-1)
    return a_pts, b_pts, mask
