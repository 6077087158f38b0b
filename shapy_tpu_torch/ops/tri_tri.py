"""Mesh-mesh triangle intersection (port of ``shapy_tpu/ops/tri_tri.py``).

The original SHAPY used a CUDA extension (an LBVH and a Möller tri-tri
test) to slice bodies for measurements. The JAX package replaced it with
an all-pairs Möller interval test masked by an AABB test; this module
keeps that semantics:

  ``mesh_mesh_intersection(query, target, max_collisions)`` returns
  faces (B, Q * max_collisions) int32, each query's valid target ids in
  index order and then -1, and bcs (B, Q * max_collisions, 2, 3), the two
  segment endpoints as barycentric coordinates in the target triangle
  (zeros where unused).

:func:`mesh_mesh_intersection_plain` is the plain PyTorch version, the
CPU path and the card's oracle. It takes every 3-term dot and cross
product through ``utils/vec3.py``, in the order of kernel K6
(``csrc/tri_tri.cu``, built without FMA contraction), so that both take
every sign, overlap and box decision alike. On a CUDA
tensor :func:`mesh_mesh_intersection` launches K6 or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from shapy_tpu_torch.utils.cuda_kernels import (
    CudaKernel,
    check_cuda_input,
    check_no_grad,
)
from shapy_tpu_torch.utils.vec3 import cross3, dot3

TRI_KERNEL = CudaKernel("tri_tri.cu", {"tri_tri_forward": "ppppp iiii p"})

_EPS = 1e-9


def _plane(tri: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unnormalised plane (n, d) with n.x + d = 0 for tri (..., 3, 3)."""
    n = cross3(tri[..., 1, :] - tri[..., 0, :],
               tri[..., 2, :] - tri[..., 0, :])
    return n, -dot3(n, tri[..., 0, :])


def _segment_on_line(tri, dists, direction):
    """Intersection segment of triangles (..., 3, 3) with the other
    triangle's plane, given their vertices' signed distances (..., 3) to
    it, parametrised along ``direction`` (..., 3). Returns (lo, hi, p_lo,
    p_hi, valid) with lo <= hi."""
    sa, sb = dists, torch.roll(dists, -1, dims=-1)  # edges 0-1, 1-2, 2-0
    crossing = (sa * sb) < 0.0
    denom = sa - sb
    t = sa / torch.where(torch.abs(denom) > _EPS, denom, _EPS)
    pa, pb = tri, torch.roll(tri, -1, dims=-2)
    q = pa + t[..., None] * (pb - pa)

    valid = torch.sum(crossing, dim=-1) == 2
    first = torch.where(crossing[..., 0, None], q[..., 0, :], q[..., 1, :])
    second = torch.where(crossing[..., 2, None], q[..., 2, :], q[..., 1, :])
    t0, t1 = dot3(first, direction), dot3(second, direction)
    keep = (t0 <= t1)[..., None]
    return (torch.minimum(t0, t1), torch.maximum(t0, t1),
            torch.where(keep, first, second), torch.where(keep, second, first),
            valid)


def point_to_barycentric(tri: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Barycentric coordinates (..., 3) of points p (..., 3) in triangles
    (..., 3, 3)."""
    v0 = tri[..., 1, :] - tri[..., 0, :]
    v1 = tri[..., 2, :] - tri[..., 0, :]
    v2 = p - tri[..., 0, :]
    d00, d01, d11 = dot3(v0, v0), dot3(v0, v1), dot3(v1, v1)
    d20, d21 = dot3(v2, v0), dot3(v2, v1)
    denom = d00 * d11 - d01 * d01
    denom = torch.where(torch.abs(denom) > _EPS, denom, _EPS)
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    return torch.stack([1.0 - v - w, v, w], dim=-1)


def _pairs_intersect(query_tris: torch.Tensor, target_tris: torch.Tensor,
                     target_geom=None):
    """Query triangles (C, 3, 3) against all targets (F, 3, 3).

    ``target_geom``: the targets' (n, d, min, max), which do not depend on
    the query and are computed once per body by the caller.
    Returns (valid (C, F), endpoints (C, F, 2, 3))."""
    if target_geom is None:
        target_geom = (*_plane(target_tris), target_tris.amin(dim=-2),
                       target_tris.amax(dim=-2))
    nt, dt, tmin, tmax = target_geom
    nq, dq = _plane(query_tris)  # (C, 3), (C,)

    # signed distances of the targets' vertices to each query plane and of
    # each query's vertices to the target planes, (C, F, 3)
    dist_t = (dot3(nq[:, None, None, :], target_tris[None])
              + dq[:, None, None])
    dist_q = (dot3(nt[None, :, None, :], query_tris[:, None, :, :])
              + dt[None, :, None])
    direction = cross3(nq[:, None, :], nt[None])  # (C, F, 3)

    lo_t, hi_t, p_lo_t, p_hi_t, valid_t = _segment_on_line(
        target_tris[None], dist_t, direction)
    lo_q, hi_q, p_lo_q, p_hi_q, valid_q = _segment_on_line(
        query_tris[:, None], dist_q, direction)
    overlap = torch.minimum(hi_t, hi_q) > torch.maximum(lo_t, lo_q)

    qmin, qmax = query_tris.amin(dim=-2), query_tris.amax(dim=-2)
    boxes = torch.all((tmin[None] <= qmax[:, None])
                      & (tmax[None] >= qmin[:, None]), dim=-1)
    valid = valid_t & valid_q & overlap & boxes

    # the overlap's endpoints come from whichever segment bounds it
    p0 = torch.where((lo_t >= lo_q)[..., None], p_lo_t, p_lo_q)
    p1 = torch.where((hi_t <= hi_q)[..., None], p_hi_t, p_hi_q)
    return valid, torch.stack([p0, p1], dim=-2)


def mesh_mesh_intersection_plain(query_tris: torch.Tensor,
                                 target_tris: torch.Tensor,
                                 max_collisions: int = 256,
                                 query_chunk: int = 64
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K6: query_tris (B, Q, 3, 3), target_tris (B, F, 3,
    3) -> faces (B, Q * max_collisions) int32, bcs (B, Q * max_collisions,
    2, 3). Queries go through in chunks of ``query_chunk``, each a (chunk,
    F) pair tile."""
    B, Q = query_tris.shape[:2]
    F = target_tris.shape[1]
    M = max_collisions
    k = min(M, F)
    faces = torch.full((B, Q, M), -1, dtype=torch.int32,
                       device=query_tris.device)
    bcs = query_tris.new_zeros((B, Q, M, 2, 3))
    for b in range(B):
        t_tris = target_tris[b]
        geom = (*_plane(t_tris), t_tris.amin(dim=-2), t_tris.amax(dim=-2))
        for s in range(0, Q, max(1, query_chunk)):
            q_tris = query_tris[b, s:s + query_chunk]
            valid, endpoints = _pairs_intersect(q_tris, t_tris, geom)
            # The first k valid targets in index order (jax.lax.top_k on
            # the 0/1 score puts tied elements lower index first): a
            # stable sort of the misses to the back.
            idx = torch.sort((~valid).to(torch.uint8), dim=-1,
                             stable=True).indices[:, :k]
            sel_valid = torch.gather(valid, 1, idx)
            sel_pts = endpoints[torch.arange(len(idx), device=idx.device
                                             )[:, None], idx]  # (C, k, 2, 3)
            sel_bcs = point_to_barycentric(t_tris[idx][:, :, None], sel_pts)
            faces[b, s:s + query_chunk, :k] = torch.where(
                sel_valid, idx, -1).to(torch.int32)
            bcs[b, s:s + query_chunk, :k] = torch.where(
                sel_valid[..., None, None], sel_bcs, 0.0)
    return faces.reshape(B, Q * M), bcs.reshape(B, Q * M, 2, 3)


def mesh_mesh_intersection(query_tris: torch.Tensor,
                           target_tris: torch.Tensor,
                           max_collisions: int = 256,
                           query_chunk: int = 64
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched intersection, reference-compatible outputs: the plain
    version for CPU tensors (``query_chunk`` sets its tile), kernel K6 for
    CUDA tensors (forward only; contiguous f32 triangles)."""
    if query_tris.device.type == "cpu":
        return mesh_mesh_intersection_plain(query_tris, target_tris,
                                            max_collisions, query_chunk)
    if query_tris.device.type != "cuda":
        raise ValueError(f"mesh_mesh_intersection: unsupported device "
                         f"{query_tris.device}")
    if max_collisions < 1:
        raise ValueError(f"max_collisions {max_collisions} < 1")
    B, Q = query_tris.shape[:2]
    F = target_tris.shape[1]
    M = max_collisions
    dev = query_tris.device
    check_cuda_input(query_tris, "query_tris", torch.float32, (B, Q, 3, 3),
                     dev)
    check_cuda_input(target_tris, "target_tris", torch.float32, (B, F, 3, 3),
                     dev)
    check_no_grad(query_tris, "query_tris")
    check_no_grad(target_tris, "target_tris")
    faces = torch.empty((B, Q * M), dtype=torch.int32, device=dev)
    bcs = torch.empty((B, Q * M, 2, 3), dtype=torch.float32, device=dev)
    if B == 0 or Q == 0:
        return faces, bcs
    # the targets' planes and boxes, (B, 10, F): n, d, min, max
    geom = torch.empty((B, 10, max(F, 1)), dtype=torch.float32, device=dev)
    TRI_KERNEL.launch("tri_tri_forward", [
        query_tris, target_tris, geom, faces, bcs, B, Q, F, M])
    return faces, bcs


class MeshMeshIntersection:
    """API-parity wrapper (reference ``mesh_mesh_intersection.py:36-62``)."""

    def __init__(self, max_collisions: int = 256, query_chunk: int = 64):
        self.max_collisions = max_collisions
        self.query_chunk = query_chunk

    def __call__(self, query_tris: torch.Tensor, target_tris: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        return mesh_mesh_intersection(query_tris, target_tris,
                                      self.max_collisions, self.query_chunk)
