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

K6 culls with a spatial hierarchy (:func:`tri_tri_plan`): the targets in
Morton order, clusters of 32 with their union boxes, the query's hits in
a list sorted by id, an index-order sweep for a query whose hits overflow
its list. :func:`mesh_mesh_intersection_replay` repeats that design in
plain PyTorch; the tests and ``chip_smoke.py`` hold the kernel to it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from shapy_tpu_torch.utils.cuda_kernels import (
    CARD_SMS,
    CudaKernel,
    check_cuda_input,
    check_no_grad,
)
from shapy_tpu_torch.utils.vec3 import cross3, dot3

TRI_KERNEL = CudaKernel("tri_tri.cu",
                        {"tri_tri_forward": "pppppppp iiiiii p"})

_EPS = 1e-9
# csrc/tri_tri.cu: targets a cluster (and clusters a supercluster), targets
# a prologue block, Morton bits an axis, the bounds of a query's hit list,
# warps a query block, and query blocks an SM; below as many queries as the
# card holds blocks at once, a block's warps share each query.
_K6_CLUSTER = 32
_K6_BLOCK = 256
_K6_CELL_BITS = 5
_K6_LIST_MIN, _K6_LIST_MAX = 32, 1024
_K6_WARPS = 8
_K6_BLOCKS_PER_SM = 3
_K6_TEAM_BELOW = _K6_BLOCKS_PER_SM * CARD_SMS
# Queries whose hits overflowed their list, counted by K6 on each device.
_OVERFLOWED: Dict[torch.device, torch.Tensor] = {}


class TriTriPlan(NamedTuple):
    """K6's split, from the shapes alone: ``clusters`` cluster boxes a
    body (ceil(F / 32); a supercluster is 32 of them), ``list_size`` hit
    ids a query keeps in shared memory (a power of 2), ``team`` warps a
    query (1, or 8 when there are few queries)."""

    clusters: int
    list_size: int
    team: int


def tri_tri_plan(B: int, Q: int, F: int, M: int) -> TriTriPlan:
    """K6's plan for B bodies of Q queries against F targets with M
    slots: a hit list of the power of 2 at or above min(M, F), between 32
    and 1024 (256 for the body pairs, 1024 for the plane quads; a query
    with more hits sweeps instead); a warp a query, or a block of 8 warps
    a query below 396 queries in all (3 blocks an SM of ``CARD_SMS``; the
    plane route has 24)."""
    k = max(1, min(M, F))
    return TriTriPlan(-(-F // _K6_CLUSTER),
                      min(_K6_LIST_MAX,
                          max(_K6_LIST_MIN, 1 << (k - 1).bit_length())),
                      _K6_WARPS if B * Q < _K6_TEAM_BELOW else 1)


def overflowed_queries() -> int:
    """The queries whose hits overflowed K6's list since the last
    :func:`reset_overflowed`, on every device (synchronises)."""
    return sum(int(c.item()) for c in _OVERFLOWED.values())


def reset_overflowed() -> None:
    for c in _OVERFLOWED.values():
        c.zero_()


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
            _select(valid, endpoints, t_tris, k, faces[b, s:s + query_chunk],
                    bcs[b, s:s + query_chunk])
    return faces.reshape(B, Q * M), bcs.reshape(B, Q * M, 2, 3)


def _select(valid, endpoints, t_tris, k, faces, bcs) -> None:
    """The first k valid targets of each query in index order (jax.lax
    .top_k on the 0/1 score puts tied elements lower index first: a stable
    sort of the misses to the back) into faces (C, M) and bcs (C, M, 2,
    3)."""
    idx = torch.sort((~valid).to(torch.uint8), dim=-1,
                     stable=True).indices[:, :k]
    sel_valid = torch.gather(valid, 1, idx)
    sel_pts = endpoints[torch.arange(len(idx), device=idx.device)[:, None],
                        idx]  # (C, k, 2, 3)
    sel_bcs = point_to_barycentric(t_tris[idx][:, :, None], sel_pts)
    faces[:, :k] = torch.where(sel_valid, idx, -1).to(torch.int32)
    bcs[:, :k] = torch.where(sel_valid[..., None, None], sel_bcs, 0.0)


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """The bits of v (< 1024) to every third bit, as K6's Morton code."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def target_order_replay(target_tris: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6's prologue in plain PyTorch on any device: the targets' ids in
    Morton order (B, F), the cluster boxes (B, 6, NC = ceil(F / 32)) (min
    x, y, z, max x, y, z of each run of 32 in that order) and the
    supercluster boxes (B, 6, ceil(NC / 32)). The Morton code
    takes each box centre ((min + max) / 2) into 32 cells an axis of the
    body's box of centres, (c - lo) * (32 / (hi - lo)) in f32, truncated
    and held below 32; equal codes keep id order, as the kernel's
    counting sort puts them."""
    B, F = target_tris.shape[:2]
    dev = target_tris.device
    mn, mx = target_tris.amin(dim=-2), target_tris.amax(dim=-2)
    order = torch.empty((B, F), dtype=torch.long, device=dev)
    cells = float(1 << _K6_CELL_BITS)
    for b in range(B):
        if F == 0:
            continue
        c = (mn[b] + mx[b]) * 0.5
        nan = torch.isnan(c)
        lo = torch.where(nan, float("inf"), c).amin(dim=0)
        hi = torch.where(nan, float("-inf"), c).amax(dim=0)
        scale = torch.where(hi > lo, torch.full_like(lo, cells) / (hi - lo),
                            0.0)
        t = (c - lo) * scale
        cell = torch.where(t < cells - 1, t, cells - 1).to(torch.int64)
        code = (_spread3(cell[:, 0]) | _spread3(cell[:, 1]) << 1
                | _spread3(cell[:, 2]) << 2)
        key = code * (1 << 32) + torch.arange(F, device=dev)
        order[b] = torch.sort(key).indices
    mn = torch.gather(mn, 1, order[..., None].expand(B, F, 3))
    mx = torch.gather(mx, 1, order[..., None].expand(B, F, 3))
    boxes = []
    for _ in range(2):  # clusters of targets, then of clusters
        n = mn.shape[1]
        groups, pad = -(-n // _K6_CLUSTER), -n % _K6_CLUSTER
        mn = torch.nn.functional.pad(mn, (0, 0, 0, pad), value=float("inf"))
        mx = torch.nn.functional.pad(mx, (0, 0, 0, pad), value=float("-inf"))
        mn = mn.reshape(B, groups, _K6_CLUSTER, 3).amin(dim=2)
        mx = mx.reshape(B, groups, _K6_CLUSTER, 3).amax(dim=2)
        boxes.append(torch.cat([mn, mx], dim=-1).transpose(1, 2))
    return order, boxes[0], boxes[1]


def _overlap(box: torch.Tensor, qmin: torch.Tensor, qmax: torch.Tensor
             ) -> torch.Tensor:
    """(C, N): query box c (qmin, qmax (C, 3)) overlaps box n of (6, N)."""
    return torch.all((box[:3].T[None] <= qmax[:, None])
                     & (box[3:].T[None] >= qmin[:, None]), dim=-1)


def mesh_mesh_intersection_replay(query_tris: torch.Tensor,
                                  target_tris: torch.Tensor,
                                  max_collisions: int = 256,
                                  plan: Optional[TriTriPlan] = None,
                                  query_chunk: int = 64):
    """K6's design in plain PyTorch, on any device: (faces, bcs, info).

    The targets are ordered and clustered as the kernel's prologue
    (:func:`target_order_replay`); each query tests every supercluster
    box, the cluster boxes of the superclusters that overlap its box, the
    face boxes of the clusters that overlap it and the Möller test of the
    faces that pass; its hits, sorted by id, are its list. A query with
    more hits than ``plan.list_size`` takes the overflow regime (the first
    ``max_collisions`` hits in index order, which the same selection
    gives). ``info``: ``order`` (B, F), ``cbox`` (B, 6, NC) and ``scbox``
    (B, 6, NS) of the prologue, and per query (B, Q): ``clusters_tested``
    (cluster boxes of overlapping superclusters), ``faces_tested`` (faces
    of overlapping clusters), ``box_passed`` (Möller tests), ``hits`` and
    ``overflowed``; ``superclusters_tested``, the supercluster boxes each
    query tests (NS). Raises if the culling drops a pair that the
    all-pairs test finds."""
    B, Q = query_tris.shape[:2]
    F = target_tris.shape[1]
    M = max_collisions
    plan = plan or tri_tri_plan(B, Q, F, M)
    order, cbox, scbox = target_order_replay(target_tris)
    NC = cbox.shape[-1]
    dev = query_tris.device
    faces = torch.full((B, Q, M), -1, dtype=torch.int32, device=dev)
    bcs = query_tris.new_zeros((B, Q, M, 2, 3))
    info = {"order": order, "cbox": cbox, "scbox": scbox,
            "superclusters_tested": scbox.shape[-1],
            **{k: torch.zeros((B, Q), dtype=torch.long, device=dev)
               for k in ("clusters_tested", "faces_tested", "box_passed",
                         "hits")}}
    if F == 0:
        info["overflowed"] = info["hits"] > plan.list_size
        return faces.reshape(B, Q * M), bcs.reshape(B, Q * M, 2, 3), info
    for b in range(B):
        t_tris = target_tris[b]
        geom = (*_plane(t_tris), t_tris.amin(dim=-2), t_tris.amax(dim=-2))
        rank = torch.empty_like(order[b])
        rank[order[b]] = torch.arange(F, device=dev)
        for s in range(0, Q, max(1, query_chunk)):
            q_tris = query_tris[b, s:s + query_chunk]
            qmin, qmax = q_tris.amin(dim=-2), q_tris.amax(dim=-2)
            near_s = _overlap(scbox[b], qmin, qmax)  # (C, NS)
            # a cluster's box is tested where its supercluster overlaps
            tested = near_s.repeat_interleave(_K6_CLUSTER, dim=1)[:, :NC]
            near = _overlap(cbox[b], qmin, qmax) & tested
            # a target lies in the cluster of its position in the order
            lanes = near[:, rank // _K6_CLUSTER]  # (C, F) by id
            boxes = torch.all((geom[2][None] <= qmax[:, None])
                              & (geom[3][None] >= qmin[:, None]), dim=-1)
            valid, endpoints = _pairs_intersect(q_tris, t_tris, geom)
            if bool((valid & ~lanes).any()):
                raise AssertionError("K6 replay: a cluster test dropped a hit")
            rows = slice(s, s + len(q_tris))
            info["clusters_tested"][b, rows] = tested.sum(dim=1)
            info["faces_tested"][b, rows] = lanes.sum(dim=1)
            info["box_passed"][b, rows] = (lanes & boxes).sum(dim=1)
            info["hits"][b, rows] = valid.sum(dim=1)
            _select(valid, endpoints, t_tris, min(M, F), faces[b, rows],
                    bcs[b, rows])
    info["overflowed"] = info["hits"] > plan.list_size
    return faces.reshape(B, Q * M), bcs.reshape(B, Q * M, 2, 3), info


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
    return _mesh_mesh_intersection_cuda(query_tris, target_tris,
                                        max_collisions)[:2]


def _mesh_mesh_intersection_cuda(query_tris, target_tris, max_collisions,
                                 plan: Optional[TriTriPlan] = None,
                                 tested: Optional[torch.Tensor] = None):
    """Kernel K6 under ``plan`` (default :func:`tri_tri_plan`): faces,
    bcs and the targets' order (B, F) int32 that its prologue wrote. With
    ``tested``, four int64 counters on the device, the launch runs the
    kernel's counting build, which adds the tests its query walk made:
    supercluster boxes, cluster boxes, face boxes and Möller tests, the
    totals of the replay's ``superclusters_tested``, ``clusters_tested``,
    ``faces_tested`` and ``box_passed``."""
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
    plan = plan or tri_tri_plan(B, Q, F, M)
    if plan.team not in (1, _K6_WARPS):
        raise ValueError(f"K6 team {plan.team}: 1 or {_K6_WARPS} warps")
    if plan.list_size & (plan.list_size - 1) or not (
            1 <= plan.list_size <= _K6_LIST_MAX):
        raise ValueError(f"K6 list size {plan.list_size}")
    if tested is not None:
        check_cuda_input(tested, "tested", torch.int64, (4,), dev)
    faces = torch.empty((B, Q * M), dtype=torch.int32, device=dev)
    bcs = torch.empty((B, Q * M, 2, 3), dtype=torch.float32, device=dev)
    if B == 0 or Q == 0:
        return faces, bcs, torch.empty((B, F), dtype=torch.int32,
                                       device=dev)
    key = torch.device("cuda", dev.index if dev.index is not None
                       else torch.cuda.current_device())
    if key not in _OVERFLOWED:
        _OVERFLOWED[key] = torch.zeros((1,), dtype=torch.int32, device=key)
    # the prologue's scratch (csrc/tri_tri.cu `scratch`): per body the
    # targets' planes and boxes by id, their centres, each prologue block's
    # extremes of them, the boxes in Morton order and the cluster and
    # supercluster boxes; the cells' counts and fill positions, the order,
    # each target's cell and the unsorted ids
    nc = -(-F // _K6_CLUSTER)
    fs = torch.empty(B * (19 * F + 6 * -(-F // _K6_BLOCK) + 6 * nc
                          + 6 * -(-nc // _K6_CLUSTER)),
                     dtype=torch.float32, device=dev)
    at = 2 * (1 << 3 * _K6_CELL_BITS) * B
    iscratch = torch.empty(at + 3 * B * F, dtype=torch.int32, device=dev)
    TRI_KERNEL.launch("tri_tri_forward", [
        query_tris, target_tris, fs, iscratch, faces, bcs, _OVERFLOWED[key],
        tested, B, Q, F, M, plan.list_size, plan.team])
    return faces, bcs, iscratch[at:at + B * F].view(B, F)


class MeshMeshIntersection:
    """API-parity wrapper (reference ``mesh_mesh_intersection.py:36-62``)."""

    def __init__(self, max_collisions: int = 256, query_chunk: int = 64):
        self.max_collisions = max_collisions
        self.query_chunk = query_chunk

    def __call__(self, query_tris: torch.Tensor, target_tris: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        return mesh_mesh_intersection(query_tris, target_tris,
                                      self.max_collisions, self.query_chunk)
