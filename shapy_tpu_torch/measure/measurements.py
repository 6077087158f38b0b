"""Virtual anthropometric measurements (port of
``shapy_tpu/measure/measurements.py``).

  * mass   = |signed mesh volume| x 985 kg/m^3,
  * height = |y(head top) - y(left heel)| at face + barycentric anchors,
  * chest / waist / hips = slice the mesh with the horizontal plane at an
    anchor's height, then take the convex-hull perimeter of the (x, z)
    slice points.

``BodyMeasurements.forward_from_vertices`` goes through
:meth:`BodyMeasurements.measure`: for CUDA tensors kernel K1
(``csrc/measure.cu``; ``measure_forward`` in the default "reference"
slice mode, ``measure_exact_forward`` in "exact" mode) with its backward
kernels; for CPU tensors :func:`measure_plain`, the structure-of-arrays
pipeline of the JAX package in PyTorch, differentiated by autograd.

``BodyMeasurements.forward`` (and ``__call__``, ``compute_mass``,
``compute_height``, ``compute_periphery``, ``compute_peripheries``) take
(B, F, 3, 3) triangles and return the JAX package's output schema, slice
points included. For CUDA tensors this is kernel K1-AoS: K1 on all faces
of the triangles viewed as (B, 3F, 3) vertices with the faces (3f, 3f + 1,
3f + 2), then ``measure_points`` for the slice points; its backward is
K1's, with ``measure_points_backward`` for the points. For CPU tensors it
is :meth:`BodyMeasurements.forward_plain`, the JAX package's
array-of-structures functions in PyTorch.

``Anchor``, ``MeasurementAnchors`` and ``candidate_faces`` are numpy,
copied from the JAX package (whose module imports jax and yaml); the
anchor YAMLs are read by :mod:`shapy_tpu_torch.utils.yaml_subset`.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from shapy_tpu_torch.core.geometry import (
    face_barycentric_point,
    signed_volume,
)
from shapy_tpu_torch.ops.convex_hull import (
    hull_directions,
    hull_perimeter_exact_np,
    hull_perimeter_support,
    hull_perimeter_support_xz,
)
from shapy_tpu_torch.ops.plane_slice import (
    plane_slice_reference,
    plane_slice_reference_soa,
    plane_slice_soa,
    plane_slice_triangles,
)
from shapy_tpu_torch.utils import yaml_subset
from shapy_tpu_torch.utils.cuda_kernels import CudaKernel, check_cuda_input

# Average human body density, kg/m^3.
DENSITY = 985.0
PLANES = ("chest", "waist", "hips")

_ASSET_DIR = Path(__file__).resolve().parents[2] / "assets" / "measurements"
DEFAULT_DEFINITIONS = str(_ASSET_DIR / "measurement_defitions.yaml")
DEFAULT_VERTICES = {
    "smplx": str(_ASSET_DIR / "smplx_measurements.yaml"),
    "smpl": str(_ASSET_DIR / "smpl_measurement_vertices.yaml"),
}

_FORWARD_ARGS = "pppp ppp pppp ppp iii iii iii ii ff iiiii p"
_BACKWARD_ARGS = "pppp ppp pppp pp pppp pp ppppp iii iii iii i iiiii ff p"
MEASURE_KERNEL = CudaKernel("measure.cu", {
    "measure_forward": _FORWARD_ARGS,
    "measure_exact_forward": _FORWARD_ARGS,
    "measure_backward": _BACKWARD_ARGS,
    "measure_exact_backward": _BACKWARD_ARGS,
    "measure_points": "ppppppp iiiiii p",
    "measure_points_backward": "ppppppp iiii iii i p",
})
_MAX_HULL_DIRECTIONS = 1024  # the kernels give each thread 2 pairs
# K1's forward plan (measure_plan): about this many walk positions a CTA,
# a face's signed volume counted as a quarter of its slice tests, at most
# 16 CTAs a cluster (the non-portable size), and at most ~128 CTAs a plane
# over the batch (B x cluster): ~3 CTAs an SM over the three planes on
# the H100's 132 SMs, where the walk's throughput levels off (PERF.md).
_K1_CTA_FACES = 1024
_K1_MASS_SHARE = 4
_K1_MAX_CLUSTER = 16
_K1_PLANE_CTAS = 128
# K1's backward plan (measure_backward_plan): a cluster of up to 4 CTAs a
# (body, plane) while the batch's rows leave the H100's 132 SMs idle (each
# sweeps its run of the row's hits), and records of each row's first 4096
# hits (a slice has a few hundred; 147 KB a row).
_K1B_MAX_BLOCKS = 4
_K1B_SMS = 132
_K1B_RECORDS = 4096
_K1B_GROUP = 32  # hits a warp takes at once (kGroup in measure.cu)
_K1B_THREADS = 512  # the planes pass's CTA (kPlaneThreads)
_K1B_WORD_SPAN = 16  # walk positions a word of the hit map (kWordSpan)
# K1-AoS's slice points (points_plan): slots a block of measure_points
# stages and stores (kPointsTile, 24 KB of points), faces a block of
# measure_points_backward takes (kFaceTile).
_POINTS_TILE = 2048
_FACE_TILE = 256


class MeasurePlan(NamedTuple):
    """K1's forward work split (from the shape alone): a cluster of
    ``cluster`` CTAs per (body, plane) and one per body for mass and
    height; CTA r of plane p's cluster walks positions ``[r spans[p], (r +
    1) spans[p])`` (clipped to the plane's count), of the mass cluster
    faces ``[r mass_span, (r + 1) mass_span)``."""

    cluster: int
    spans: Tuple[int, int, int]
    mass_span: int


def measure_plan(counts: Tuple[int, int, int], F: int,
                 B: int) -> MeasurePlan:
    """The cluster of K1's forward (``csrc/measure.cu``) for B bodies,
    sized from the faces walked: its longest walk (a plane's count, or a
    quarter of the F faces the mass sums) over ~1024 positions a CTA, at
    most ~128 CTAs a plane over the batch, 1 to 16 CTAs; each CTA takes a
    contiguous run of positions."""
    work = max(max(counts), -(-F // _K1_MASS_SHARE))
    cluster = min(_K1_MAX_CLUSTER, -(-work // _K1_CTA_FACES),
                  _K1_PLANE_CTAS // max(B, 1))
    cluster = max(1, cluster)
    return MeasurePlan(cluster, tuple(-(-n // cluster) for n in counts),
                       -(-F // cluster))


class MeasureBackwardPlan(NamedTuple):
    """K1's backward work split and scratch (from the shape alone): a
    cluster of ``blocks`` CTAs per (body, plane)
    (``measure_backward_planes``), the ``records`` of each row's first
    hits (9 floats each: the hit's VJP to its face), and per row
    ``words`` words of the hit map (a word per 16 walk positions) and
    ``groups`` sums of the plane height's cotangent (a group per 32
    hits)."""

    blocks: int
    records: int
    words: int
    groups: int


def measure_backward_plan(counts: Tuple[int, int, int],
                          B: int) -> MeasureBackwardPlan:
    """The plan of K1's backward (``csrc/measure.cu``) for B bodies whose
    planes walk ``counts`` faces: up to 4 CTAs a row while 3 B rows leave
    SMs of the H100's 132 idle, records of at most 4096 hits a row, and
    the words and groups that the rows' most hits need (2 a face)."""
    most = max(max(counts), 1)
    blocks = max(1, min(_K1B_MAX_BLOCKS, _K1B_SMS // max(3 * B, 1)))
    return MeasureBackwardPlan(blocks, min(2 * most, _K1B_RECORDS),
                               -(-most // _K1B_WORD_SPAN),
                               -(-2 * most // _K1B_GROUP))


@dataclass(frozen=True)
class Anchor:
    face_idx: int
    bary: Tuple[float, float, float]


@dataclass(frozen=True)
class MeasurementAnchors:
    """Static anchor set for one mesh topology."""

    head_top: Anchor
    left_heel: Anchor
    chest: Anchor
    waist: Anchor
    hips: Anchor

    @classmethod
    def from_yaml(
        cls,
        meas_definition_path: str = DEFAULT_DEFINITIONS,
        meas_vertices_path: Optional[str] = None,
        model_type: str = "smplx",
    ) -> "MeasurementAnchors":
        """Load the reference's anchor YAMLs. The chest / waist / hips
        planes anchor at the surface points named by the CW_p / BW_p /
        IW_p actions (nipple / belly button / crotch)."""
        if meas_vertices_path is None:
            meas_vertices_path = DEFAULT_VERTICES[model_type]
        defs = yaml_subset.load(os.path.expanduser(os.path.expandvars(
            meas_definition_path)))
        verts = yaml_subset.load(os.path.expanduser(os.path.expandvars(
            meas_vertices_path)))

        def anchor(name: str) -> Anchor:
            d = verts[name]
            return Anchor(int(d["face_idx"]), tuple(float(x) for x in d["bc"]))

        return cls(
            head_top=anchor("HeadTop"),
            left_heel=anchor("HeelLeft"),
            chest=anchor(defs["CW_p"][0]),
            waist=anchor(defs["BW_p"][0]),
            hips=anchor(defs["IW_p"][0]),
        )

    @classmethod
    def synthetic(cls, faces: np.ndarray, vertices: np.ndarray
                  ) -> "MeasurementAnchors":
        """Pick plausible anchors on an arbitrary closed mesh (for tests)."""
        centers = vertices[faces].mean(axis=1)
        y = centers[:, 1]

        def nearest(frac: float) -> Anchor:
            target = y.min() + frac * (y.max() - y.min())
            return Anchor(int(np.argmin(np.abs(y - target))),
                          (1 / 3, 1 / 3, 1 / 3))

        return cls(
            head_top=nearest(0.999),
            left_heel=nearest(0.001),
            chest=nearest(0.72),
            waist=nearest(0.58),
            hips=nearest(0.47),
        )

    def ordered(self) -> List[Anchor]:
        """head top, left heel, chest, waist, hips: the kernel's order."""
        return [self.head_top, self.left_heel, self.chest, self.waist,
                self.hips]


def candidate_faces(
    v_template: np.ndarray,
    shapedirs: np.ndarray,
    faces: np.ndarray,
    anchors: MeasurementAnchors,
    beta_bound: float = 8.0,
    margin: float = 0.01,
    pad_to: int = 256,
) -> Dict[str, np.ndarray]:
    """Per-plane static candidate-face subsets via interval bounds.

    With ``v_shaped = v_template + shapedirs @ beta`` the signed height of
    vertex v above an anchor plane stays within ``beta_bound * ||S_v -
    S_anchor||`` of its template value for ``||beta|| <= beta_bound``; a
    face is a candidate iff some vertex can be below the plane and some
    above. Exact (zero error) for every body inside the bound.

    v_template (V, 3); shapedirs (V, 3, num_betas), the betas basis only;
    faces (F, 3). Subsets are padded with face id 0 (dropped by the
    reference slice) to a multiple of ``pad_to``.

    Returns {'chest'|'waist'|'hips': (N,) int32 original face ids}.
    """
    y_t = np.asarray(v_template, np.float64)[:, 1]
    S_y = np.asarray(shapedirs, np.float64)[:, 1, :]
    faces = np.asarray(faces)
    out: Dict[str, np.ndarray] = {}
    for name in PLANES:
        a: Anchor = getattr(anchors, name)
        tri = faces[a.face_idx]
        bc = np.asarray(a.bary, np.float64)
        t_a = float((y_t[tri] * bc).sum())
        S_a = (S_y[tri] * bc[:, None]).sum(axis=0)
        g0 = y_t[faces] - t_a
        band = beta_bound * np.linalg.norm(S_y[faces] - S_a, axis=-1) + margin
        crossable = ((g0 - band).min(axis=1) < 0) & (
            (g0 + band).max(axis=1) > 0)
        idx = np.nonzero(crossable)[0]
        pad = (-len(idx)) % pad_to
        idx = np.concatenate([idx, np.zeros(pad, idx.dtype)])
        out[name] = idx.astype(np.int32)
    return out


def _anchor_point(triangles: torch.Tensor, anchor: Anchor) -> torch.Tensor:
    """(B, F, 3, 3) triangles -> (B, 3) point at the anchor."""
    return face_barycentric_point(triangles, anchor.face_idx, anchor.bary)


def vertex_corner_lists(faces: np.ndarray, num_vertices: int,
                        others: bool = False
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """For each vertex, its (position * 4 + corner) entries in ``faces``
    (P, 3), in position order, as CSR: ptr (num_vertices + 1,) and idx
    (3P,), int32. With ``others`` each entry is a row (position * 4 +
    corner, the face's next vertex, its previous vertex, 0) of idx (3P,
    4), so that the mass term's cross product reads no face. The backward
    kernel sums each vertex's gradient over these in this fixed order."""
    faces = np.asarray(faces, np.int64)
    flat = faces.reshape(-1)
    order = np.argsort(flat, kind="stable")  # position * 3 + corner
    ptr = np.zeros(num_vertices + 1, np.int64)
    np.cumsum(np.bincount(flat, minlength=num_vertices), out=ptr[1:])
    pos, corner = order // 3, order % 3
    idx = pos * 4 + corner
    if others:
        idx = np.stack([idx, faces[pos, (corner + 1) % 3],
                        faces[pos, (corner + 2) % 3], np.zeros_like(idx)], -1)
    return ptr.astype(np.int32), idx.astype(np.int32)


def _soa(vertices: torch.Tensor, faces: torch.Tensor):
    """(B, V, 3) vertices -> per-coordinate (B, 3, F) triangle planes."""
    ft = faces.T.long()
    return vertices[..., 0][:, ft], vertices[..., 1][:, ft], \
        vertices[..., 2][:, ft]


def measure_plain(
    vertices: torch.Tensor,
    faces: torch.Tensor,
    plane_faces: Optional[List[torch.Tensor]],
    anchors: MeasurementAnchors,
    num_hull_directions: int = 256,
    density: float = DENSITY,
    slice_mode: str = "reference",
    centroids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1 and K1-exact, differentiable by autograd.

    vertices (B, V, 3) f32; faces (F, 3) int; plane_faces one (N_p,) face
    id list per plane, or None for all F faces; centroids (B, 3, 2), the
    slice centroids' values to use (see
    :func:`~shapy_tpu_torch.ops.convex_hull.hull_perimeter_support_xz`;
    :func:`saved_centroids` gives the kernel's).

    Returns (B, 5) [mass, height, chest, waist, hips] and (B, 3) plane
    heights."""
    tx, ty, tz = _soa(vertices, faces)

    def anchor_y(anchor: Anchor) -> torch.Tensor:
        # Summed left to right, as the kernel does: a plane height one ulp
        # off moves the hits and with them the hull's near-tie decisions.
        bc = torch.tensor(anchor.bary, dtype=ty.dtype, device=ty.device)
        y = ty[..., :, anchor.face_idx]
        return y[..., 0] * bc[0] + y[..., 1] * bc[1] + y[..., 2] * bc[2]

    x0, x1, x2 = tx[..., 0, :], tx[..., 1, :], tx[..., 2, :]
    y0, y1, y2 = ty[..., 0, :], ty[..., 1, :], ty[..., 2, :]
    z0, z1, z2 = tz[..., 0, :], tz[..., 1, :], tz[..., 2, :]
    det = (-x2 * y1 * z0 + x1 * y2 * z0 + x2 * y0 * z1
           - x0 * y2 * z1 - x1 * y0 * z2 + x0 * y1 * z2)
    mass = torch.abs(torch.sum(det, dim=-1)) / 6.0 * density
    height = torch.abs(anchor_y(anchors.head_top)
                       - anchor_y(anchors.left_heel))

    cols, heights = [mass, height], []
    for p, name in enumerate(PLANES):
        plane_h = anchor_y(getattr(anchors, name))
        if plane_faces is None:
            sx, sy, sz, ids = tx, ty, tz, None
        else:
            ids = plane_faces[p].long()
            sx, sy, sz = tx[..., ids], ty[..., ids], tz[..., ids]
        if slice_mode == "reference":
            xs, zs, m = plane_slice_reference_soa(sy, sx, sz, plane_h,
                                                  face_ids=ids)
        else:
            xs, zs, m = plane_slice_soa(sy, sx, sz, plane_h)
        cols.append(hull_perimeter_support_xz(
            xs, zs, m, num_hull_directions,
            None if centroids is None else centroids[:, p].unbind(-1)))
        heights.append(plane_h)
    return torch.stack(cols, dim=-1), torch.stack(heights, dim=-1)


def _saved_rows_plain(vertices: torch.Tensor, faces: torch.Tensor,
                      plane_faces: Optional[List[torch.Tensor]],
                      plane_heights: torch.Tensor, slice_mode: str):
    """The plain slice of each plane at the given (B, 3) plane heights, as
    K1's forward saves it: hits (B, 3, cap, 2) in face order (by walk
    position, then quad triangle / first-second; 0 past a row's hits),
    codes (B, 3, cap) (walk position * 16 + the formula that made the hit,
    as the kernel writes it) and (B, 3, 3) the hit count and the centroid
    as :func:`~shapy_tpu_torch.ops.convex_hull.hull_perimeter_support_xz`
    takes it, per plane."""
    B, dev = vertices.shape[0], vertices.device
    tx, ty, tz = _soa(vertices, faces)
    walks = [tx.shape[-1] if plane_faces is None else plane_faces[p].shape[0]
             for p in range(3)]
    cap = 2 * max(max(walks), 1)
    hits = torch.zeros((B, 3, cap, 2), dtype=torch.float32, device=dev)
    codes = torch.zeros((B, 3, cap), dtype=torch.int32, device=dev)
    rows = torch.zeros((B, 3, 3), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for p, n_walk in enumerate(walks):
        ids = None if plane_faces is None else plane_faces[p].long()
        sx, sy, sz = (tx, ty, tz) if ids is None else (
            tx[..., ids], ty[..., ids], tz[..., ids])
        pos = torch.arange(n_walk, device=dev)
        if slice_mode == "reference":
            xs, zs, m, won = plane_slice_reference_soa(
                sy, sx, sz, plane_heights[:, p], face_ids=ids, winners=True)
            code = torch.cat([pos, pos]) * 16 + won
        else:
            xs, zs, m = plane_slice_soa(sy, sx, sz, plane_heights[:, p])
            d = sy - plane_heights[:, p, None, None]
            first = torch.where(d[:, 0] * d[:, 1] < 0, 0, 1)
            second = torch.where(d[:, 2] * d[:, 0] < 0, 2, 1)
            code = torch.cat([pos * 16 + first, pos * 16 + 4 + second], -1)
        count = torch.clamp(m.sum(-1), min=1)
        rows[:, p, 0] = m.sum(-1).float()
        rows[:, p, 1] = torch.where(m, xs, zero).sum(-1) / count
        rows[:, p, 2] = torch.where(m, zs, zero).sum(-1) / count
        order = torch.stack([pos, pos + n_walk], -1).reshape(-1)
        xs, zs, m, code = (t.expand(B, -1)[:, order]
                           for t in (xs, zs, m, code))
        for b in range(B):
            k = int(m[b].sum())
            hits[b, p, :k, 0], hits[b, p, :k, 1] = xs[b][m[b]], zs[b][m[b]]
            codes[b, p, :k] = code[b][m[b]].int()
    return hits, codes, rows


def saved_hits_plain(vertices: torch.Tensor, faces: torch.Tensor,
                     plane_faces: Optional[List[torch.Tensor]],
                     plane_heights: torch.Tensor, slice_mode: str
                     ) -> List[List[Tuple[torch.Tensor, torch.Tensor]]]:
    """The hits K1 / K1-exact's forward saves, from the plain slice's
    masks at the given (B, 3) plane heights: per body, per plane, the (n,
    2) points in face order (by walk position, then quad triangle /
    first-second) and their (n,) codes. A reference code holds walk
    position * 16 + quad triangle * 8 (compare ``code & ~7``: which of the
    six candidates won is the kernel's to say); an exact code also the
    crossed edge, as the kernel writes it."""
    hits, codes, rows = _saved_rows_plain(vertices, faces, plane_faces,
                                          plane_heights, slice_mode)
    if slice_mode == "reference":
        codes = codes & ~7
    n = rows[..., 0].long().tolist()
    return [[(hits[b, p, :n[b][p]], codes[b, p, :n[b][p]])
             for p in range(3)] for b in range(vertices.shape[0])]


def saved_centroids(vals: torch.Tensor) -> torch.Tensor:
    """The (B, 3, 2) slice centroids that kernel K1 / K1-exact computed
    for ``vals``, the first output of a :meth:`BodyMeasurements.measure`
    call that records a graph, as saved for its backward."""
    return vals.grad_fn.saved_tensors[3][:, :3, 1:3]


def saved_forward_plain(meas: "BodyMeasurements", vertices: torch.Tensor,
                        use_face_subsets: bool = True
                        ) -> Tuple[torch.Tensor, ...]:
    """What K1's / K1-exact's forward saves for its backward, from the
    plain version on any device: hits and codes (``_saved_rows_plain``),
    stats (B, 4, 4) (per plane: hit count and centroid; row 3: the signed
    volume sum) and plane_h (B, 3). For :func:`measure_backward_replay`
    off the card."""
    v = vertices.detach().float()
    _, plane_h = measure_plain(v, meas.faces, None, meas.anchors,
                               meas.num_hull_directions, meas.density,
                               meas.slice_mode)
    plane_faces = ([getattr(meas, f"subset_{n}") for n in PLANES]
                   if use_face_subsets and meas.has_subsets else None)
    hits, codes, rows = _saved_rows_plain(v, meas.faces, plane_faces,
                                          plane_h, meas.slice_mode)
    stats = torch.zeros((v.shape[0], 4, 4), dtype=torch.float32,
                        device=v.device)
    stats[:, :3, :3] = rows
    (x0, x1, x2), (y0, y1, y2), (z0, z1, z2) = (
        c.unbind(1) for c in _soa(v, meas.faces))
    stats[:, 3, 0] = (-x2 * y1 * z0 + x1 * y2 * z0 + x2 * y0 * z1
                      - x0 * y2 * z1 - x1 * y0 * z2 + x0 * y1 * z2).sum(-1)
    return hits, codes, stats, plane_h


def _block_sum_replay(vals: torch.Tensor) -> torch.Tensor:
    """``block_sum`` of ``measure.cu`` over (..., threads) thread values:
    each warp's shuffle tree, then warp 0's over the warps' sums."""
    warps = vals.shape[-1] // 32
    w = vals.reshape(*vals.shape[:-1], warps, 32)
    for o in (16, 8, 4, 2, 1):
        w = w[..., :o] + w[..., o:2 * o]
    z = torch.zeros((*vals.shape[:-1], 32), dtype=vals.dtype,
                    device=vals.device)
    z[..., :warps] = w[..., 0]
    for o in (16, 8, 4, 2, 1):
        z = z[..., :o] + z[..., o:2 * o]
    return z[..., 0]


# Quad triangle q's edge c as (origin a, origin b, direction a, direction
# b): measure.cu's quad_edge, row q * 3 + c.
_QUAD_EDGES = ((-1.0, -1.0, 2.0, 0.0), (1.0, -1.0, 0.0, 2.0),
               (1.0, 1.0, -2.0, -2.0), (-1.0, -1.0, 2.0, 2.0),
               (1.0, 1.0, -2.0, 0.0), (-1.0, 1.0, 0.0, -2.0))


def _hit_vjp_replay(xyz, h, detail, ga, gb, exact: bool, gy=None):
    """``hit_vjp`` of ``measure.cu`` for (..., ) hits: xyz (3, 3, ...) the
    triangles' coordinates [coordinate][vertex]; ``gy`` the exact-mode
    cotangent of the recomputed y (None: 0); returns (..., 9) and the
    plane height's (...)."""
    (x, y, z) = xyz
    zero = torch.zeros_like(ga)

    def pick(c, k):  # c[k] with k a (...) index into the three vertices
        return torch.where(k == 0, c[0], torch.where(k == 1, c[1], c[2]))

    if exact:
        a = detail & 3
    else:
        q, c = detail >> 3, detail & 7
        a = (c - 3).clamp(0, 2)
    b = torch.where(a == 2, 0, a + 1)
    xa, xb, ya, yb, za, zb = (pick(x, a), pick(x, b), pick(y, a),
                              pick(y, b), pick(z, a), pick(z, b))
    if exact:
        sa, sb = ya - h, yb - h
        denom = sa - sb
        big = torch.abs(denom) > 1e-20
        den = torch.where(big, denom, torch.full_like(denom, 1e-20))
        t = sa / den
        gt = ga * (xb - xa) + gb * (zb - za)
        with_y = None if gy is None else gy != 0
        if with_y is not None:
            gt = torch.where(with_y, gt + gy * (yb - ya), gt)
        gsa = gt / den
        gden = -gt * t / den
        gsa = torch.where(big, gsa + gden, gsa)
        gsb = torch.where(big, zero - gden, zero)
        ya_g, yb_g, gh = gsa, gsb, -(gsa + gsb)
        if with_y is not None:
            ya_g = torch.where(with_y, gsa + (gy - gy * t), gsa)
            yb_g = torch.where(with_y, gsb + gy * t, gsb)
    else:
        dy = yb - ya
        t = (h - ya) / dy
        gt = ga * (xb - xa) + gb * (zb - za)
        gnum = gt / dy
        gdy = -gt * t / dy
        ya_g, yb_g, gh = -gnum - gdy, gdy, gnum
    rows = []
    for k in range(3):
        at_a, at_b = a == k, b == k
        rows += [torch.where(at_a, ga - ga * t, torch.where(at_b, ga * t,
                                                            zero)),
                 torch.where(at_a, ya_g, torch.where(at_b, yb_g, zero)),
                 torch.where(at_a, gb - gb * t, torch.where(at_b, gb * t,
                                                            zero))]
    g9 = torch.stack(rows, -1)
    if exact:
        return g9, gh
    # Moller casts of the quad edges (c < 3)
    table = torch.tensor(_QUAD_EDGES, dtype=ga.dtype, device=ga.device)
    E = table[(q * 3 + c.clamp(max=2)).long()]
    ox, oz, dx, dz = E.unbind(-1)
    e1x, e1y, e1z = x[1] - x[0], y[1] - y[0], z[1] - z[0]
    e2x, e2y, e2z = x[2] - x[0], y[2] - y[0], z[2] - z[0]
    px = -dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y
    det = e1x * px + e1y * py + e1z * pz
    inv = 1.0 / det
    tx, ty, tz = ox - x[0], h - y[0], oz - z[0]
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    num = e2x * qx + e2y * qy + e2z * qz
    gt = ga * dx + gb * dz
    gnum = gt * inv
    gdet = -(gt * num) * inv * inv
    ge2x, ge2y, ge2z = gnum * qx, gnum * qy, gnum * qz
    gqx, gqy, gqz = gnum * e2x, gnum * e2y, gnum * e2z
    gtx = e1y * gqz - e1z * gqy
    gty = e1z * gqx - e1x * gqz
    gtz = e1x * gqy - e1y * gqx
    ge1x = gqy * tz - gqz * ty + gdet * px
    ge1y = gqz * tx - gqx * tz + gdet * py
    ge1z = gqx * ty - gqy * tx + gdet * pz
    gpx, gpy, gpz = gdet * e1x, gdet * e1y, gdet * e1z
    ge2x = ge2x + gpy * dz
    ge2y = ge2y + (gpz * dx - gpx * dz)
    ge2z = ge2z + -gpy * dx
    cast = torch.stack([-gtx - ge1x - ge2x, -gty - ge1y - ge2y,
                        -gtz - ge1z - ge2z, ge1x, ge1y, ge1z, ge2x, ge2y,
                        ge2z], -1)
    moller = (c < 3)[..., None]
    return torch.where(moller, cast, g9), torch.where(c < 3, gty, gh)


def measure_backward_replay(meas: "BodyMeasurements",
                            vertices: torch.Tensor, saved, cotangents,
                            use_face_subsets: bool = True) -> torch.Tensor:
    """The gradient of K1's / K1-exact's backward kernels
    (``measure_backward_planes`` then ``measure_backward_vertices``), in
    their operations and order, in PyTorch on ``vertices``' device: each
    pair's extremes and ties, the centroid's share from the pairs
    (``block_sum``'s tree), each hit's point cotangent over the pairs in
    order and its chain, the plane height's cotangent over groups of 32
    hits (a warp's tree, then the groups in order), and per vertex the mass
    term, each plane's hits and the anchors in the kernel's order. The
    kernel's bits on the card; on any device the gradient of
    :func:`measure_plain` given the same centroids, to rounding.

    ``saved`` is (hits, codes, stats, plane_h) as the forward saves them
    (``vals.grad_fn.saved_tensors[1:]`` of a kernel call, or
    :func:`saved_forward_plain`); ``cotangents`` (g_out (B, 5), g_plane_h
    (B, 3))."""
    hits, codes, stats, plane_h = saved
    g_out, g_plane_h = (g.detach().float() for g in cotangents)
    walk = meas._vertex_walk(use_face_subsets)
    v = vertices.detach().float()
    B, V, _ = v.shape
    dev, f32 = v.device, torch.float32
    R = 3 * B
    cs, sn = meas.hull_cos.to(dev), meas.hull_sin.to(dev)
    half_k = cs.shape[0]
    angle_step = torch.tensor(np.float32(2.0 * math.pi / (2 * half_k)),
                              device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)

    # The planes pass, all rows at once, hits padded to the most.
    n = stats[:, :3, 0].reshape(R).long()
    N = max(int(n.max()), 1)
    cap = hits.shape[2]
    pts = hits.reshape(R, cap, 2)[:, :N].float()
    code = codes.reshape(R, cap)[:, :N].long()
    valid = torch.arange(N, device=dev) < n[:, None]
    xc = pts[..., 0] - stats[:, :3, 1].reshape(R, 1)
    zc = pts[..., 1] - stats[:, :3, 2].reshape(R, 1)
    pr = xc[..., None] * cs + zc[..., None] * sn  # (R, N, K/2)
    inf = torch.tensor(float("inf"), device=dev)
    vx = torch.where(valid[..., None], pr, -inf).amax(1)
    vn = torch.where(valid[..., None], pr, inf).amin(1)
    kx = ((pr == vx[:, None]) & valid[..., None]).sum(1)
    kn = ((pr == vn[:, None]) & valid[..., None]).sum(1)
    n_walk = torch.tensor(walk.counts, device=dev).repeat(B)
    masked = (2 * n_walk - n)[:, None]
    gp = torch.where(n >= 2, g_out[:, 2:5].reshape(R) * angle_step,
                     zero)[:, None]
    M = torch.where(masked > 0, torch.clamp(vx, min=0.0), vx)
    nx = torch.where(vx == M, kx, 0) + torch.where(
        (masked > 0) & (M == 0.0), masked, 0)
    fx = torch.where((vx == M) & (M >= 0.0) & (nx > 0),
                     gp / nx.clamp(min=1).float(), zero)
    mm = torch.where(masked > 0, torch.clamp(vn, max=0.0), vn)
    nn = torch.where(vn == mm, kn, 0) + torch.where(
        (masked > 0) & (mm == 0.0), masked, 0)
    fn = torch.where((vn == mm) & (-mm >= 0.0) & (nn > 0),
                     gp / nn.clamp(min=1).float(), zero)
    t = fx * kx.float() - fn * kn.float()
    threads = torch.zeros((R, _K1B_THREADS), dtype=f32, device=dev)
    threads[:, :half_k] = t * cs
    tx = _block_sum_replay(zero + threads)  # a pair a thread
    threads[:, :half_k] = t * sn
    tz = _block_sum_replay(zero + threads)
    cnt = torch.clamp(n, min=1).float()
    cgx, cgz = (-tx / cnt)[:, None], (-tz / cnt)[:, None]
    gx = torch.zeros_like(xc)
    gz = torch.zeros_like(xc)
    for d in range(half_k):
        at_max, at_min = pr[..., d] == vx[:, d:d + 1], pr[..., d] == vn[
            :, d:d + 1]
        gx = torch.where(at_max, gx + fx[:, d:d + 1] * cs[d], gx)
        gz = torch.where(at_max, gz + fx[:, d:d + 1] * sn[d], gz)
        gx = torch.where(at_min, gx - fn[:, d:d + 1] * cs[d], gx)
        gz = torch.where(at_min, gz - fn[:, d:d + 1] * sn[d], gz)
    pos = torch.where(valid, code >> 4, 0)
    row_p = torch.arange(R, device=dev) % 3
    face = pos
    if walk.plane_faces is not None:
        off = torch.tensor(walk.offsets, device=dev)[row_p][:, None]
        face = walk.plane_faces.long()[off + pos]
    corner_ids = walk.faces.long()[face]  # (R, N, 3)
    body = torch.arange(R, device=dev) // 3
    xyz = v[body[:, None, None], corner_ids].permute(3, 2, 0, 1)
    h = plane_h.reshape(R, 1).float()
    g9, gh = _hit_vjp_replay(xyz, h, code & 15, gx + cgx, gz + cgz,
                             meas.slice_mode == "exact")
    g9 = torch.where(valid[..., None], g9, zero)
    gh = torch.where(valid, gh, zero)
    groups = -(-N // 32)
    lanes = torch.zeros((R, groups * 32), dtype=f32, device=dev)
    lanes[:, :N] = gh
    lanes = lanes.view(R, groups, 32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes[..., :o] + lanes[..., o:2 * o]
    part = lanes[..., 0]
    g_h = torch.zeros(R, dtype=f32, device=dev)
    for k in range(groups):
        g_h = torch.where(k < (n + 31) // 32, g_h + part[:, k], g_h)
    g_h = (g_h + g_plane_h.reshape(R)).view(B, 3)

    # The vertices pass.
    Vm = walk.num_mesh_vertices
    ptr, ent = (t.long() for t in walk.face_csr)
    grad = torch.zeros((B, V, 3), dtype=f32, device=dev)
    gv = [torch.zeros((B, Vm), dtype=f32, device=dev) for _ in range(3)]
    S = stats[:, 3, 0]
    density = torch.tensor(np.float32(meas.density), device=dev)
    six = torch.tensor(6.0, device=dev)  # a tensor: a CUDA division by a
    # host scalar multiplies by its reciprocal
    gm = (g_out[:, 0] * density / six * torch.sign(S))[:, None]

    def entries(p_ptr, p_idx):  # per vertex its k-th entry, k < valence
        count = p_ptr[1:] - p_ptr[:-1]
        for k in range(int(count.max()) if count.numel() else 0):
            yield k < count, p_idx[(p_ptr[:-1] + k).clamp(
                max=p_idx.shape[0] - 1)]

    for ok, e in entries(ptr, ent):
        u, w = v[:, e[:, 1]], v[:, e[:, 2]]
        terms = (u[..., 1] * w[..., 2] - u[..., 2] * w[..., 1],
                 u[..., 2] * w[..., 0] - u[..., 0] * w[..., 2],
                 u[..., 0] * w[..., 1] - u[..., 1] * w[..., 0])
        for i in range(3):
            gv[i] = torch.where(ok, gv[i] + gm * terms[i], gv[i])
    y = v[..., 1]
    anchors = walk.anchor_face.long().tolist()
    bary = walk.anchor_bary.to(dev)

    def anchor_y(a):
        f = walk.faces.long()[anchors[a]]
        return y[:, f[0]] * bary[a, 0] + y[:, f[1]] * bary[a, 1] + y[
            :, f[2]] * bary[a, 2]

    ght = g_out[:, 1] * torch.sign(anchor_y(0) - anchor_y(1))
    for a in range(2):  # the height, with the mass
        wgt = ght if a == 0 else -ght
        for k, f in enumerate(walk.faces.long()[anchors[a]].tolist()):
            gv[1][:, f] = gv[1][:, f] + wgt * bary[a, k]
    # the marked vertices: each plane's hits, summed apart, then added
    hv = [torch.zeros_like(gv[0]) for _ in range(3)]
    rows = torch.arange(B, device=dev)[:, None] * 3
    for p in range(3):
        if walk.counts[p] == 0:
            continue
        first = torch.full((B, walk.counts[p]), -1, dtype=torch.long,
                           device=dev)
        there = torch.zeros((B, walk.counts[p]), dtype=torch.long,
                            device=dev)
        for b in range(B):
            k = int(n[3 * b + p])
            at = pos[3 * b + p, :k]
            there[b].index_add_(0, at, torch.ones_like(at))
            first[b].scatter_reduce_(0, at, torch.arange(k, device=dev),
                                     "amin", include_self=False)
        if walk.plane_csr is None:
            lists = ((ok, e[:, 0]) for ok, e in entries(ptr, ent))
        else:
            p_ptr, p_idx = (t.long() for t in walk.plane_csr)
            lists = entries(p_ptr[p], p_idx)
        for ok, e in lists:
            at, c = e >> 2, e & 3
            for s in range(2):
                use = ok & (s < there[:, at])
                j = (first[:, at] + s).clamp(0, N - 1)
                rec = g9[rows + p, j]  # (B, Vm, 9)
                for i in range(3):
                    val = rec.gather(-1, (3 * c + i).expand(B, -1)[..., None]
                                     )[..., 0]
                    hv[i] = torch.where(use, hv[i] + val, hv[i])
    gv = [g + h for g, h in zip(gv, hv)]
    for a in range(2, 5):  # the plane heights
        for k, f in enumerate(walk.faces.long()[anchors[a]].tolist()):
            gv[1][:, f] = gv[1][:, f] + g_h[:, a - 2] * bary[a, k]
    grad[:, :Vm] = torch.stack(gv, -1)
    return grad


@dataclass
class _Walk:
    """What one K1 launch walks: the mesh's faces (F, 3) and its
    vertex-to-(face, corner) lists, the five anchors (head top, left heel
    and the three planes'), and per plane the number of faces walked
    (``counts``; 0 skips a plane) from ``offsets`` in ``plane_faces``, the
    planes' face-id lists back to back with their own vertex lists
    ``plane_csr``, or all faces in order when ``plane_faces`` is None."""

    faces: torch.Tensor
    face_csr: Tuple[torch.Tensor, torch.Tensor]
    num_mesh_vertices: int
    anchor_face: torch.Tensor
    anchor_bary: torch.Tensor
    counts: Tuple[int, int, int]
    offsets: Tuple[int, int, int] = (0, 0, 0)
    plane_faces: Optional[torch.Tensor] = None
    plane_csr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def measure_backward(meas: "BodyMeasurements", walk: _Walk,
                     vertices: torch.Tensor, saved, g_out: torch.Tensor,
                     g_plane_h: torch.Tensor) -> torch.Tensor:
    """K1's / K1-exact's backward kernels (``measure_backward``, in
    ``meas``' slice mode) on CUDA tensors: the (B, V, 3) gradient of the
    (B, 5) values and (B, 3) plane heights (their cotangents ``g_out``,
    ``g_plane_h``, f32 and contiguous) for a forward over ``walk`` whose
    saves are ``saved`` = (hits, codes, stats, plane_h)."""
    hits, codes, stats, plane_h = saved
    B, V = vertices.shape[:2]
    dev = vertices.device
    half_k = meas.hull_cos.shape[0]
    plane_ptr, plane_idx = walk.plane_csr or (None, None)
    plan = measure_backward_plan(walk.counts, B)

    def scratch(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    grad = scratch(B, V, 3)
    mode = "exact_" if meas.slice_mode == "exact" else ""
    MEASURE_KERNEL.launch(f"measure_{mode}backward", [
        vertices, walk.faces, walk.plane_faces, walk.anchor_face,
        walk.anchor_bary, meas.hull_cos, meas.hull_sin, hits, codes,
        stats, plane_h, g_out, g_plane_h, scratch(B, 3, plan.records, 9),
        scratch(B, 3, plan.words, 2, dtype=torch.int32),
        scratch(B, 3, plan.groups), scratch(B, 3, 8 * half_k + 4),
        scratch(B * (V + 1), dtype=torch.int32),
        scratch(B, V, dtype=torch.int32), *walk.face_csr, plane_ptr,
        plane_idx, grad, B, V, walk.num_mesh_vertices, *walk.offsets,
        *walk.counts, hits.shape[2], *plan, half_k,
        float(np.float32(2.0 * math.pi / (2 * half_k))), meas.density])
    return grad


class PointsPlan(NamedTuple):
    """The work split of K1-AoS's slice-points kernels (from the shape
    alone): ``measure_points`` a block per ``tile`` slots of a (body,
    plane) row, ``tiles`` a row, on grid ``grid`` = (tiles, 3 B);
    ``measure_points_backward`` a block per ``face_tile`` faces of a body
    on ``face_grid`` = (face tiles, B), then a warp a row for the plane
    heights. A row holds ``6 F`` floats of points and ``mask_row`` mask
    bytes (2F in reference mode, F in exact mode)."""

    tile: int
    tiles: int
    grid: Tuple[int, int]
    face_tile: int
    face_grid: Tuple[int, int]
    mask_row: int


def points_plan(B: int, F: int, slice_mode: str,
                tile: int = _POINTS_TILE) -> PointsPlan:
    """The plan of ``measure_points`` and ``measure_points_backward``
    (``csrc/measure.cu``, whose ``kPointsTile`` and ``kFaceTile`` are the
    tile sizes) for B bodies of F triangles; another ``tile`` only for the
    replays."""
    tiles = -(-2 * F // tile)
    return PointsPlan(tile, tiles, (tiles, 3 * B), _FACE_TILE,
                      (-(-F // _FACE_TILE), B),
                      2 * F if slice_mode == "reference" else F)


def _vector_span(lo: int, hi: int, vec: int) -> Tuple[int, int, int, int]:
    """Elements [lo, hi) of an array aligned to ``vec`` elements at 0, as
    ``copy_span`` stores them: (lo, A, E, hi), scalars in [lo, A) and
    [E, hi), vectors of ``vec`` in [A, E)."""
    A = min(hi, -(-lo // vec) * vec)
    return lo, A, max(A, hi // vec * vec), hi


def points_spans(plan: PointsPlan, F: int, row: int, t: int) -> Dict:
    """What block (t, row) of ``measure_points`` stores, in elements of
    the flat points (floats) and masks (bytes): {"points": (lo, A, E,
    hi), "masks": (...)} as :func:`_vector_span` (16-byte vectors)."""
    s0 = t * plan.tile
    s1 = min(2 * F, s0 + plan.tile)
    m0, m1 = (s0, s1) if plan.mask_row == 2 * F else (s0 // 2, s1 // 2)
    return {"points": _vector_span(row * 6 * F + 3 * s0,
                                   row * 6 * F + 3 * s1, 4),
            "masks": _vector_span(row * plan.mask_row + m0,
                                  row * plan.mask_row + m1, 16)}


def face_spans(plan: PointsPlan, F: int, b: int, t: int
               ) -> Tuple[int, int, int, int]:
    """The floats of the flat (B, 3F, 3) triangles that block (t, b) of
    ``measure_points_backward`` loads and whose gradient it stores, as
    :func:`_vector_span` (float4s)."""
    f0 = t * plan.face_tile
    f1 = min(F, f0 + plan.face_tile)
    return _vector_span((b * F + f0) * 9, (b * F + f1) * 9, 4)


def saved_points_plain(triangles: torch.Tensor, plane_h: torch.Tensor,
                       counts: Tuple[int, int, int], slice_mode: str
                       ) -> Tuple[torch.Tensor, ...]:
    """What K1-AoS's forward saves for its slice points, from the plain
    slice of (B, F, 3, 3) ``triangles`` at the (B, 3) plane heights, on
    any device: (vertices (B, 3F, 3), hits, codes (B, 3, 2F), stats (B, 4,
    4), plane_h), the planes whose ``counts`` is 0 with no hit (row 3 of
    stats, the volume, is left 0: the points do not read it)."""
    B, F = triangles.shape[:2]
    verts = triangles.detach().float().reshape(B, 3 * F, 3)
    faces = torch.arange(3 * F, device=verts.device).view(F, 3)
    plane_h = plane_h.detach().float().contiguous()
    hits, codes, rows = _saved_rows_plain(verts, faces, None, plane_h,
                                          slice_mode)
    stats = torch.zeros((B, 4, 4), dtype=torch.float32, device=verts.device)
    stats[:, :3, :3] = rows
    for p, n in enumerate(counts):
        if n == 0:
            hits[:, p], codes[:, p], stats[:, p] = 0, 0, 0
    return verts.contiguous(), hits, codes, stats, plane_h


def _row_hits(saved):
    """The saved hits as (3B, cap) rows: codes with every slot past a
    row's count set above any code (so that a search stops there), hits,
    and the counts."""
    hits, codes, stats = saved[1:4]
    B, _, cap = codes.shape
    n = stats[:, :3, 0].long().reshape(-1)
    j = torch.arange(cap, device=codes.device)
    keys = torch.where(j < n[:, None], codes.reshape(3 * B, cap).long(),
                       torch.iinfo(torch.int64).max)
    return keys, hits.reshape(3 * B, cap, 2), n


def _crossed_y(verts, pos, detail, h):
    """An exact-mode hit's y, recomputed from its crossed edge as
    ``measure_points`` does: verts (N, 3F, 3) of each hit's body, its face
    ``pos``, formula ``detail`` and plane height ``h``."""
    a = detail & 3
    e = torch.where(a == 2, 0, a + 1)
    n = torch.arange(verts.shape[0], device=verts.device)
    ya, ye = verts[n, 3 * pos + a, 1], verts[n, 3 * pos + e, 1]
    sa, se = ya - h, ye - h
    denom = sa - se
    den = torch.where(torch.abs(denom) > 1e-20, denom,
                      torch.full_like(denom, 1e-20))
    return ya + (sa / den) * (ye - ya)


def measure_points_replay(saved, slice_mode: str,
                          plan: Optional[PointsPlan] = None):
    """``measure_points`` tile by tile, as the kernel builds each tile, in
    PyTorch on the saves' device: the fill, then each quad triangle's (or
    the faces') code range from two binary searches (``searchsorted``) of
    the row's codes, the hits placed, the tile stored. ``saved`` starts
    with (vertices, hits, codes, stats, plane_h) of the triangle walk (the
    forward's, or :func:`saved_points_plain`). Returns points (B, 3, 6F)
    and masks (B, 3, 2F) / (B, 3, F)."""
    verts, plane_h = saved[0], saved[4]
    B, F = verts.shape[0], verts.shape[1] // 3
    plan = plan or points_plan(B, F, slice_mode)
    exact = slice_mode == "exact"
    dev = verts.device
    keys, hit_rows, _ = _row_hits(saved)
    h = plane_h.reshape(-1)
    points = torch.empty((3 * B, 2 * F, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((3 * B, plan.mask_row), dtype=torch.bool, device=dev)
    j = torch.arange(keys.shape[1], device=dev)
    for t in range(plan.tiles):
        s0 = t * plan.tile
        s1 = min(2 * F, s0 + plan.tile)
        tile = torch.zeros((3 * B, s1 - s0, 3), dtype=torch.float32,
                           device=dev)
        if not exact:
            tile[..., 1] = h[:, None]
        m0 = s0 if not exact else s0 // 2
        mask = torch.zeros((3 * B, (s1 - s0) // (2 if exact else 1)),
                           dtype=torch.bool, device=dev)
        spans = (((0, max(s0, 0), max(s0, min(s1, F))),
                  (1, max(s0 - F, 0), max(s0 - F, 0, min(s1 - F, F))))
                 if not exact else ((None, s0 // 2, s1 // 2),))
        for q, lo, hi in spans:
            bounds = torch.searchsorted(keys, torch.tensor(
                [[16 * lo, 16 * hi]], device=dev).expand(3 * B, 2)
                .contiguous())
            take = (j >= bounds[:, :1]) & (j < bounds[:, 1:])
            if q is not None:
                take &= ((keys >> 3) & 1) == q
            r, k = take.nonzero(as_tuple=True)
            code = keys[r, k]
            pos, detail = code >> 4, code & 15
            hit = hit_rows[r, k]
            if exact:
                ls = 2 * pos + (detail >> 2) - s0
                y = _crossed_y(verts[r // 3], pos, detail, h[r])
                tile[r, ls] = torch.stack([hit[:, 0], y, hit[:, 1]], -1)
                mask[r, pos - m0] = True
            else:
                ls = q * F + pos - s0
                tile[r, ls, 0], tile[r, ls, 2] = hit[:, 0], hit[:, 1]
                mask[r, ls] = True
        points[:, s0:s1] = tile
        valid[:, m0:m0 + mask.shape[1]] = mask
    return (points.reshape(B, 3, 6 * F),
            valid.reshape(B, 3, plan.mask_row))


def measure_points_backward_replay(saved, g_points: torch.Tensor,
                                   counts: Tuple[int, int, int],
                                   slice_mode: str,
                                   plan: Optional[PointsPlan] = None):
    """``measure_points_backward`` in its operations and order, in PyTorch
    on the saves' device: each hit's VJP (``hit_vjp``, through its
    recomputed y in exact mode) summed per face over the planes in plane
    order and each face's hits in code order; per (face, plane) the
    plane-height cotangent of its hits, then in reference mode the
    y-cotangents of slots f and F + f; ``block_sum``'s tree over each
    block of ``face_tile`` faces, then each row's blocks in a warp's
    order (lane l over blocks l, l + 32, ..., then the shuffle tree).
    Returns the (B, 3F, 3) gradient and the (B, 3) plane heights'
    cotangent: the kernel's bits on the card (it recomputes the same hits
    from the triangles where the masks hold one)."""
    verts, plane_h = saved[0], saved[4]
    B, F = verts.shape[0], verts.shape[1] // 3
    plan = plan or points_plan(B, F, slice_mode)
    exact = slice_mode == "exact"
    dev = verts.device
    g_points = g_points.detach().float().reshape(B, 3, 2 * F, 3)
    keys, _, n = _row_hits(saved)
    j = torch.arange(keys.shape[1], device=dev)
    g9 = torch.zeros((B, F, 9), dtype=torch.float32, device=dev)
    s = torch.zeros((B, 3, F), dtype=torch.float32, device=dev)
    for p in range(3):
        if counts[p] == 0:
            continue
        gh = torch.zeros((B, F), dtype=torch.float32, device=dev)
        rows = torch.arange(B, device=dev) * 3 + p
        k_rows = keys[rows]
        live = j < n[rows, None]
        # a face's second hit follows its first at the same position
        second = torch.zeros_like(live)
        second[:, 1:] = live[:, 1:] & ((k_rows[:, 1:] >> 4)
                                       == (k_rows[:, :-1] >> 4))
        for k in (0, 1):
            b, jj = (live & (second == bool(k))).nonzero(as_tuple=True)
            code = k_rows[b, jj]
            pos, detail = code >> 4, code & 15
            slot = (2 * pos + (detail >> 2) if exact
                    else (detail >> 3) * F + pos)
            gs = g_points[b, p, slot]
            xyz = verts[b[:, None], 3 * pos[:, None] + torch.arange(
                3, device=dev)].permute(2, 1, 0)
            gv, ghit = _hit_vjp_replay(xyz, plane_h[b, p], detail,
                                       gs[:, 0], gs[:, 2], exact,
                                       gs[:, 1] if exact else None)
            g9[b, pos] = g9[b, pos] + gv
            gh[b, pos] = gh[b, pos] + ghit
        s[:, p] = gh
        if not exact:
            s[:, p] = s[:, p] + g_points[:, p, :F, 1]
            s[:, p] = s[:, p] + g_points[:, p, F:, 1]
    tiles = plan.face_grid[0]
    padded = torch.zeros((B, 3, tiles * plan.face_tile),
                         dtype=torch.float32, device=dev)
    padded[..., :F] = s
    partial = _block_sum_replay(padded.reshape(B, 3, tiles, plan.face_tile))
    lanes = torch.zeros((B, 3, 32), dtype=torch.float32, device=dev)
    for i in range(0, tiles, 32):
        m = min(32, tiles - i)
        lanes[..., :m] = lanes[..., :m] + partial[..., i:i + m]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes[..., :o] + lanes[..., o:2 * o]
    return g9.reshape(B, 3 * F, 3), lanes[..., 0]


def measure_points(saved, slice_mode: str):
    """K1-AoS's ``measure_points`` (one launch) on CUDA tensors: the (B, 3,
    6F) slice points and (B, 3, 2F) / (B, 3, F) masks from the triangle
    walk's saves (vertices (B, 3F, 3), hits, codes, stats, plane_h), as
    :class:`_MeasureKernel`'s forward launches it."""
    verts, hits, codes, stats, plane_h = saved[:5]
    B, F = verts.shape[0], verts.shape[1] // 3
    plan = points_plan(B, F, slice_mode)
    points = torch.empty((B, 3, 6 * F), dtype=torch.float32,
                         device=verts.device)
    valid = torch.empty((B, 3, plan.mask_row), dtype=torch.bool,
                        device=verts.device)
    if B > 0:
        MEASURE_KERNEL.launch("measure_points", [
            verts, hits, codes, stats, plane_h, points, valid, B, F,
            codes.shape[2], plan.tile, plan.tiles,
            int(slice_mode == "exact")])
    return points, valid


def measure_points_backward(saved, g_points: torch.Tensor,
                            counts: Tuple[int, int, int], slice_mode: str):
    """K1-AoS's ``measure_points_backward`` (two launches) on CUDA
    tensors: the (B, 3F, 3) gradient of the slice points, whose cotangent
    is ``g_points`` (B, 3, 6F), through their crossed edges, and the (B,
    3) plane heights' cotangent, for a forward over the planes whose
    ``counts`` is F whose saves are ``saved`` (vertices, hits, codes,
    stats, plane_h, and the masks ``measure_points`` wrote)."""
    verts, plane_h, valid = saved[0], saved[4], saved[5]
    if verts.data_ptr() % 16:  # the kernel stages 16-byte vectors
        verts = verts.clone()
    B, F = verts.shape[0], verts.shape[1] // 3
    plan = points_plan(B, F, slice_mode)
    check_cuda_input(valid, "valid", torch.bool, (B, 3, plan.mask_row),
                     verts.device)
    dev = verts.device
    grad = torch.empty((B, 3 * F, 3), dtype=torch.float32, device=dev)
    g_h = torch.empty((B, 3), dtype=torch.float32, device=dev)
    MEASURE_KERNEL.launch("measure_points_backward", [
        verts, valid, plane_h, g_points.float().contiguous(), grad,
        torch.empty((B, 3, plan.face_grid[0]), dtype=torch.float32,
                    device=dev), g_h, B, F, plan.face_tile,
        plan.face_grid[0], *counts, int(slice_mode == "exact")])
    return grad, g_h


class _MeasureKernel(torch.autograd.Function):
    """Kernel K1 (reference mode) or K1-exact, forward and backward, and
    with ``with_points`` the slice points of K1-AoS (``measure_points``).

    The forward saves each plane's hits in face order with the formula
    that made each, the hit counts, centroids and the signed volume; the
    backward kernels differentiate those formulas (see ``measure.cu``).
    Returns (B, 5) values and (B, 3) plane heights, then with
    ``with_points`` the (B, 3, 6F) points, differentiable through
    ``measure_points_backward``, and the (B, 3, 2F) (exact mode: (B, 3,
    F)) masks."""

    @staticmethod
    def forward(ctx, vertices, meas, walk, with_points):
        exact = meas.slice_mode == "exact"
        mode = "exact_" if exact else ""
        B, V, _ = vertices.shape
        F = walk.faces.shape[0]
        half_k = meas.hull_cos.shape[0]
        dev = vertices.device
        check_cuda_input(vertices, "vertices", torch.float32, (B, V, 3), dev)
        for name, t in (("faces", walk.faces),
                        ("anchor_face", walk.anchor_face),
                        ("anchor_bary", walk.anchor_bary),
                        ("hull_cos", meas.hull_cos),
                        ("hull_sin", meas.hull_sin)):
            check_cuda_input(t, name, t.dtype, tuple(t.shape), dev)
        if with_points and (walk.plane_faces is not None or V != 3 * F):
            raise ValueError("slice points need the triangle walk over all "
                             "faces")
        if walk.plane_faces is not None:
            check_cuda_input(walk.plane_faces, "plane_faces", torch.int32,
                             (None,), dev)
        smax = max(max(walk.counts), 1)
        cap = 2 * smax
        angle_step = float(np.float32(2.0 * math.pi / (2 * half_k)))
        planes = (*walk.offsets, *walk.counts)

        def empty(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device=dev)

        plan = measure_plan(walk.counts, F, B)
        hits, codes = empty(B, 3, cap, 2), empty(B, 3, cap, dtype=torch.int32)
        stats, out, plane_h = empty(B, 4, 4), empty(B, 5), empty(B, 3)
        if B > 0:
            MEASURE_KERNEL.launch(f"measure_{mode}forward", [
                vertices, walk.faces, walk.plane_faces, walk.anchor_face,
                walk.anchor_bary, meas.hull_cos, meas.hull_sin, hits, codes,
                torch.empty_like(hits), torch.empty_like(codes), stats, out,
                plane_h, B, V, F, *planes, cap, half_k, angle_step,
                meas.density, plan.cluster, *plan.spans, plan.mass_span])
        outs, saved = (out, plane_h), (vertices, hits, codes, stats, plane_h)
        if with_points:  # the triangle walk: V = 3F, all faces
            points, valid = measure_points(saved, meas.slice_mode)
            ctx.mark_non_differentiable(valid)
            outs += (points, valid)
            saved += (valid,)  # where the points' backward finds hits
        ctx.set_materialize_grads(False)
        ctx.meas, ctx.walk, ctx.mode = meas, walk, mode
        ctx.save_for_backward(*saved)
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out, g_plane_h, g_points=None, _=None):
        saved = ctx.saved_tensors
        vertices, hits, codes, stats, plane_h = saved[:5]
        meas, walk = ctx.meas, ctx.walk
        B, V = vertices.shape[:2]
        dev = vertices.device

        def cotangent(g, shape):
            return (torch.zeros(shape, dtype=torch.float32, device=dev)
                    if g is None else g.float().contiguous())

        g_out = cotangent(g_out, (B, 5))
        g_plane_h = cotangent(g_plane_h, (B, 3))
        if B == 0:
            return vertices.new_empty((B, V, 3)), None, None, None
        grad_points = None
        if g_points is not None:  # the triangle walk: V = 3F, all faces
            grad_points, g_h = measure_points_backward(
                saved, g_points, walk.counts, meas.slice_mode)
            g_plane_h = g_plane_h + g_h
        grad = measure_backward(meas, walk, vertices,
                                (hits, codes, stats, plane_h), g_out,
                                g_plane_h)
        if grad_points is not None:
            grad = grad + grad_points
        return grad, None, None, None


class BodyMeasurements(nn.Module):
    """Batched virtual measurements on one mesh topology.

    ``faces`` (F, 3), the optional per-plane ``face_subsets`` (from
    :func:`candidate_faces`) and the vertex-to-face lists of the backward
    kernel become non-persistent device buffers, so ``.to(device)`` moves
    them with the regressor. Without ``anchors`` they are read from the
    reference's YAMLs for ``model_type`` (:meth:`MeasurementAnchors
    .from_yaml`).

    Two entries: :meth:`forward_from_vertices` on (B, V, 3) vertices of
    this topology, and :meth:`forward` on (B, F', 3, 3) triangles of any
    mesh whose F' faces hold the anchors' faces.
    """

    def __init__(
        self,
        anchors: Optional[MeasurementAnchors],
        faces: np.ndarray,
        num_hull_directions: int = 256,
        density: float = DENSITY,
        slice_mode: str = "reference",
        face_subsets: Optional[Dict[str, np.ndarray]] = None,
        model_type: str = "smplx",
        meas_definition_path: Optional[str] = None,
        meas_vertices_path: Optional[str] = None,
    ):
        super().__init__()
        if anchors is None:
            anchors = MeasurementAnchors.from_yaml(
                meas_definition_path or DEFAULT_DEFINITIONS,
                meas_vertices_path, model_type)
        if slice_mode not in ("reference", "exact"):
            raise ValueError(f"unknown slice_mode: {slice_mode!r}")
        if num_hull_directions > _MAX_HULL_DIRECTIONS:
            raise ValueError(f"at most {_MAX_HULL_DIRECTIONS} hull "
                             "directions")
        self.anchors = anchors
        self.num_hull_directions = num_hull_directions
        self.density = density
        self.slice_mode = slice_mode

        def buf(name, value, dtype):
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(value), dtype=dtype), persistent=False)

        # The kernels index with these ids unchecked: validate them once.
        faces = np.asarray(faces)
        F = faces.shape[0]
        self.num_mesh_vertices = int(faces.max()) + 1
        ids = [a.face_idx for a in anchors.ordered()]
        for sub in (face_subsets or {}).values():
            ids.extend(np.asarray(sub).tolist())
        if faces.min() < 0 or min(ids) < 0 or max(ids) >= F:
            raise ValueError("face or anchor index out of range")
        buf("faces", faces, torch.int32)
        ordered = anchors.ordered()
        buf("anchor_face", [a.face_idx for a in ordered], torch.int32)
        buf("anchor_bary", [a.bary for a in ordered], torch.float32)
        cos, sin = hull_directions(num_hull_directions)
        self.register_buffer("hull_cos", cos, persistent=False)
        self.register_buffer("hull_sin", sin, persistent=False)
        ptr, idx = vertex_corner_lists(faces, self.num_mesh_vertices, True)
        buf("face_csr_ptr", ptr, torch.int32)
        buf("face_csr_idx", idx, torch.int32)
        self.has_subsets = face_subsets is not None
        subs = [np.asarray(face_subsets[n] if self.has_subsets else
                           np.zeros(0), np.int64) for n in PLANES]
        for name, sub in zip(PLANES, subs):
            buf(f"subset_{name}", sub, torch.int32)
        self.subset_counts = tuple(len(s) for s in subs)
        buf("subset_faces", np.concatenate(subs), torch.int32)
        lists = [vertex_corner_lists(faces[s], self.num_mesh_vertices)
                 for s in subs]
        starts = np.cumsum([0] + [len(i) for _, i in lists[:-1]])
        buf("subset_csr_ptr", np.stack([p + s for (p, _), s in
                                        zip(lists, starts)]), torch.int32)
        buf("subset_csr_idx", np.concatenate([i for _, i in lists]),
            torch.int32)
        # K1-AoS: the identity topology per (F, device) and the anchor
        # buffers per (anchors, device), built at first use.
        self._triangle_topology: Dict = {}
        self._triangle_anchors: Dict = {}

    def measure(self, vertices: torch.Tensor, use_face_subsets: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, V, 3) vertices -> (B, 5) [mass, height, chest, waist, hips]
        and (B, 3) plane heights, differentiable in ``vertices``: kernel
        K1 / K1-exact for CUDA tensors, :func:`measure_plain` for CPU
        tensors."""
        if vertices.shape[1] < self.num_mesh_vertices:
            raise ValueError(f"{vertices.shape[1]} vertices for a mesh of "
                             f"{self.num_mesh_vertices}")
        use_subsets = use_face_subsets and self.has_subsets
        if vertices.device.type == "cpu":
            plane_faces = ([getattr(self, f"subset_{n}") for n in PLANES]
                           if use_subsets else None)
            return measure_plain(vertices, self.faces, plane_faces,
                                 self.anchors, self.num_hull_directions,
                                 self.density, self.slice_mode)
        if vertices.device.type != "cuda":
            raise ValueError(f"measure: unsupported device {vertices.device}")
        return _MeasureKernel.apply(vertices.contiguous(), self,
                                    self._vertex_walk(use_subsets), False)

    def _vertex_walk(self, use_subsets: bool) -> _Walk:
        """K1's walk over this topology: all faces, or the planes' face
        subsets where asked for and built."""
        F = self.faces.shape[0]
        walk = _Walk(self.faces, (self.face_csr_ptr, self.face_csr_idx),
                     self.num_mesh_vertices, self.anchor_face,
                     self.anchor_bary, (F, F, F))
        if use_subsets and self.has_subsets:
            c = self.subset_counts
            walk.counts, walk.offsets = c, (0, c[0], c[0] + c[1])
            walk.plane_faces = self.subset_faces
            walk.plane_csr = (self.subset_csr_ptr, self.subset_csr_idx)
        return walk

    def forward_from_vertices(self, vertices: torch.Tensor,
                              use_face_subsets: bool = True
                              ) -> Dict[str, Dict[str, torch.Tensor]]:
        """All measurements from (B, V, 3) vertices.

        ``use_face_subsets=False`` walks all faces: the subsets are exact
        only for bodies inside the beta bound they were built for.

        Returns {'measurements': {'mass': {'tensor'}, 'height':
        {'tensor'}, 'chest'|'waist'|'hips': {'tensor', 'plane_height'}}}.
        """
        vals, heights = self.measure(vertices, use_face_subsets)
        out: Dict[str, Dict[str, torch.Tensor]] = {
            "mass": {"tensor": vals[:, 0]},
            "height": {"tensor": vals[:, 1]},
        }
        for p, name in enumerate(PLANES):
            out[name] = {"tensor": vals[:, 2 + p],
                         "plane_height": heights[:, p]}
        return {"measurements": out}

    # -- the triangle (array-of-structures) surface -------------------------
    def forward(self, triangles: torch.Tensor, compute_mass: bool = True,
                compute_height: bool = True, compute_chest: bool = True,
                compute_waist: bool = True, compute_hips: bool = True
                ) -> Dict[str, Dict[str, Dict[str, torch.Tensor]]]:
        """The measurements of (B, F, 3, 3) triangles (e.g. ``v[:,
        faces]``), those whose flag is set.

        Returns {'measurements': {'mass': {'tensor'}, 'height': {'tensor',
        'points' (2, B, 3): head top and left heel}, 'chest'|'waist'|'hips':
        {'tensor', 'plane_height', 'points', 'valid_points'}}}: the slice
        points are (B, 2F, 3) with a (B, 2F) mask in reference mode (y the
        plane height on every entry) and (B, F, 2, 3) with a (B, F) mask in
        exact mode (zero where invalid).

        Differentiable in ``triangles`` through the values, plane heights,
        height points and slice points, as the JAX package's are (a
        point's gradient goes to its crossed edge's endpoints, or the
        triangle of its quad-edge cast, and through the plane height to
        the anchor triangle); ``valid_points`` is a mask. CUDA tensors run
        kernel K1-AoS (the points' gradient through
        ``measure_points_backward``), CPU tensors :meth:`forward_plain`."""
        return {"measurements": self._measure_triangles(
            triangles, compute_mass, compute_height,
            self._planes(compute_chest, compute_waist, compute_hips))}

    def forward_plain(self, triangles: torch.Tensor,
                      compute_mass: bool = True, compute_height: bool = True,
                      compute_chest: bool = True, compute_waist: bool = True,
                      compute_hips: bool = True
                      ) -> Dict[str, Dict[str, Dict[str, torch.Tensor]]]:
        """:meth:`forward` through the plain version on any device: the
        JAX package's array-of-structures operations in PyTorch."""
        return {"measurements": self._triangles_plain(
            triangles, compute_mass, compute_height,
            self._planes(compute_chest, compute_waist, compute_hips))}

    def compute_mass(self, triangles: torch.Tensor) -> torch.Tensor:
        """(B, F, 3, 3) -> (B,) mass in kg."""
        return self._measure_triangles(triangles, True, False,
                                       {})["mass"]["tensor"]

    def compute_height(self, triangles: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, F, 3, 3) -> (B,) height in m and the (2, B, 3) head-top and
        left-heel points."""
        out = self._measure_triangles(triangles, False, True, {})["height"]
        return out["tensor"], out["points"]

    def compute_periphery(self, triangles: torch.Tensor, anchor: Anchor
                          ) -> Dict[str, torch.Tensor]:
        """The circumference of the horizontal slice at ``anchor``'s
        height: {'tensor', 'plane_height', 'points', 'valid_points'}."""
        return self._measure_triangles(triangles, False, False,
                                       {"plane": anchor})["plane"]

    def compute_peripheries(self, triangles: torch.Tensor,
                            compute_chest: bool = True,
                            compute_waist: bool = True,
                            compute_hips: bool = True
                            ) -> Dict[str, Dict[str, torch.Tensor]]:
        return self._measure_triangles(
            triangles, False, False,
            self._planes(compute_chest, compute_waist, compute_hips))

    def periphery_exact_np(self, triangles, anchor_name: str) -> np.ndarray:
        """The exact (scipy hull, f64) circumference at anchor
        ``anchor_name`` of each of the (B, F, 3, 3) triangles, on the host
        from the plain slice in f32."""
        anchor: Anchor = getattr(self.anchors, anchor_name)
        tris = torch.as_tensor(triangles).detach().to("cpu", torch.float32)
        plane_h = _anchor_point(tris, anchor)[..., 1]
        if self.slice_mode == "reference":
            pts, valid = plane_slice_reference(tris, plane_h)
        else:
            pts, valid = plane_slice_triangles(tris, plane_h)
        pts, valid = pts.numpy(), valid.numpy()
        return np.asarray([hull_perimeter_exact_np(
            pts[b][valid[b]].reshape(-1, 3)[:, [0, 2]])
            for b in range(pts.shape[0])])

    def _planes(self, *on: bool) -> Dict[str, Anchor]:
        """The chest, waist and hips anchors whose flag is set."""
        return {name: getattr(self.anchors, name)
                for name, o in zip(PLANES, on) if o}

    def _measure_triangles(self, triangles: torch.Tensor, mass: bool,
                           height: bool, planes: Dict[str, Anchor]) -> Dict:
        if triangles.device.type == "cpu":
            return self._triangles_plain(triangles, mass, height, planes)
        if triangles.device.type != "cuda":
            raise ValueError(f"forward: unsupported device {triangles.device}")
        return self._triangles_kernel(triangles, mass, height, planes)

    def _triangles_plain(self, triangles: torch.Tensor, mass: bool,
                         height: bool, planes: Dict[str, Anchor]) -> Dict:
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        if mass:
            out["mass"] = {"tensor": signed_volume(triangles) * self.density}
        if height:
            head = _anchor_point(triangles, self.anchors.head_top)
            heel = _anchor_point(triangles, self.anchors.left_heel)
            out["height"] = {"tensor": torch.abs(head[..., 1] - heel[..., 1]),
                             "points": torch.stack([head, heel])}
        B = triangles.shape[0]
        for name, anchor in planes.items():
            plane_h = _anchor_point(triangles, anchor)[..., 1]
            if self.slice_mode == "reference":
                points, valid = plane_slice_reference(triangles, plane_h)
                flat, flat_mask = points, valid
            else:
                points, valid = plane_slice_triangles(triangles, plane_h)
                flat = points.reshape(B, -1, 3)
                flat_mask = torch.repeat_interleave(valid, 2, dim=-1)
            out[name] = {
                "tensor": hull_perimeter_support(
                    flat[..., [0, 2]], flat_mask, self.num_hull_directions),
                "plane_height": plane_h, "points": points,
                "valid_points": valid}
        return out

    def _triangle_walk(self, F: int, device: torch.device,
                       anchors: Tuple[Anchor, ...],
                       counts: Tuple[int, int, int]) -> _Walk:
        """K1's walk over all faces of F triangles as (3F, 3) vertices with
        the faces (3f, 3f + 1, 3f + 2)."""
        if max(a.face_idx for a in anchors) >= F:
            raise ValueError(f"anchor face beyond the {F} triangles")
        # Cached across calls, so made as normal tensors even under
        # inference_mode: a later call that records a graph saves the
        # barycentrics for the height points' backward.
        topo = self._triangle_topology.get((F, device))
        if topo is None:
            faces = np.arange(3 * F, dtype=np.int64).reshape(F, 3)
            with torch.inference_mode(False):
                topo = tuple(
                    torch.as_tensor(a, dtype=torch.int32).to(device)
                    for a in (faces,
                              *vertex_corner_lists(faces, 3 * F, True)))
            self._triangle_topology[(F, device)] = topo
        anc = self._triangle_anchors.get((anchors, device))
        if anc is None:
            with torch.inference_mode(False):
                anc = (torch.tensor([a.face_idx for a in anchors],
                                    dtype=torch.int32, device=device),
                       torch.tensor([a.bary for a in anchors],
                                    dtype=torch.float32, device=device))
            self._triangle_anchors[(anchors, device)] = anc
        return _Walk(topo[0], topo[1:], 3 * F, *anc, counts)

    def _triangles_kernel(self, triangles: torch.Tensor, mass: bool,
                          height: bool, planes: Dict[str, Anchor]) -> Dict:
        """Kernel K1-AoS; the plane slots that ``planes`` leaves free walk
        no faces."""
        B, F = triangles.shape[:2]
        named = list(planes.items())
        anchors = (self.anchors.head_top, self.anchors.left_heel,
                   *(a for _, a in named),
                   *(getattr(self.anchors, n) for n in PLANES[len(named):]))
        counts = tuple(F if p < len(named) else 0 for p in range(3))
        walk = self._triangle_walk(F, triangles.device, anchors, counts)
        tri = triangles.contiguous()
        res = _MeasureKernel.apply(tri.view(B, 3 * F, 3), self, walk,
                                   bool(named))
        vals, plane_h = res[0], res[1]
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        if mass:
            out["mass"] = {"tensor": vals[:, 0]}
        if height:  # barycentrics from the cached buffer: no host copy
            out["height"] = {"tensor": vals[:, 1], "points": torch.stack(
                [face_barycentric_point(tri, a.face_idx, walk.anchor_bary[i])
                 for i, a in enumerate(anchors[:2])])}
        shape = (B, 2 * F, 3) if self.slice_mode == "reference" else \
            (B, F, 2, 3)
        for p, (name, _) in enumerate(named):
            out[name] = {"tensor": vals[:, 2 + p],
                         "plane_height": plane_h[:, p],
                         "points": res[2][:, p].view(shape),
                         "valid_points": res[3][:, p]}
        return out
