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

``Anchor``, ``MeasurementAnchors`` and ``candidate_faces`` are numpy,
copied from the JAX package (whose module imports jax and yaml); the
anchor YAMLs are read by :mod:`shapy_tpu_torch.utils.yaml_subset`.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from shapy_tpu_torch.ops.convex_hull import (
    hull_directions,
    hull_perimeter_support_xz,
)
from shapy_tpu_torch.ops.plane_slice import (
    plane_slice_reference_soa,
    plane_slice_soa,
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

_FORWARD_ARGS = "pppp ppp ppp pp iii iii iii ii ff p"
_BACKWARD_ARGS = "pppp ppp pppp ppp pppp ppp iii iii iii iii ff p"
MEASURE_KERNEL = CudaKernel("measure.cu", {
    "measure_forward": _FORWARD_ARGS,
    "measure_exact_forward": _FORWARD_ARGS,
    "measure_backward": _BACKWARD_ARGS,
    "measure_exact_backward": _BACKWARD_ARGS,
})
_MAX_HULL_DIRECTIONS = 1024  # the kernels give each thread 2 pairs


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


def vertex_corner_lists(faces: np.ndarray, num_vertices: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """For each vertex, its (position * 4 + corner) entries in ``faces``
    (P, 3), in position order, as CSR: ptr (num_vertices + 1,) and idx
    (3P,), int32. The backward kernel sums each vertex's gradient over
    these in this fixed order."""
    flat = np.asarray(faces, np.int64).reshape(-1)
    order = np.argsort(flat, kind="stable")  # position * 3 + corner
    ptr = np.zeros(num_vertices + 1, np.int64)
    np.cumsum(np.bincount(flat, minlength=num_vertices), out=ptr[1:])
    idx = (order // 3) * 4 + order % 3
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
        bc = torch.tensor(anchor.bary, dtype=ty.dtype, device=ty.device)
        return torch.sum(ty[..., :, anchor.face_idx] * bc, dim=-1)

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


def saved_centroids(vals: torch.Tensor) -> torch.Tensor:
    """The (B, 3, 2) slice centroids that kernel K1 / K1-exact computed
    for ``vals``, the first output of a :meth:`BodyMeasurements.measure`
    call that records a graph, as saved for its backward."""
    return vals.grad_fn.saved_tensors[3][:, :3, 1:3]


class _MeasureKernel(torch.autograd.Function):
    """Kernel K1 (reference mode) or K1-exact, forward and backward.

    The forward saves each plane's hits in face order with the formula
    that made each, the hit counts, centroids and the signed volume; the
    backward kernels differentiate those formulas (see ``measure.cu``)."""

    @staticmethod
    def forward(ctx, vertices, meas, use_face_subsets):
        mode = "" if meas.slice_mode == "reference" else "exact_"
        B, V, _ = vertices.shape
        F = meas.faces.shape[0]
        half_k = meas.hull_cos.shape[0]
        dev = vertices.device
        check_cuda_input(vertices, "vertices", torch.float32, (B, V, 3), dev)
        for name in ("faces", "anchor_face", "anchor_bary", "hull_cos",
                     "hull_sin"):
            t = getattr(meas, name)
            check_cuda_input(t, name, t.dtype, tuple(t.shape), dev)
        if use_face_subsets:
            flat = meas.subset_faces
            counts = [int(c) for c in meas.subset_counts]
            offsets = [0, counts[0], counts[0] + counts[1]]
            check_cuda_input(flat, "subset_faces", torch.int32, (None,), dev)
        else:
            flat, counts, offsets = None, [F] * 3, [0] * 3
        smax = max(max(counts), 1)
        cap = 2 * smax
        angle_step = float(np.float32(2.0 * math.pi / (2 * half_k)))
        planes = (*offsets, *counts)

        def empty(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device=dev)

        hits, codes = empty(B, 3, cap, 2), empty(B, 3, cap, dtype=torch.int32)
        stats, out, plane_h = empty(B, 4, 4), empty(B, 5), empty(B, 3)
        if B > 0:
            MEASURE_KERNEL.launch(f"measure_{mode}forward", [
                vertices, meas.faces, flat, meas.anchor_face,
                meas.anchor_bary, meas.hull_cos, meas.hull_sin, hits, codes,
                stats, out, plane_h, B, V, F, *planes, cap, half_k,
                angle_step, meas.density])
        ctx.meas, ctx.mode, ctx.flat = meas, mode, flat
        ctx.scalars = (B, V, planes, cap, smax, half_k, angle_step)
        ctx.use_face_subsets = use_face_subsets
        ctx.save_for_backward(vertices, hits, codes, stats, plane_h)
        return out, plane_h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out, g_plane_h):
        vertices, hits, codes, stats, plane_h = ctx.saved_tensors
        meas = ctx.meas
        B, V, planes, cap, smax, half_k, angle_step = ctx.scalars
        dev = vertices.device
        g_out = g_out.float().contiguous()
        g_plane_h = g_plane_h.float().contiguous()
        grad = torch.empty((B, V, 3), dtype=torch.float32, device=dev)
        if B == 0:
            return grad, None, None
        if ctx.use_face_subsets:
            plane_ptr, plane_idx = meas.subset_csr_ptr, meas.subset_csr_idx
        else:
            plane_ptr = plane_idx = None
        MEASURE_KERNEL.launch(f"measure_{ctx.mode}backward", [
            vertices, meas.faces, ctx.flat, meas.anchor_face,
            meas.anchor_bary, meas.hull_cos, meas.hull_sin, hits, codes,
            stats, plane_h, g_out, g_plane_h,
            torch.empty((B, 3, cap, 2), dtype=torch.float32, device=dev),
            torch.empty((B, 3, smax), dtype=torch.int32, device=dev),
            torch.empty((B, 3), dtype=torch.float32, device=dev),
            meas.face_csr_ptr, meas.face_csr_idx, plane_ptr, plane_idx, grad,
            B, V, meas.num_mesh_vertices, *planes, cap, smax, half_k,
            angle_step, meas.density])
        return grad, None, None


class BodyMeasurements(nn.Module):
    """Batched virtual measurements on one mesh topology.

    ``faces`` (F, 3), the optional per-plane ``face_subsets`` (from
    :func:`candidate_faces`) and the vertex-to-face lists of the backward
    kernel become non-persistent device buffers, so ``.to(device)`` moves
    them with the regressor. Without ``anchors`` they are read from the
    reference's YAMLs for ``model_type`` (:meth:`MeasurementAnchors
    .from_yaml`).
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
        ptr, idx = vertex_corner_lists(faces, self.num_mesh_vertices)
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
        return _MeasureKernel.apply(vertices.contiguous(), self, use_subsets)

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
