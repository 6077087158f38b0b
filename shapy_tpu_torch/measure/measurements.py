"""Virtual anthropometric measurements (port of
``shapy_tpu/measure/measurements.py``).

  * mass   = |signed mesh volume| x 985 kg/m^3,
  * height = |y(head top) - y(left heel)| at face + barycentric anchors,
  * chest / waist / hips = slice the mesh with the horizontal plane at an
    anchor's height, then take the convex-hull perimeter of the (x, z)
    slice points.

``BodyMeasurements.forward_from_vertices`` in the default "reference"
slice mode goes through :func:`measure_reference`, whose CUDA path is
kernel K1 (``csrc/measure.cu``, forward only); its plain version is the
structure-of-arrays pipeline of the JAX package in PyTorch. The "exact"
slice mode runs plain PyTorch on every device for now.

``Anchor``, ``MeasurementAnchors.synthetic`` and ``candidate_faces`` are
numpy, copied from the JAX package (whose module imports jax and yaml).
Loading the reference's anchor YAMLs is not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
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
from shapy_tpu_torch.utils.cuda_kernels import CudaKernel, check_cuda_input

# Average human body density, kg/m^3.
DENSITY = 985.0
PLANES = ("chest", "waist", "hips")

MEASURE_KERNEL = CudaKernel(
    "measure.cu",
    {"measure_forward": "pppp ppp ppp iii iii iii ii ff p"},
)
_MAX_HULL_DIRECTIONS = 1024  # the kernel gives each thread 2 pairs


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1 (and the exact slice mode).

    vertices (B, V, 3) f32; faces (F, 3) int; plane_faces one (N_p,) face
    id list per plane, or None for all F faces.

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
        cols.append(hull_perimeter_support_xz(xs, zs, m,
                                              num_hull_directions))
        heights.append(plane_h)
    return torch.stack(cols, dim=-1), torch.stack(heights, dim=-1)


def measure_reference(
    vertices: torch.Tensor,
    faces: torch.Tensor,
    plane_faces: Optional[List[torch.Tensor]],
    anchors: MeasurementAnchors,
    anchor_face: torch.Tensor,
    anchor_bary: torch.Tensor,
    hull_cos: torch.Tensor,
    hull_sin: torch.Tensor,
    density: float = DENSITY,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference-mode measurements: :func:`measure_plain` for CPU tensors
    (differentiable), kernel K1 for CUDA tensors (forward only: its
    backward raises, see ``_MeasureReference``).

    ``anchor_face`` (5,) int32 and ``anchor_bary`` (5, 3) f32 carry
    ``anchors.ordered()`` for the kernel; ``hull_cos`` / ``hull_sin``
    (K/2,) are :func:`hull_directions`. On the card ``faces`` is (F, 3)
    int32 and each ``plane_faces`` entry int32."""
    num_hull_directions = 2 * hull_cos.shape[0]
    if vertices.device.type == "cpu":
        return measure_plain(vertices, faces, plane_faces, anchors,
                             num_hull_directions, density)
    if vertices.device.type != "cuda":
        raise ValueError(f"measure: unsupported device {vertices.device}")
    if num_hull_directions > _MAX_HULL_DIRECTIONS:
        raise ValueError(f"measure: at most {_MAX_HULL_DIRECTIONS} hull "
                         "directions")
    B, V, _ = vertices.shape
    F = faces.shape[0]
    half_k = num_hull_directions // 2
    dev = vertices.device
    check_cuda_input(vertices, "vertices", torch.float32, (B, V, 3), dev)
    check_cuda_input(faces, "faces", torch.int32, (F, 3), dev)
    check_cuda_input(anchor_face, "anchor_face", torch.int32, (5,), dev)
    check_cuda_input(anchor_bary, "anchor_bary", torch.float32, (5, 3), dev)
    check_cuda_input(hull_cos, "hull_cos", torch.float32, (half_k,), dev)
    check_cuda_input(hull_sin, "hull_sin", torch.float32, (half_k,), dev)
    if plane_faces is None:
        flat, counts, offsets = None, [F] * 3, [0] * 3
    else:
        for p, ids in enumerate(plane_faces):
            check_cuda_input(ids, f"plane_faces[{p}]", torch.int32,
                             (None,), dev)
        counts = [int(ids.shape[0]) for ids in plane_faces]
        offsets = [0, counts[0], counts[0] + counts[1]]
        flat = torch.cat(plane_faces)
    cap = 2 * max(max(counts), 1)
    return _MeasureReference.apply(
        vertices, faces, flat, anchor_face, anchor_bary, hull_cos, hull_sin,
        (B, V, F, *offsets, *counts, cap, half_k,
         float(np.float32(2.0 * math.pi / num_hull_directions)),
         float(density)))


class _MeasureReference(torch.autograd.Function):
    """Kernel K1, forward only: reached by autograd only when a loss
    weighs a measurement, and then it raises."""

    @staticmethod
    def forward(ctx, vertices, faces, flat, anchor_face, anchor_bary,
                hull_cos, hull_sin, scalars):
        B, cap = scalars[0], scalars[9]
        dev = vertices.device
        scratch = torch.empty((B, 3, cap, 2), dtype=torch.float32, device=dev)
        out = torch.empty((B, 5), dtype=torch.float32, device=dev)
        plane_h = torch.empty((B, 3), dtype=torch.float32, device=dev)
        if B > 0:
            MEASURE_KERNEL.launch("measure_forward", [
                vertices, faces, flat, anchor_face, anchor_bary, hull_cos,
                hull_sin, scratch, out, plane_h, *scalars])
        return out, plane_h

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "K1 (csrc/measure.cu) has no backward yet: a measurement loss "
            "weight above 0 needs the K1-backward item of ROADMAP queue 2")


class BodyMeasurements(nn.Module):
    """Batched virtual measurements on one mesh topology.

    ``faces`` (F, 3) and the optional per-plane ``face_subsets`` (from
    :func:`candidate_faces`) become non-persistent device buffers, so
    ``.to(device)`` moves them with the regressor.
    """

    def __init__(
        self,
        anchors: MeasurementAnchors,
        faces: np.ndarray,
        num_hull_directions: int = 256,
        density: float = DENSITY,
        slice_mode: str = "reference",
        face_subsets: Optional[Dict[str, np.ndarray]] = None,
    ):
        super().__init__()
        if slice_mode not in ("reference", "exact"):
            raise ValueError(f"unknown slice_mode: {slice_mode!r}")
        self.anchors = anchors
        self.num_hull_directions = num_hull_directions
        self.density = density
        self.slice_mode = slice_mode

        def buf(name, value, dtype):
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(value), dtype=dtype), persistent=False)

        # The kernel indexes with these ids unchecked: validate them once.
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
        self.has_subsets = face_subsets is not None
        for name in PLANES:
            sub = (face_subsets[name] if self.has_subsets
                   else np.zeros(0, np.int32))
            buf(f"subset_{name}", sub, torch.int32)

    def forward_from_vertices(self, vertices: torch.Tensor,
                              use_face_subsets: bool = True
                              ) -> Dict[str, Dict[str, torch.Tensor]]:
        """All measurements from (B, V, 3) vertices.

        ``use_face_subsets=False`` walks all faces: the subsets are exact
        only for bodies inside the beta bound they were built for.

        Returns {'measurements': {'mass': {'tensor'}, 'height':
        {'tensor'}, 'chest'|'waist'|'hips': {'tensor', 'plane_height'}}}.
        """
        if vertices.shape[1] < self.num_mesh_vertices:
            raise ValueError(f"{vertices.shape[1]} vertices for a mesh of "
                             f"{self.num_mesh_vertices}")
        plane_faces = None
        if use_face_subsets and self.has_subsets:
            plane_faces = [getattr(self, f"subset_{n}") for n in PLANES]
        if self.slice_mode == "reference":
            vals, heights = measure_reference(
                vertices.contiguous(), self.faces, plane_faces, self.anchors,
                self.anchor_face, self.anchor_bary, self.hull_cos,
                self.hull_sin, self.density)
        else:
            vals, heights = measure_plain(
                vertices, self.faces, plane_faces, self.anchors,
                self.num_hull_directions, self.density, slice_mode="exact")
        out: Dict[str, Dict[str, torch.Tensor]] = {
            "mass": {"tensor": vals[:, 0]},
            "height": {"tensor": vals[:, 1]},
        }
        for p, name in enumerate(PLANES):
            out[name] = {"tensor": vals[:, 2 + p],
                         "plane_height": heights[:, p]}
        return {"measurements": out}
