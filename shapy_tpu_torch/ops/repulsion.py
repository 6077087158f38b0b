"""Cone-field repulsion (interpenetration) loss (port of
``shapy_tpu/ops/repulsion.py``).

Each receiver triangle defines a cone (axis the unit normal, base radius
the circumradius, height ``sigma``); the other triangle's vertices inside
the cone are penalised by a piecewise linear / quadratic intensity, and
the penalty is summed both ways over the (receiver, intruder) pairs. The
JAX package's quirks are kept: the field is raised to the 4th power and
squared again per pair, ``epsilon`` is added to the cone's radius
unconditionally, and padded (-1) pairs gather face 0 and add exactly 0.

:func:`repulsion_loss_plain` is the plain PyTorch version (the CPU path,
and on the card the oracle of the value and, through autograd, of the
gradient). On a CUDA tensor :func:`repulsion_loss` goes through
``_Repulsion``, whose forward and backward are kernel K7's two launches
(``csrc/repulsion.cu``).
"""

from __future__ import annotations

import torch

from shapy_tpu_torch.utils.cuda_kernels import CudaKernel, check_cuda_input
from shapy_tpu_torch.utils.vec3 import cross3, dot3

REPULSION_KERNEL = CudaKernel("repulsion.cu", {
    "repulsion_forward": "pppp iii ffffff i p",
    "repulsion_backward": "ppppppp iii ffffff i p",
})
_PAIR_TILE = 256  # pairs per block of csrc/repulsion.cu
_EPSILON = 1e-6


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot3(v, v))


def circumcircle(triangles: torch.Tensor):
    """Circumradius (..., 1) and circumcentre (..., 3) of triangles (...,
    3, 3)."""
    alpha = triangles[..., 0, :] - triangles[..., 2, :]
    beta = triangles[..., 1, :] - triangles[..., 2, :]
    cross = cross3(alpha, beta)
    radius = (_norm(alpha - beta)
              / torch.clamp(2.0 * _norm(cross), min=1e-12)
              * _norm(alpha) * _norm(beta))[..., None]
    center = (cross3(dot3(alpha, alpha)[..., None] * beta
                     - dot3(beta, beta)[..., None] * alpha, cross)
              / torch.clamp(2.0 * dot3(cross, cross), min=1e-12)[..., None])
    return radius, center + triangles[..., 2, :]


def repulsion_intensity(x: torch.Tensor, sigma: float = 0.5,
                        penalize_outside: bool = True,
                        linear_max: float = 1000.0) -> torch.Tensor:
    """Piecewise penalty: linear for deep penetration, quadratic near the
    surface."""
    quad = (-(1.0 - 2.0 * sigma) / (4.0 * sigma ** 2) * (x * x)
            - 1.0 / (2.0 * sigma) * x + 0.25 * (3.0 - 2.0 * sigma))
    linear_mask = (x <= -sigma) & (x > -linear_max)
    if penalize_outside:
        quad_mask = (x > -sigma) & (x < sigma)
    else:
        quad_mask = (x > -sigma) & (x < 0)
    return (linear_mask.to(x.dtype) * (-x + 1.0 - sigma)
            + quad_mask.to(x.dtype) * quad)


def conical_distance_field(points, cone_center, cone_radius, cone_axis,
                           sigma: float = 0.5, penalize_outside: bool = True,
                           linear_max: float = 1000.0,
                           epsilon: float = _EPSILON) -> torch.Tensor:
    """The reference's vectorised field ((1 - axis_dist) * intensity)^4
    inside the cone, 0 outside.

    points (B, C, N, 3); cone_center (B, C, 3); cone_radius (B, C, 1);
    cone_axis (B, C, 3) unit. Returns (B, C, N)."""
    rel = points - cone_center[..., None, :]
    axis = cone_axis[..., None, :]
    dot = dot3(rel, axis)
    numerator = _norm(rel - dot[..., None] * axis)
    denominator = -cone_radius / sigma * dot + cone_radius
    axis_dist = numerator / (denominator + epsilon)
    intensity = repulsion_intensity(dot, sigma, penalize_outside, linear_max)
    mask = (axis_dist < 1.0).to(points.dtype)
    field = (1.0 - axis_dist) * intensity
    field = mask * (field * field)
    return field * field


def _cone(tri: torch.Tensor):
    normal = cross3(tri[..., 1, :] - tri[..., 0, :],
                    tri[..., 2, :] - tri[..., 0, :])
    axis = normal / torch.clamp(_norm(normal), min=1e-12)[..., None]
    radius, center = circumcircle(tri)
    return axis, radius, center


def repulsion_loss_plain(triangles: torch.Tensor, collision_idxs: torch.Tensor,
                         sigma: float = 0.5, penalize_outside: bool = True,
                         linear_max: float = 1000.0) -> torch.Tensor:
    """Plain version of K7: triangles (B, F, 3, 3), collision_idxs (B, C,
    2) int (receiver, intruder), -1-padded -> (B,) losses. Differentiable
    with respect to the triangles, in any float dtype."""
    valid = torch.all(collision_idxs >= 0, dim=-1)  # (B, C)
    idx = torch.clamp(collision_idxs.long(), min=0)
    b = torch.arange(triangles.shape[0], device=triangles.device)[:, None]
    recv = triangles[b, idx[..., 0]]  # (B, C, 3, 3)
    intr = triangles[b, idx[..., 1]]
    recv_axis, recv_radius, recv_center = _cone(recv)
    intr_axis, intr_radius, intr_center = _cone(intr)
    kw = dict(sigma=sigma, penalize_outside=penalize_outside,
              linear_max=linear_max)
    phi_receivers = conical_distance_field(intr, recv_center, recv_radius,
                                           recv_axis, **kw)
    phi_intruders = conical_distance_field(recv, intr_center, intr_radius,
                                           intr_axis, **kw)
    per_pair = torch.sum(phi_receivers * phi_receivers
                         + phi_intruders * phi_intruders, dim=-1)
    return torch.sum(torch.where(valid, per_pair, 0.0), dim=-1)


def _constants(sigma: float, penalize_outside: bool, linear_max: float):
    """K7's scalar arguments: the intensity's coefficients as the plain
    version rounds them (Python floats, then f32)."""
    return [sigma, -(1.0 - 2.0 * sigma) / (4.0 * sigma ** 2),
            1.0 / (2.0 * sigma), 0.25 * (3.0 - 2.0 * sigma), linear_max,
            _EPSILON, int(penalize_outside)]


class _Repulsion(torch.autograd.Function):
    """K7: the forward sums per-pair penalties per block and the blocks in
    order; the backward writes each pair's (2, 3, 3) gradient, then sums
    each face's entries in pair order through a face -> entry list built
    with a stable sort. No atomics: two calls give the same bits."""

    @staticmethod
    def forward(ctx, triangles, pairs, consts):
        B, F = triangles.shape[:2]
        C = pairs.shape[1]
        dev = triangles.device
        loss = torch.zeros(B, dtype=torch.float32, device=dev)
        blocks = -(-C // _PAIR_TILE)
        if B > 0 and C > 0:
            partials = torch.empty((B, blocks), dtype=torch.float64,
                                   device=dev)
            REPULSION_KERNEL.launch("repulsion_forward", [
                triangles, pairs, partials, loss, B, F, C, *consts])
        ctx.save_for_backward(triangles, pairs)
        ctx.consts = consts
        return loss

    @staticmethod
    def backward(ctx, grad_loss):
        triangles, pairs = ctx.saved_tensors
        B, F = triangles.shape[:2]
        C = pairs.shape[1]
        dev = triangles.device
        grad = torch.zeros_like(triangles)
        if B == 0 or C == 0 or F == 0:
            return grad, None, None
        # entry e = (b * C + c) * 2 + role; a padded pair's entries sort
        # past every face (key B * F) and are never read
        valid = torch.all(pairs >= 0, dim=-1, keepdim=True)
        offsets = (torch.arange(B, device=dev) * F)[:, None, None]
        keys = torch.where(valid, pairs.long() + offsets, B * F).reshape(-1)
        sorted_keys, order = torch.sort(keys, stable=True)
        starts = torch.searchsorted(
            sorted_keys, torch.arange(B * F + 1, device=dev)).to(torch.int32)
        entries = torch.empty((B, C, 2, 3, 3), dtype=torch.float32,
                              device=dev)
        REPULSION_KERNEL.launch("repulsion_backward", [
            triangles, pairs, grad_loss.contiguous(), entries,
            order.to(torch.int32), starts, grad, B, F, C, *ctx.consts])
        return grad, None, None


def repulsion_loss(triangles: torch.Tensor, collision_idxs: torch.Tensor,
                   sigma: float = 0.5, penalize_outside: bool = True,
                   linear_max: float = 1000.0) -> torch.Tensor:
    """Penetration penalty (B,) of triangles (B, F, 3, 3) over (receiver,
    intruder) pairs (B, C, 2), -1-padded: the plain version for CPU
    tensors, kernel K7 (forward and backward) for CUDA tensors (contiguous
    f32 triangles, int32 pairs). An id at or above F fails as indexing a
    CUDA tensor out of range does: K7 checks its ids on the card and
    stops with a device-side assert, which the next synchronisation
    raises; no host sync is made per call."""
    if triangles.device.type == "cpu":
        return repulsion_loss_plain(triangles, collision_idxs, sigma,
                                    penalize_outside, linear_max)
    if triangles.device.type != "cuda":
        raise ValueError(f"repulsion_loss: unsupported device "
                         f"{triangles.device}")
    B, F = triangles.shape[:2]
    dev = triangles.device
    check_cuda_input(triangles, "triangles", torch.float32, (B, F, 3, 3), dev)
    check_cuda_input(collision_idxs, "collision_idxs", torch.int32,
                     (B, None, 2), dev)
    return _Repulsion.apply(triangles, collision_idxs,
                            _constants(sigma, penalize_outside, linear_max))
