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
``_Repulsion``, whose forward (one launch) and backward (two) are kernel
K7 (``csrc/repulsion.cu``), split by :func:`repulsion_plan`.
:func:`repulsion_forward_replay` and :func:`repulsion_backward_replay`
repeat the kernels' sum orders in plain PyTorch on any device, the
oracles of their bits.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from shapy_tpu_torch.utils.cuda_kernels import (
    CARD_SMS,
    CudaKernel,
    check_cuda_input,
)
from shapy_tpu_torch.utils.vec3 import cross3, dot3

REPULSION_KERNEL = CudaKernel("repulsion.cu", {
    "repulsion_forward": "ppppppp iii ffffff i p",
    "repulsion_backward": "pppppppp iiiii ffffff i p",
})
# csrc/repulsion.cu: pairs a forward block (the f64 tree), tangent passes a
# pair (18 inputs, 2 tangents a pass), the pair pass's block bounds and the
# faces a face-pass block.
_PAIR_TILE = 256
_PASSES = 9
_PAIR_THREADS_MIN, _PAIR_THREADS_MAX = 32, 256
_PAIR_BLOCKS_PER_SM = 3
_FACE_BLOCK = 256
_EPSILON = 1e-6
# K7's int32 state between calls, by (kind, device, stream): the forward's
# tickets, the backward's face-list heads.
_STATE: Dict[tuple, torch.Tensor] = {}


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


def _cone_field(points, cone_center, cone_radius, cone_axis, sigma,
                penalize_outside, linear_max, epsilon):
    """:func:`conical_distance_field` and its mask (axis_dist < 1): where
    the mask is False the field is 0 and K7's tangents are exact 0."""
    rel = points - cone_center[..., None, :]
    axis = cone_axis[..., None, :]
    dot = dot3(rel, axis)
    numerator = _norm(rel - dot[..., None] * axis)
    denominator = -cone_radius / sigma * dot + cone_radius
    axis_dist = numerator / (denominator + epsilon)
    intensity = repulsion_intensity(dot, sigma, penalize_outside, linear_max)
    inside = axis_dist < 1.0
    field = (1.0 - axis_dist) * intensity
    field = inside.to(points.dtype) * (field * field)
    return field * field, inside


def conical_distance_field(points, cone_center, cone_radius, cone_axis,
                           sigma: float = 0.5, penalize_outside: bool = True,
                           linear_max: float = 1000.0,
                           epsilon: float = _EPSILON) -> torch.Tensor:
    """The reference's vectorised field ((1 - axis_dist) * intensity)^4
    inside the cone, 0 outside.

    points (B, C, N, 3); cone_center (B, C, 3); cone_radius (B, C, 1);
    cone_axis (B, C, 3) unit. Returns (B, C, N)."""
    return _cone_field(points, cone_center, cone_radius, cone_axis, sigma,
                       penalize_outside, linear_max, epsilon)[0]


def _cone(tri: torch.Tensor):
    normal = cross3(tri[..., 1, :] - tri[..., 0, :],
                    tri[..., 2, :] - tri[..., 0, :])
    axis = normal / torch.clamp(_norm(normal), min=1e-12)[..., None]
    radius, center = circumcircle(tri)
    return axis, radius, center


def _gather(triangles: torch.Tensor, collision_idxs: torch.Tensor):
    """(valid (B, C), receivers, intruders (B, C, 3, 3)); a padded id
    gathers face 0, as the JAX package does."""
    valid = torch.all(collision_idxs >= 0, dim=-1)
    idx = torch.clamp(collision_idxs.long(), min=0)
    b = torch.arange(triangles.shape[0], device=triangles.device)[:, None]
    return valid, triangles[b, idx[..., 0]], triangles[b, idx[..., 1]]


def _penalties(valid, recv, intr, sigma, penalize_outside, linear_max):
    """Each pair's penalty (B, C), 0 where not ``valid``, summed over the
    three vertices in order as K7 sums them, and whether the pair is live
    (valid, and some of its six points inside its cone's mask)."""
    recv_axis, recv_radius, recv_center = _cone(recv)
    intr_axis, intr_radius, intr_center = _cone(intr)
    kw = dict(sigma=sigma, penalize_outside=penalize_outside,
              linear_max=linear_max, epsilon=_EPSILON)
    phi_r, in_r = _cone_field(intr, recv_center, recv_radius, recv_axis,
                              **kw)
    phi_i, in_i = _cone_field(recv, intr_center, intr_radius, intr_axis,
                              **kw)
    t = phi_r * phi_r + phi_i * phi_i
    per_pair = (t[..., 0] + t[..., 1]) + t[..., 2]
    live = valid & torch.any(in_r | in_i, dim=-1)
    return torch.where(valid, per_pair, 0.0), live


def repulsion_pairs_plain(triangles: torch.Tensor,
                          collision_idxs: torch.Tensor, sigma: float = 0.5,
                          penalize_outside: bool = True,
                          linear_max: float = 1000.0):
    """Each pair's penalty (B, C) (0 for a padded pair) and live mask (B,
    C): the pair is valid and some point of it passed its cone's mask. A
    pair that is not live adds 0 and has a zero gradient, so K7's backward
    skips it."""
    valid, recv, intr = _gather(triangles, collision_idxs)
    return _penalties(valid, recv, intr, sigma, penalize_outside,
                      linear_max)


def repulsion_loss_plain(triangles: torch.Tensor, collision_idxs: torch.Tensor,
                         sigma: float = 0.5, penalize_outside: bool = True,
                         linear_max: float = 1000.0) -> torch.Tensor:
    """Plain version of K7: triangles (B, F, 3, 3), collision_idxs (B, C,
    2) int (receiver, intruder), -1-padded -> (B,) losses. Differentiable
    with respect to the triangles, in any float dtype."""
    per_pair, _ = repulsion_pairs_plain(triangles, collision_idxs, sigma,
                                        penalize_outside, linear_max)
    return torch.sum(per_pair, dim=-1)


def repulsion_entries_plain(triangles: torch.Tensor,
                            collision_idxs: torch.Tensor,
                            grad_loss: torch.Tensor, sigma: float = 0.5,
                            penalize_outside: bool = True,
                            linear_max: float = 1000.0) -> torch.Tensor:
    """Each pair's gradient (B, C, 2, 3, 3), receiver then intruder, times
    grad_loss[b]: what K7's pair pass writes, by autograd through the
    plain penalties (0 for a padded pair)."""
    valid, recv, intr = _gather(triangles.detach(), collision_idxs)
    recv, intr = recv.requires_grad_(), intr.requires_grad_()
    per_pair, _ = _penalties(valid, recv, intr, sigma, penalize_outside,
                             linear_max)
    g_r, g_i = torch.autograd.grad((per_pair * grad_loss[:, None]).sum(),
                                   (recv, intr))
    return torch.stack([g_r, g_i], dim=2)


# --- K7's design, replayed ------------------------------------------------

class RepulsionPlan(NamedTuple):
    """K7's split, from the shapes alone: ``tiles`` forward blocks a body
    (``_PAIR_TILE`` pairs each), ``pair_threads`` a block of the pair
    gradient pass and ``pair_blocks`` its blocks (a thread per pair and
    tangent pass), ``face_blocks`` face-pass blocks (``_FACE_BLOCK`` faces
    each)."""

    tiles: int
    pair_threads: int
    pair_blocks: int
    face_blocks: int


def repulsion_plan(B: int, C: int, F: int) -> RepulsionPlan:
    """K7's plan for B bodies of C pairs and F faces: the pair pass takes
    the largest block of 256, 128, 64 or 32 threads that still gives
    ``_PAIR_BLOCKS_PER_SM`` blocks an SM of ``CARD_SMS`` (64 at phase 9's
    4 x 1300 pairs: 732 blocks), so that every SM holds several at the
    kernel's ~114 registers a thread."""
    work = B * C * _PASSES
    threads = _PAIR_THREADS_MAX
    while (threads > _PAIR_THREADS_MIN
           and -(-work // threads) < _PAIR_BLOCKS_PER_SM * CARD_SMS):
        threads //= 2
    return RepulsionPlan(-(-C // _PAIR_TILE), threads, -(-work // threads),
                         -(-(B * F) // _FACE_BLOCK))


def repulsion_forward_replay(per_pair: torch.Tensor):
    """K7's forward sum of the pairs' penalties per_pair (B, C) f32 (0 for
    a padded pair), on any device: each tile of ``_PAIR_TILE`` pairs
    summed in f64 by the kernel's tree (pair t plus pair t + s, s halving
    from 128), the tiles added in order from 0.0. Returns the loss (B,)
    f32 and the f64 totals (B,)."""
    B, C = per_pair.shape
    tiles = -(-C // _PAIR_TILE)
    x = torch.zeros(B, tiles * _PAIR_TILE, dtype=torch.float64,
                    device=per_pair.device)
    x[:, :C] = per_pair.double()
    x = x.reshape(B, tiles, _PAIR_TILE)
    s = _PAIR_TILE // 2
    while s:
        x = x[..., :s] + x[..., s:2 * s]
        s //= 2
    total = torch.zeros(B, dtype=torch.float64, device=per_pair.device)
    for k in range(tiles):
        total = total + x[:, k, 0]
    return total.float(), total


def repulsion_buckets(collision_idxs: torch.Tensor, F: int,
                      live: torch.Tensor | None = None,
                      grad_loss: torch.Tensor | None = None):
    """K7's face -> entry lists, on any device: (order, starts), face bf =
    b * F + f holding entry ids order[starts[bf]:starts[bf + 1]] in
    ascending order (entry e = (b * C + c) * 2 + role, role 0 the
    receiver). A padded pair has no entry; with ``live`` neither has a
    pair that is not live, unless grad_loss[b] is not finite (the kernel's
    rule)."""
    B, C = collision_idxs.shape[:2]
    dev = collision_idxs.device
    keep = torch.all(collision_idxs >= 0, dim=-1)
    if live is not None:
        finite = (torch.ones(B, dtype=torch.bool, device=dev)
                  if grad_loss is None else torch.isfinite(grad_loss))
        keep = keep & (live.bool() | ~finite[:, None])
    ids = torch.arange(B * C * 2, device=dev).reshape(B, C, 2)
    faces = (collision_idxs.long()
             + (torch.arange(B, device=dev) * F)[:, None, None])
    mask = keep[..., None].expand(B, C, 2)
    keys, perm = torch.sort(faces[mask], stable=True)
    starts = torch.searchsorted(keys, torch.arange(B * F + 1, device=dev))
    return ids[mask][perm], starts


def repulsion_backward_replay(entries: torch.Tensor,
                              collision_idxs: torch.Tensor, F: int,
                              live: torch.Tensor | None = None,
                              grad_loss: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """K7's face pass on the pairs' entries (B, C, 2, 3, 3), on any
    device: each face's entries (:func:`repulsion_buckets`) added in
    ascending entry id from +0, the kernel's order. Returns the gradient
    (B, F, 3, 3)."""
    B = collision_idxs.shape[0]
    dev = entries.device
    order, starts = repulsion_buckets(collision_idxs, F, live, grad_loss)
    counts = starts[1:] - starts[:-1]
    face = torch.arange(B * F, device=dev).repeat_interleave(counts)
    rank = (torch.arange(len(order), device=dev)
            - starts[:-1].repeat_interleave(counts))
    flat = entries.reshape(-1, 9)
    grad = torch.zeros(B * F, 9, dtype=entries.dtype, device=dev)
    for j in range(int(counts.max()) if len(order) else 0):
        sel = rank == j
        grad[face[sel]] = grad[face[sel]] + flat[order[sel]]
    return grad.reshape(B, F, 3, 3)


# --- K7 on the card ---------------------------------------------------------

def _constants(sigma: float, penalize_outside: bool, linear_max: float):
    """K7's scalar arguments: the intensity's coefficients as the plain
    version rounds them (Python floats, then f32)."""
    return [sigma, -(1.0 - 2.0 * sigma) / (4.0 * sigma ** 2),
            1.0 / (2.0 * sigma), 0.25 * (3.0 - 2.0 * sigma), linear_max,
            _EPSILON, int(penalize_outside)]


def _state(kind: str, n: int, fill: int, dev: torch.device) -> torch.Tensor:
    """K7's int32 state kept between calls, per device and stream:
    ``tickets`` (0 between calls) and ``heads`` (-1 between calls), at
    least n long; made (filled once) when missing or too short."""
    key = (kind, dev, torch.cuda.current_stream(dev).cuda_stream)
    t = _STATE.get(key)
    if t is None or t.numel() < n:
        t = _STATE[key] = torch.full((max(n, 1),), fill, dtype=torch.int32,
                                     device=dev)
    return t


def _repulsion_forward_cuda(triangles, pairs, consts, per_pair=False):
    """K7's forward on the card: (loss (B,) f32, live (B, C) uint8, the f64
    totals (B,), the pairs' penalties (B, C) f32 with ``per_pair`` else
    None)."""
    B, F = triangles.shape[:2]
    C = pairs.shape[1]
    dev = triangles.device
    live = torch.empty((B, C), dtype=torch.uint8, device=dev)
    if B == 0 or C == 0:
        return (torch.zeros(B, dtype=torch.float32, device=dev), live,
                torch.zeros(B, dtype=torch.float64, device=dev),
                torch.zeros((B, C), device=dev) if per_pair else None)
    pen = (torch.empty((B, C), dtype=torch.float32, device=dev)
           if per_pair else None)
    loss = torch.empty(B, dtype=torch.float32, device=dev)
    partials = torch.empty((B, repulsion_plan(B, C, F).tiles + 1),
                           dtype=torch.float64, device=dev)
    REPULSION_KERNEL.launch("repulsion_forward", [
        triangles, pairs, partials, _state("tickets", B, 0, dev), loss, live,
        0 if pen is None else pen, B, F, C, *consts])
    return loss, live, partials[:, -1], pen


def _repulsion_backward_cuda(triangles, pairs, grad_loss, live, consts):
    """K7's backward on the card: (the gradient (B, F, 3, 3), the pairs'
    entries (B, C, 2, 3, 3), unwritten for pairs skipped or padded)."""
    B, F = triangles.shape[:2]
    C = pairs.shape[1]
    dev = triangles.device
    grad = torch.empty_like(triangles)
    entries = torch.empty((B, C, 2, 3, 3), dtype=torch.float32, device=dev)
    if B * F == 0:
        return grad, entries
    check_cuda_input(grad_loss, "grad_loss", torch.float32, (B,), dev,
                     strided=True)
    nxt = torch.empty(max(B * C * 2, 1), dtype=torch.int32, device=dev)
    REPULSION_KERNEL.launch("repulsion_backward", [
        triangles, pairs, grad_loss, live, entries, nxt,
        _state("heads", B * F, -1, dev), grad, B, F, C, grad_loss.stride(0),
        repulsion_plan(B, C, F).pair_threads, *consts])
    return grad, entries


class _Repulsion(torch.autograd.Function):
    """K7: the forward (one launch) sums per-pair penalties per tile and
    the tiles in order, and saves each pair's live byte; the backward (two
    launches) writes each live pair's (2, 3, 3) gradient, then sums each
    face's entries in ascending entry id through face lists built on the
    card. No float atomics: two calls give the same bits."""

    @staticmethod
    def forward(ctx, triangles, pairs, consts):
        loss, live, _, _ = _repulsion_forward_cuda(triangles, pairs, consts)
        ctx.save_for_backward(triangles, pairs, live)
        ctx.consts = consts
        return loss

    @staticmethod
    def backward(ctx, grad_loss):
        triangles, pairs, live = ctx.saved_tensors
        grad, _ = _repulsion_backward_cuda(triangles, pairs, grad_loss, live,
                                           ctx.consts)
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
