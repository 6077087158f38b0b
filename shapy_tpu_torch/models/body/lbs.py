"""Linear blend skinning (port of ``shapy_tpu/models/body/lbs.py``).

Blend shapes, joint regression and pose-corrective offsets are plain
matmuls (the JAX package left them to XLA). The kinematic chain is
:func:`shapy_tpu_torch.core.kinematics.batch_rigid_transform` (kernel
K3-chain on the card). Skinning goes through :func:`skin`, whose CUDA path
is kernel K3 (``csrc/skinning.cu``), forward and backward.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from shapy_tpu_torch.core.geometry import blend_shapes, vertices2joints
from shapy_tpu_torch.core.kinematics import batch_rigid_transform
from shapy_tpu_torch.utils.cuda_kernels import CudaKernel, check_cuda_input

SKIN_KERNEL = CudaKernel("skinning.cu", {
    "skin_forward": "pppp iiii p",
    "skin_backward": "ppppppp iiiii p",
})
_SKIN_MAX_JOINTS = 76
_SKIN_TILE = 128  # vertices a tile: 32 lanes x 4
# Bodies a block, a warp each: on an H100 4 was the fastest of 2, 4, 6 and
# 8 at batch 32 and within ~1 us of the fastest at 48, in both kernels
# (tools/perf_k3_sweep.py).
_SKIN_RUN = 4
# The backward's wave: two blocks on each of the H100's 132 SMs (a block
# at 55 joints takes 89 KB of an SM's 228 KB of shared memory).
_WAVE = 2 * 132
# The batch whose backward sets the vertex partitions (a train step's):
# the partitions fix the sums' order, so they depend on V alone.
_PLAN_BATCH = 48


class SkinPlan(NamedTuple):
    """How K3's kernels split the work (``csrc/skinning.cu``).

    A block of either kernel takes ``run`` bodies, a warp each. The
    forward's takes one 128-vertex tile: ceil(V / 128) x ceil(B / run)
    blocks. The backward's takes ``tiles_per_part`` consecutive tiles:
    ``parts`` x ceil(B / run) blocks, each writing one partial of d A a
    body; ``sub`` lanes share a group of joints in its d A sums (vertices
    s, s + sub, ... of a tile)."""

    run: int
    tiles_per_part: int
    parts: int
    sub: int


@functools.lru_cache(maxsize=None)
def skin_plan(B: int, V: int, J: int) -> SkinPlan:
    """K3's work split for B bodies of V vertices and J joints, from the
    shape alone (:class:`SkinPlan`).

    Both kernels take runs of ``_SKIN_RUN`` bodies. The backward's
    partitions take the fewest tiles that keep a train step's grid
    (``_PLAN_BATCH`` bodies) within one wave of its blocks, whatever B
    is, so that a body's gradient sums run in the same order in any
    batch."""
    tiles = -(-V // _SKIN_TILE)
    runs = -(-_PLAN_BATCH // _SKIN_RUN)
    tpp = next(t for t in range(1, tiles + 1)
               if -(-tiles // t) * runs <= _WAVE or t == tiles)
    return SkinPlan(run=min(_SKIN_RUN, B), tiles_per_part=tpp,
                    parts=-(-tiles // tpp), sub=32 // -(-J // 4))


def skin_plain(lbs_weights: torch.Tensor, rel_transforms: torch.Tensor,
               v_posed: torch.Tensor) -> torch.Tensor:
    """``v = sum_j w_vj A_j [v_posed; 1]`` with the (B, V, 4, 4) per-vertex
    transforms materialised, as ``lbs.py:97-101`` of the JAX package.

    lbs_weights (V, J), rel_transforms (B, J, 4, 4), v_posed (B, V, 3)
    -> (B, V, 3)."""
    B, J = rel_transforms.shape[:2]
    T = torch.matmul(lbs_weights, rel_transforms.reshape(B, J, 16))
    T = T.reshape(B, -1, 4, 4)
    v_hom = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    return torch.matmul(T[..., :3, :], v_hom[..., None])[..., 0]


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors rounded once to float32, as CUDA's
    ``__fmaf_rn``: the product is exact in float64 and the sum's rounding
    error exact by TwoSum; where the float64 sum lies exactly halfway
    between two float32 values, that error decides the direction."""
    a64, b64, c64 = a.double(), b.double(), c.double()
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.float()
    up = torch.nextafter(r, torch.full_like(r, math.inf))
    down = torch.nextafter(r, torch.full_like(r, -math.inf))
    r64 = r.double()
    r = torch.where((s == (r64 + up.double()) / 2) & (err > 0), up, r)
    return torch.where((s == (r64 + down.double()) / 2) & (err < 0), down, r)


def _transform_sums(lbs_weights: torch.Tensor,
                    rel_transforms: torch.Tensor) -> torch.Tensor:
    """(B, V, 12): each vertex's 3x4 transform as K3 sums it, one
    ``__fmaf_rn`` chain an entry in ascending j."""
    A = rel_transforms[:, :, :3, :].reshape(rel_transforms.shape[0], -1, 12)
    T = torch.zeros(A.shape[0], lbs_weights.shape[0], 12,
                    dtype=torch.float32, device=A.device)
    for j in range(lbs_weights.shape[1]):
        T = fma32(lbs_weights[None, :, j, None], A[:, None, j], T)
    return T


def skin_forward_replay(lbs_weights: torch.Tensor,
                        rel_transforms: torch.Tensor,
                        v_posed: torch.Tensor) -> torch.Tensor:
    """K3's forward in plain PyTorch with its roundings: the kernel's bits
    on any device."""
    T = _transform_sums(lbs_weights, rel_transforms).unflatten(-1, (3, 4))
    x, y, z = v_posed.unbind(-1)
    out = fma32(T[..., 0], x[..., None], T[..., 3])
    out = fma32(T[..., 1], y[..., None], out)
    return fma32(T[..., 2], z[..., None], out)


def skin_backward_replay(lbs_weights: torch.Tensor,
                         rel_transforms: torch.Tensor,
                         v_posed: torch.Tensor, grad_out: torch.Tensor
                         ) -> tuple:
    """K3's backward in plain PyTorch with its order of sums
    (:func:`skin_plan`): (d rel_transforms, d v_posed), the kernel's bits
    on any device.

    d v_posed from the forward's transform sums; d A_j = sum_v w_vj
    (dv (x) [v_posed; 1]) as a chain per (body, partition, sub-range,
    joint, entry) over the partition's tiles and, in each, the vertices
    s, s + sub, ...; the sub-ranges' sums added in order, then the
    partitions'."""
    B, V, _ = v_posed.shape
    J = lbs_weights.shape[1]
    plan = skin_plan(B, V, J)
    tiles = -(-V // _SKIN_TILE)
    dev = v_posed.device
    T = _transform_sums(lbs_weights, rel_transforms)
    dv = grad_out
    d_v = torch.stack([
        fma32(T[..., 8 + c], dv[..., 2],
              fma32(T[..., 4 + c], dv[..., 1], T[..., c] * dv[..., 0]))
        for c in range(3)], dim=-1)
    vh = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], -1)
    g = (dv[..., :, None] * vh[..., None, :]).reshape(B, V, 12)
    # the vertex of each chain's step i (V: none, a zero weight and g)
    S, tile = plan.sub, _SKIN_TILE
    steps = plan.tiles_per_part * -(-tile // S)
    order = torch.full((plan.parts, S, steps), V, dtype=torch.long)
    for p in range(plan.parts):
        for s in range(S):
            vs = [v for t in range(p * plan.tiles_per_part,
                                   min(tiles, (p + 1) * plan.tiles_per_part))
                  for v in range(t * tile + s, min(V, (t + 1) * tile), S)]
            order[p, s, :len(vs)] = torch.tensor(vs, dtype=torch.long)
    order = order.to(dev)
    w_pad = torch.cat([lbs_weights, lbs_weights.new_zeros(1, J)])
    g_pad = torch.cat([g, g.new_zeros(B, 1, 12)], 1)
    acc = torch.zeros(B, plan.parts, S, J, 12, dtype=torch.float32,
                      device=dev)
    for i in range(steps):
        idx = order[:, :, i]
        acc = fma32(w_pad[idx][None, ..., None], g_pad[:, idx][..., None, :],
                    acc)
    part = acc[:, :, 0]
    for s in range(1, S):
        part = part + acc[:, :, s]
    total = part[:, 0]
    for p in range(1, plan.parts):
        total = total + part[:, p]
    d_rel = torch.zeros_like(rel_transforms)
    d_rel[:, :, :3, :] = total.reshape(B, J, 3, 4)
    return d_rel, d_v


class _Skin(torch.autograd.Function):
    """K3 forward and backward kernels (no gradient for the weights)."""

    @staticmethod
    def forward(ctx, lbs_weights, rel_transforms, v_posed):
        B, V, _ = v_posed.shape
        J = lbs_weights.shape[1]
        out = torch.empty_like(v_posed)
        if B > 0 and V > 0:
            SKIN_KERNEL.launch("skin_forward", [
                lbs_weights, rel_transforms, v_posed, out, B, V, J,
                skin_plan(B, V, J).run])
        ctx.save_for_backward(lbs_weights, rel_transforms, v_posed)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        lbs_weights, rel_transforms, v_posed = ctx.saved_tensors
        B, V, _ = v_posed.shape
        J = lbs_weights.shape[1]
        grad_out = grad_out.contiguous()
        d_v = torch.empty_like(v_posed)
        d_rel = torch.empty_like(rel_transforms)
        if B > 0 and V > 0:
            plan = skin_plan(B, V, J)
            partials = torch.empty((B, plan.parts, J, 12),
                                   dtype=torch.float32, device=v_posed.device)
            SKIN_KERNEL.launch("skin_backward", [
                lbs_weights, rel_transforms, v_posed, grad_out, d_v,
                partials, d_rel, B, V, J, plan.run, plan.tiles_per_part])
        else:
            d_rel.zero_()
        return None, d_rel, d_v


def skin(lbs_weights: torch.Tensor, rel_transforms: torch.Tensor,
         v_posed: torch.Tensor) -> torch.Tensor:
    """Skinning: the plain version for CPU tensors, kernel K3 for CUDA
    tensors (forward, and backward to ``rel_transforms`` and
    ``v_posed``)."""
    if v_posed.device.type == "cpu":
        return skin_plain(lbs_weights, rel_transforms, v_posed)
    if v_posed.device.type != "cuda":
        raise ValueError(f"skin: unsupported device {v_posed.device}")
    B, V, _ = v_posed.shape
    J = lbs_weights.shape[1]
    if not 1 <= J <= _SKIN_MAX_JOINTS:
        raise ValueError(f"skin: {J} joints, the kernel takes 1 to "
                         f"{_SKIN_MAX_JOINTS}")
    if lbs_weights.requires_grad:
        raise ValueError("skin: the kernel gives no gradient for the "
                         "skinning weights")
    dev = v_posed.device
    check_cuda_input(lbs_weights, "lbs_weights", torch.float32, (V, J), dev)
    check_cuda_input(rel_transforms, "rel_transforms", torch.float32,
                     (B, J, 4, 4), dev)
    check_cuda_input(v_posed, "v_posed", torch.float32, (B, V, 3), dev)
    # the kernels copy both in 16-byte pieces
    if lbs_weights.data_ptr() % 16:
        lbs_weights = lbs_weights.clone()
    if rel_transforms.data_ptr() % 16:
        rel_transforms = rel_transforms.clone()
    return _Skin.apply(lbs_weights, rel_transforms, v_posed)


def lbs(
    betas: torch.Tensor,
    pose: torch.Tensor,
    v_template: torch.Tensor,
    shapedirs: torch.Tensor,
    posedirs: torch.Tensor,
    J_regressor: torch.Tensor,
    parents: Sequence[int],
    lbs_weights: torch.Tensor,
    levels: Optional[Sequence[np.ndarray]] = None,
) -> Dict[str, torch.Tensor]:
    """Linear blend skinning.

    betas (B, L) blend coefficients (may include expression dims); pose
    (B, J, 3, 3) rotations; v_template (V, 3); shapedirs (V, 3, L);
    posedirs (9*(J-1), V*3); J_regressor (J, V); lbs_weights (V, J).

    Returns ``vertices`` (B, V, 3), ``joints`` (B, J, 3), ``v_shaped``
    (B, V, 3) and ``rel_transforms`` (B, J, 4, 4).
    """
    B = max(betas.shape[0], pose.shape[0])
    v_shaped = v_template[None] + blend_shapes(betas, shapedirs)
    v_shaped = v_shaped.expand(B, -1, -1)
    joints = vertices2joints(J_regressor, v_shaped)
    rot_mats = pose.expand(B, -1, -1, -1)
    ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)
    pose_offsets = (pose_feature @ posedirs).reshape(B, -1, 3)
    v_posed = v_shaped + pose_offsets

    posed_joints, rel_transforms, _ = batch_rigid_transform(
        rot_mats, joints, parents, levels=levels
    )
    verts = skin(lbs_weights, rel_transforms.contiguous(),
                 v_posed.contiguous())
    return {
        "vertices": verts,
        "joints": posed_joints,
        "v_shaped": v_shaped,
        "rel_transforms": rel_transforms,
    }
