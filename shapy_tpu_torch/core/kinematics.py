"""Forward kinematics over a joint tree (port of
``shapy_tpu/core/kinematics.py``).

Joints are composed level by level of tree depth: all joints at one
depth compose with their parents in one batched matmul, so the SMPL-X
tree costs one small matmul per level instead of 55 dependent ones.

:func:`batch_rigid_transform` runs :func:`batch_rigid_transform_plain`
(torch ops, differentiated by autograd) for CPU tensors and kernel
K3-chain (``csrc/kinematic_chain.cu``, forward and backward, through a
``torch.autograd.Function``) for CUDA tensors.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from shapy_tpu_torch.utils.cuda_kernels import CudaKernel, check_cuda_input

CHAIN_KERNEL = CudaKernel("kinematic_chain.cu", {
    "chain_forward": "ppppp ppp iii p",
    "chain_backward": "pppppp ppp pp iii p",
})
_CHAIN_MAX_JOINTS = 64  # one thread per joint in a block of 64


def compute_level_schedule(parents: Sequence[int]) -> List[np.ndarray]:
    """Joint indices grouped by tree depth; level 0 is ``[0]``."""
    parents = np.asarray(parents)
    num_joints = len(parents)
    depth = np.zeros(num_joints, dtype=np.int64)
    for j in range(1, num_joints):
        depth[j] = depth[parents[j]] + 1
    return [np.nonzero(depth == d)[0].astype(np.int32)
            for d in range(int(depth.max()) + 1)]


def local_transforms(rot_mats: torch.Tensor, rel_joints: torch.Tensor
                     ) -> torch.Tensor:
    """(..., J, 3, 3) rotations + (..., J, 3) offsets -> (..., J, 4, 4)."""
    top = torch.cat([rot_mats, rel_joints[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot_mats.dtype,
                          device=rot_mats.device)
    bottom = bottom.expand(*rot_mats.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def batch_rigid_transform_plain(
    rot_mats: torch.Tensor,
    joints: torch.Tensor,
    parents: Sequence[int],
    levels: Sequence[np.ndarray] | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K3-chain: compose local rotations down the
    kinematic chain with torch ops.

    rot_mats (B, J, 3, 3), joints (B, J, 3) rest-pose joints.
    Returns posed_joints (B, J, 3), rel_transforms (B, J, 4, 4) (world
    transform with the rest joint removed, for skinning) and the world
    transforms (B, J, 4, 4).
    """
    parents_np = np.asarray(parents)
    if levels is None:
        levels = compute_level_schedule(parents_np)
    device = joints.device

    parent_idx = torch.as_tensor(np.maximum(parents_np, 0), device=device)
    rel_joints = joints - joints[..., parent_idx, :]
    rel_joints[..., 0, :] = joints[..., 0, :]
    A = local_transforms(rot_mats, rel_joints)

    world = A.clone()
    for level in levels[1:]:
        lvl = torch.as_tensor(np.asarray(level, np.int64), device=device)
        par = torch.as_tensor(parents_np[np.asarray(level)], device=device)
        world[..., lvl, :, :] = world[..., par, :, :] @ A[..., lvl, :, :]

    posed_joints = world[..., :3, 3]
    rotated_rest = (world[..., :3, :3] @ joints[..., None])[..., 0]
    rel_transforms = world.clone()
    rel_transforms[..., :3, 3] = world[..., :3, 3] - rotated_rest
    return posed_joints, rel_transforms, world


@functools.lru_cache(maxsize=16)
def _schedule(parents: Tuple[int, ...], device: torch.device):
    """(parents, joints level by level, level offsets) as int32 tensors
    on ``device``, and the number of levels; cached per tree. The kernel
    indexes with the parents unchecked: each must precede its child."""
    if any(not 0 <= p < j for j, p in enumerate(parents) if j > 0):
        raise ValueError("batch_rigid_transform: every parent must precede "
                         "its joint")
    levels = compute_level_schedule(parents)
    order = np.concatenate(levels).astype(np.int32)
    offsets = np.cumsum([0] + [len(lv) for lv in levels]).astype(np.int32)
    par = np.asarray(parents, np.int32)
    return ([torch.as_tensor(a, device=device) for a in (par, order, offsets)],
            len(levels))


class _RigidTransform(torch.autograd.Function):
    """K3-chain forward and backward kernels."""

    @staticmethod
    def forward(ctx, rot_mats, joints, parents):
        B, J = joints.shape[:2]
        dev = joints.device
        (par, order, offsets), L = _schedule(parents, dev)
        posed = torch.empty((B, J, 3), dtype=torch.float32, device=dev)
        rel = torch.empty((B, J, 4, 4), dtype=torch.float32, device=dev)
        world = torch.empty_like(rel)
        if B > 0:
            CHAIN_KERNEL.launch("chain_forward", [
                rot_mats, joints, par, order, offsets, posed, rel, world,
                B, J, L])
        ctx.parents = parents
        ctx.save_for_backward(rot_mats, joints, world)
        return posed, rel, world

    @staticmethod
    def backward(ctx, d_posed, d_rel, d_world):
        rot_mats, joints, world = ctx.saved_tensors
        B, J = joints.shape[:2]
        dev = joints.device
        (par, order, offsets), L = _schedule(ctx.parents, dev)
        d_posed = (torch.zeros_like(joints) if d_posed is None
                   else d_posed.contiguous())
        d_rel = (torch.zeros_like(world) if d_rel is None
                 else d_rel.contiguous())
        if d_world is not None:
            d_world = d_world.contiguous()
        d_rot = torch.empty_like(rot_mats)
        d_joints = torch.empty_like(joints)
        if B > 0:
            CHAIN_KERNEL.launch("chain_backward", [
                rot_mats, joints, world, par, order, offsets, d_posed, d_rel,
                d_world, d_rot, d_joints, B, J, L])
        return d_rot, d_joints, None


def batch_rigid_transform(
    rot_mats: torch.Tensor,
    joints: torch.Tensor,
    parents: Sequence[int],
    levels: Sequence[np.ndarray] | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compose local rotations down the kinematic chain: the plain
    version for CPU tensors, kernel K3-chain for CUDA tensors (forward
    and backward; the level schedule is derived from ``parents``).

    rot_mats (B, J, 3, 3), joints (B, J, 3) rest-pose joints.
    Returns posed_joints (B, J, 3), rel_transforms (B, J, 4, 4) and the
    world transforms (B, J, 4, 4)."""
    if joints.device.type == "cpu":
        return batch_rigid_transform_plain(rot_mats, joints, parents, levels)
    if joints.device.type != "cuda":
        raise ValueError(f"batch_rigid_transform: unsupported device "
                         f"{joints.device}")
    parents = tuple(int(p) for p in np.asarray(parents))
    B, J = joints.shape[:2]
    if J > _CHAIN_MAX_JOINTS or len(parents) != J:
        raise ValueError(f"batch_rigid_transform: {J} joints with "
                         f"{len(parents)} parents (the kernel takes at most "
                         f"{_CHAIN_MAX_JOINTS})")
    dev = joints.device
    rot_mats, joints = rot_mats.contiguous(), joints.contiguous()
    check_cuda_input(rot_mats, "rot_mats", torch.float32, (B, J, 3, 3), dev)
    check_cuda_input(joints, "joints", torch.float32, (B, J, 3), dev)
    return _RigidTransform.apply(rot_mats, joints, parents)
