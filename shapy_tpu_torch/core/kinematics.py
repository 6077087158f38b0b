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

import ctypes
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from shapy_tpu_torch.utils.cuda_kernels import CudaKernel, check_cuda_input

CHAIN_KERNEL = CudaKernel("kinematic_chain.cu", {
    "chain_forward": "ppppp i pp",
    "chain_backward": "pppppppp i pp",
})
_CHAIN_MAX_JOINTS = 64  # the kernels' kMaxJoints
_SCHEDULE_BYTES = 328  # sizeof(Schedule) in csrc/kinematic_chain.cu


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


def _children(parents: Sequence[int]) -> List[List[int]]:
    """Each joint's children, in index order (joint 0 is the root)."""
    kids: List[List[int]] = [[] for _ in parents]
    for j in range(1, len(parents)):
        kids[int(parents[j])].append(j)
    return kids


@functools.lru_cache(maxsize=16)
def _schedule(parents: Tuple[int, ...]):
    """The tree packed as K3-chain's ``Schedule`` (cached per tree): J and
    the number of levels (int32 each), then a word per joint (the parent
    + 1, 0 for the root; the depth; the first child's slot in the
    children list; the number of children; a byte each from the lowest)
    and the children list, each joint's children in index order (CSR).
    Returns the ctypes buffer, whose address the kernels take. Every
    parent must precede its joint."""
    J = len(parents)
    if any(not 0 <= p < j for j, p in enumerate(parents) if j > 0):
        raise ValueError("batch_rigid_transform: every parent must precede "
                         "its joint")
    depth = np.zeros(J, np.int64)
    for j in range(1, J):
        depth[j] = depth[parents[j]] + 1
    kids = _children(parents)
    first = np.cumsum([0] + [len(k) for k in kids])[:-1]
    node = np.zeros(_CHAIN_MAX_JOINTS, np.uint32)
    for j in range(J):
        par = 0 if j == 0 else parents[j] + 1
        node[j] = par | depth[j] << 8 | first[j] << 16 | len(kids[j]) << 24
    children = np.zeros(_CHAIN_MAX_JOINTS, np.uint8)
    flat = [c for k in kids for c in k]
    children[:len(flat)] = flat
    raw = (np.asarray([J, depth.max() + 1], np.int32).tobytes()
           + node.tobytes() + children.tobytes())
    assert len(raw) == _SCHEDULE_BYTES
    return ctypes.create_string_buffer(raw, len(raw))


class _RigidTransform(torch.autograd.Function):
    """K3-chain forward and backward kernels."""

    @staticmethod
    def forward(ctx, rot_mats, joints, parents):
        B, J = joints.shape[:2]
        dev = joints.device
        schedule = ctypes.addressof(_schedule(parents))
        posed = torch.empty((B, J, 3), dtype=torch.float32, device=dev)
        rel = torch.empty((B, J, 4, 4), dtype=torch.float32, device=dev)
        world = torch.empty_like(rel)
        if B > 0:
            CHAIN_KERNEL.launch("chain_forward", [
                rot_mats, joints, posed, rel, world, B, schedule])
        ctx.parents = parents
        ctx.save_for_backward(rot_mats, joints, world)
        return posed, rel, world

    @staticmethod
    def backward(ctx, d_posed, d_rel, d_world):
        rot_mats, joints, world = ctx.saved_tensors
        B = joints.shape[0]
        schedule = ctypes.addressof(_schedule(ctx.parents))
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
                rot_mats, joints, world, d_posed, d_rel, d_world, d_rot,
                d_joints, B, schedule])
        return d_rot, d_joints, None


def _compose_rows(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """(..., 3, k) rows of P (3 x 3 at least) times Q (3, k) as K3-chain
    sums them: ``(P[r, 0] Q[0, c] + P[r, 1] Q[1, c]) + P[r, 2] Q[2, c]``,
    each product and sum rounded on its own."""
    s = P[..., :, 0:1] * Q[..., 0:1, :] + P[..., :, 1:2] * Q[..., 1:2, :]
    return s + P[..., :, 2:3] * Q[..., 2:3, :]


def chain_forward_replay(rot_mats: torch.Tensor, joints: torch.Tensor,
                         parents: Sequence[int]
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3-chain's forward in plain PyTorch with the kernel's roundings
    (every product and sum rounded as written, in its order): the
    kernel's bits, on any device. Takes and returns what
    :func:`batch_rigid_transform` does; f32."""
    par = np.asarray(parents, np.int64)
    levels = compute_level_schedule(par)
    a = joints.clone()
    a[:, 1:] = joints[:, 1:] - joints[:, par[1:]]
    local = torch.cat([rot_mats, a[..., None]], -1)  # (B, J, 3, 4)
    W = local.clone()
    for level in levels[1:]:
        lvl = torch.as_tensor(level, dtype=torch.int64, device=joints.device)
        P = W[:, torch.as_tensor(par[level], device=joints.device)]
        Wl = _compose_rows(P, local[:, lvl])
        Wl[..., 3] = Wl[..., 3] + P[..., 3]
        W[:, lvl] = Wl
    M, t = W[..., :3], W[..., 3]
    rotated = _compose_rows(M, joints[..., None])[..., 0]
    bottom = torch.zeros_like(W[..., :1, :])
    bottom[..., 3] = 1.0
    world = torch.cat([W, bottom], -2)
    rel = torch.cat([torch.cat([M, (t - rotated)[..., None]], -1), bottom],
                    -2)
    return t.clone(), rel, world


def chain_backward_replay(rot_mats: torch.Tensor, joints: torch.Tensor,
                          parents: Sequence[int], d_posed: torch.Tensor,
                          d_rel: torch.Tensor,
                          d_world: torch.Tensor | None = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3-chain's backward in plain PyTorch with the kernel's roundings
    and order (each parent adds its children in index order): (d_rot,
    d_joints), the kernel's bits, on any device. ``d_world`` None is
    zero, as the kernel takes it."""
    par = np.asarray(parents, np.int64)
    levels = compute_level_schedule(par)
    kids = _children(par)
    dev = joints.device
    _, _, world = chain_forward_replay(rot_mats, joints, parents)
    M = world[..., :3, :3]
    dr = d_rel[..., :3, :]
    drt = dr[..., 3]  # (B, J, 3)
    G = torch.cat([dr[..., :3] - drt[..., None] * joints[..., None, :],
                   (d_posed + drt)[..., None]], -1)  # (B, J, 3, 4)
    if d_world is not None:
        G = G + d_world[..., :3, :]
    # -(M^T d(rel translation)), each entry summed over the rows in order
    Dd = -_compose_rows(M.transpose(-1, -2), drt[..., None])[..., 0]

    def rank(lv, k):  # the joints of lv with a k-th child, and that child
        js = [j for j in lv if len(kids[j]) > k]
        return (torch.as_tensor(js, dtype=torch.int64, device=dev),
                torch.as_tensor([kids[j][k] for j in js], dtype=torch.int64,
                                device=dev))

    for level in reversed(levels[:-1]):
        for k in range(max(len(kids[j]) for j in level)):
            js, cs = rank(level, k)
            Gc, R = G[:, cs], rot_mats[:, cs]
            a = joints[:, cs] - joints[:, js]
            # (dM_c R_c^T)[r][i] + dt_c[r] a_c[i], summed as the kernel
            upd = (_compose_rows(Gc, R.transpose(-1, -2))
                   + Gc[..., 3:4] * a[..., None, :])
            g = G[:, js]
            G[:, js] = torch.cat([g[..., :3] + upd,
                                  (g[..., 3] + Gc[..., 3])[..., None]], -1)
    Mp = torch.cat([torch.eye(3, dtype=M.dtype, device=dev).expand(
        M.shape[0], 1, 3, 3), M[:, par[1:]]], 1)
    # M_p^T [dM | dt]: entry (i, c) summed over the rows in order
    MG = _compose_rows(Mp.transpose(-1, -2), G)
    d_rot = torch.cat([G[:, :1, :, :3], MG[:, 1:, :, :3]], 1)
    Da = torch.cat([G[:, :1, :, 3], MG[:, 1:, :, 3]], 1)
    d_joints = Dd + Da
    for k in range(max(len(c) for c in kids)):
        js, cs = rank(range(len(par)), k)
        d_joints[:, js] = d_joints[:, js] - Da[:, cs]
    return d_rot, d_joints


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
