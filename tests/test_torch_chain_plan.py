"""K3-chain's packed tree and its replays on the CPU
(``core/kinematics.py``).

``_schedule`` packs a tree into the ``Schedule`` that both kernels take
by value (``csrc/kinematic_chain.cu``): every non-root joint must appear
exactly once among its parent's children, in index order, every depth
must be its parent's plus one (the levels in order), and the struct must
keep its size (under the 4 KB of a kernel's parameters). The replays of
the kernels' order (``chain_forward_replay``, ``chain_backward_replay``)
must agree with autograd through the plain version in f64 and with the
JAX ``batch_rigid_transform`` and its VJP (atol 1e-5; on the 64-joint
path and star 1e-5 of the largest gradient: a sum over 63 children or
down 64 levels reaches ~75 on the path, where the plain version in f32
is itself 2.3e-5 from f64), and give a body the
same bits alone as in a batch of 48. The card holds the kernels bit-equal
to the replays (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import re
from pathlib import Path

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.core.kinematics import (
    batch_rigid_transform as jax_batch_rigid_transform,
)
from shapy_tpu_torch.core.kinematics import (
    _SCHEDULE_BYTES,
    _schedule,
    batch_rigid_transform_plain,
    chain_backward_replay,
    chain_forward_replay,
    compute_level_schedule,
)
from shapy_tpu_torch.core.rotations import aa_to_rotmat
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
from tests.chain_trees import TREES

SOURCE = (Path(__file__).resolve().parents[1] / "shapy_tpu_torch" / "csrc"
          / "kinematic_chain.cu")


def _unpack(parents):
    raw = bytes(_schedule(tuple(parents)))
    J, L = np.frombuffer(raw[:8], np.int32)
    node = np.frombuffer(raw[8:8 + 256], np.uint32)
    children = np.frombuffer(raw[8 + 256:], np.uint8)
    return int(J), int(L), node, children


@pytest.mark.parametrize("name", sorted(TREES))
def test_schedule_lists_each_child_once_in_index_order(name):
    parents = TREES[name]
    J, L, node, children = _unpack(parents)
    assert J == len(parents) and len(bytes(_schedule(tuple(parents)))) == (
        _SCHEDULE_BYTES) <= 4096
    par = (node[:J] & 0xFF).astype(np.int64) - 1
    depth = node[:J] >> 8 & 0xFF
    first, count = node[:J] >> 16 & 0xFF, node[:J] >> 24
    assert par[0] == -1 and list(par[1:]) == list(parents[1:])
    # CSR: consecutive slots, every non-root joint once, in index order
    assert list(first) == list(np.cumsum([0] + list(count))[:-1])
    seen = []
    for j in range(J):
        kids = list(children[first[j]:first[j] + count[j]])
        assert kids == sorted(kids)
        assert all(parents[c] == j for c in kids)
        seen += kids
    assert sorted(seen) == list(range(1, J)) and len(seen) == J - 1
    # the levels: each depth its parent's plus one, in order
    assert depth[0] == 0 and all(depth[j] == depth[parents[j]] + 1
                                 for j in range(1, J))
    assert L == depth.max() + 1
    levels = compute_level_schedule(np.asarray(parents))
    assert len(levels) == L
    for d, level in enumerate(levels):
        assert list(level) == list(np.nonzero(depth == d)[0])


def test_schedule_matches_the_kernel_source():
    text = SOURCE.read_text()
    assert f"sizeof(Schedule) == {_SCHEDULE_BYTES}" in text
    assert re.search(r"constexpr int kMaxJoints = 64;", text)


def test_schedule_trees_are_the_ones_named():
    data = make_synthetic_model_data("smplx", subdivisions=1)
    synthetic = data["kintree_table"][0].astype(np.int64)
    synthetic[0] = -1
    assert list(synthetic) == TREES["synthetic_smplx"]
    depths = {n: len(compute_level_schedule(np.asarray(t)))
              for n, t in TREES.items()}
    assert depths == {"smpl": 9, "smplh": 11, "smplx": 11,
                      "synthetic_smplx": 6, "path64": 64, "star64": 2}
    smplx = np.asarray(TREES["smplx"])
    assert [int((smplx == w).sum()) for w in (20, 21)] == [5, 5]
    # the card's check (chip_smoke.check_k3chain) runs the same trees
    assert chip_smoke.SMPLX_PARENTS == tuple(TREES["smplx"])
    assert chip_smoke.PATH64_PARENTS == tuple(TREES["path64"])


def test_schedule_refuses_a_parent_after_its_joint():
    with pytest.raises(ValueError, match="precede"):
        _schedule((-1, 2, 0))


def _inputs(parents, B, seed):
    gen = torch.Generator().manual_seed(seed)
    J = len(parents)
    rot = aa_to_rotmat(torch.randn(B, J, 3, generator=gen, dtype=torch.float64)
                       * 0.3).float()
    joints = torch.randn(B, J, 3, generator=gen) * 0.3
    cts = [torch.randn(s, generator=gen) for s in
           ((B, J, 3), (B, J, 4, 4), (B, J, 4, 4))]
    return rot, joints, cts


def _limit(name, want):
    return 1e-5 * (max(1.0, float(want.abs().max()))
                   if name in ("path64", "star64") else 1.0)


@pytest.mark.parametrize("name", ["synthetic_smplx", "smplx", "path64",
                                  "star64", "smpl", "smplh"])
def test_chain_replays_match_f64_autograd_and_jax(name):
    parents = TREES[name]
    rot, joints, cts = _inputs(parents, 8, seed=len(parents))
    got = chain_forward_replay(rot, joints, parents)
    r64 = rot.double().requires_grad_()
    j64 = joints.double().requires_grad_()
    want = batch_rigid_transform_plain(r64, j64, parents)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g.double(), w.detach(), rtol=0, atol=1e-5)
    grads = torch.autograd.grad(want, (r64, j64), [c.double() for c in cts])
    got_b = chain_backward_replay(rot, joints, parents, *cts)
    for g, w in zip(got_b, grads):
        torch.testing.assert_close(g.double(), w, rtol=0,
                                   atol=_limit(name, w))

    def f(r, j):
        return jax_batch_rigid_transform(r, j, parents)

    jout, vjp = jax.vjp(f, jnp.asarray(rot.numpy()), jnp.asarray(
        joints.numpy()))
    for g, w in zip(got, jout):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    jgrads = vjp(tuple(jnp.asarray(c.numpy()) for c in cts))
    for g, w in zip(got_b, jgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=_limit(
            name, torch.tensor(w)))


@pytest.mark.parametrize("name", ["synthetic_smplx", "smplx", "path64"])
def test_chain_replays_are_batch_invariant(name):
    parents = TREES[name]
    rot, joints, cts = _inputs(parents, 48, seed=7)
    fwd = chain_forward_replay(rot, joints, parents)
    bwd = chain_backward_replay(rot, joints, parents, *cts)
    for i in (0, 23, 47):
        sl = slice(i, i + 1)
        one = chain_forward_replay(rot[sl], joints[sl], parents)
        assert all(torch.equal(a[0], b[i]) for a, b in zip(one, fwd))
        one = chain_backward_replay(rot[sl], joints[sl], parents,
                                    *(c[sl] for c in cts))
        assert all(torch.equal(a[0], b[i]) for a, b in zip(one, bwd))
    # no d_world is a zero d_world
    zero = chain_backward_replay(rot, joints, parents, cts[0], cts[1],
                                 torch.zeros_like(cts[2]))
    none = chain_backward_replay(rot, joints, parents, cts[0], cts[1])
    assert all(torch.equal(a, b) for a, b in zip(zero, none))
