"""K6's design replayed on the CPU (``shapy_tpu_torch/ops/tri_tri.py``):
the targets' Morton order, the cluster and supercluster boxes, the culled
candidate set, the hit lists sorted by id and the overflow regime, held
against the plain all-pairs version and the JAX package's
``mesh_mesh_intersection``.

The replay repeats what kernel K6 (``csrc/tri_tri.cu``) does; the kernel
runs only on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``). Tolerances: ids and barycentrics bit-equal to the
plain version (the same arithmetic, only culled); against JAX the ids
equal and the barycentrics within ``test_torch_tri_tri.py``'s 1e-5 (the
JAX code contracts into FMAs under jit).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.models.body.assets import icosphere
from shapy_tpu.ops import tri_tri as jt
from shapy_tpu_torch.ops import tri_tri as tt

BCS_TOL = 1e-5


def _spheres(subdivisions):
    """Batch 2: an icosphere against a shifted copy, and a shrunk copy
    against another shift. The shifts leave no vertex within f32 rounding
    of the other mesh's planes, where the JAX side's FMAs (jit contracts a
    * b + c) would take the other side (``test_torch_tri_tri.py``'s shifts
    leave one at subdivision 1)."""
    v, f = icosphere(subdivisions)
    tri = v[f].astype(np.float32)
    query = np.stack([tri, tri * np.float32(0.9)])
    target = np.stack([tri + np.float32([0.213, 0.307, 0.419]),
                       tri + np.float32([0.523, 0.117, 0.061])])
    return query, target


def _planes():
    """The plane quads of ``test_plane_query_matches_exact_slice``: a +-1 m
    horizontal quad (two triangles) against an ellipsoid."""
    verts, faces = icosphere(2)
    verts = verts * np.asarray([0.3, 0.8, 0.25])
    tris = verts[faces].astype(np.float32)[None]
    h = 0.31
    plane = np.asarray([[[-1.0, h, -1], [1, h, -1], [1, h, 1]],
                        [[-1.0, h, -1], [1, h, 1], [-1, h, 1]]],
                       np.float32)[None]
    return plane, tris


def _check(query, target, M, plan=None):
    """The replay against the plain version (bit for bit) and JAX."""
    q, t = torch.from_numpy(query), torch.from_numpy(target)
    faces, bcs, info = tt.mesh_mesh_intersection_replay(q, t, M, plan)
    want_f, want_b = tt.mesh_mesh_intersection_plain(q, t, M)
    assert torch.equal(faces, want_f) and torch.equal(bcs, want_b)
    jf, jb = jt.mesh_mesh_intersection(jnp.asarray(query),
                                       jnp.asarray(target), M)
    np.testing.assert_array_equal(faces.numpy(), np.asarray(jf))
    np.testing.assert_allclose(bcs.numpy(), np.asarray(jb), atol=BCS_TOL)
    return faces, info


@pytest.mark.parametrize("subdivisions", [1, 2])
@pytest.mark.parametrize("M", [16, 2], ids=["all-hits", "more-hits-than-M"])
def test_replay_matches_plain_and_jax(subdivisions, M):
    query, target = _spheres(subdivisions)
    faces, info = _check(query, target, M)
    F = target.shape[1]
    hits = info["hits"]
    assert int(hits.sum()) > 50
    if M == 2:
        assert bool((hits > 2).any())  # some query keeps its 2 smallest ids
    # the default list holds every query's hits: no sweep
    assert not bool(info["overflowed"].any())
    assert info["superclusters_tested"] == -(-(-(-F // 32)) // 32)
    assert bool((info["faces_tested"] <= F).all())
    assert bool((info["faces_tested"] >= info["box_passed"]).all())
    assert bool((info["box_passed"] >= hits).all())


@pytest.mark.parametrize("list_size", [1, 2, 4])
def test_list_overflow_takes_the_index_order_sweep(list_size):
    """A list smaller than a query's hits: those queries take the sweep,
    whose first M hits in index order are the same ids and bits."""
    query, target = _spheres(2)
    plan = tt.TriTriPlan(10, list_size, 1)
    faces, info = _check(query, target, 16, plan)
    over = info["overflowed"]
    assert bool(over.any()) and bool((over == (info["hits"] > list_size))
                                     .all())


def test_fewer_targets_than_slots():
    query, target = _spheres(2)
    target = np.ascontiguousarray(target[:, 40:48])
    faces, info = _check(query, target, 16)
    assert bool((faces >= 0).any())
    assert info["cbox"].shape == (2, 6, 1) and info["scbox"].shape == (2, 6, 1)


@pytest.mark.parametrize("M", [128, 4], ids=["all-hits", "truncated"])
def test_plane_quads(M):
    plane, tris = _planes()
    faces, info = _check(plane, tris, M)
    assert int(info["hits"].min()) > 4


def test_order_is_the_stable_morton_sort():
    """The order sorts the targets by the Morton code of their box centres
    (32 cells an axis of the body's box of centres, f32), ties in id
    order; recomputed here with numpy."""
    _, target = _spheres(2)
    order, cbox, scbox = tt.target_order_replay(torch.from_numpy(target))
    for b in range(2):
        c = (target[b].min(1) + target[b].max(1)) * np.float32(0.5)
        lo, hi = c.min(0), c.max(0)
        scale = np.float32(32) / (hi - lo)
        cell = np.minimum(((c - lo) * scale).astype(np.int64), 31)
        code = np.zeros(len(c), np.int64)
        for bit in range(5):
            for k in range(3):
                code |= ((cell[:, k] >> bit) & 1) << (3 * bit + k)
        want = np.lexsort((np.arange(len(c)), code))
        np.testing.assert_array_equal(order[b].numpy(), want)
        # each cluster box holds its members' boxes, each supercluster box
        # its clusters'
        mn, mx = target[b].min(1)[want], target[b].max(1)[want]
        for k in range(cbox.shape[-1]):
            sl = slice(32 * k, 32 * k + 32)
            np.testing.assert_array_equal(cbox[b, :3, k].numpy(),
                                          mn[sl].min(0))
            np.testing.assert_array_equal(cbox[b, 3:, k].numpy(),
                                          mx[sl].max(0))
        np.testing.assert_array_equal(scbox[b, :3, 0].numpy(),
                                      cbox[b, :3, :32].min(1).values.numpy())


def test_replay_raises_where_a_cluster_would_drop_a_hit(monkeypatch):
    """The replay's exactness check: cluster boxes that miss a member's
    box (here shrunk to a point) drop hits, and the replay says so."""
    query, target = _spheres(1)
    real = tt.target_order_replay

    def shrunk(t):
        order, cbox, scbox = real(t)
        return order, torch.zeros_like(cbox), scbox

    monkeypatch.setattr(tt, "target_order_replay", shrunk)
    with pytest.raises(AssertionError, match="dropped a hit"):
        tt.mesh_mesh_intersection_replay(torch.from_numpy(query),
                                         torch.from_numpy(target), 16)


@pytest.mark.parametrize("B, Q, F, M", [
    (1, 20908, 20908, 256), (4, 20908, 20908, 256), (4, 6, 20908, 1024),
    (2, 320, 320, 16), (2, 320, 8, 16), (1, 3, 1, 1), (1, 5, 0, 4),
    (3, 10, 100, 5000), (1, 500, 50000, 300)])
def test_plan_is_a_function_of_the_shapes(B, Q, F, M):
    plan = tt.tri_tri_plan(B, Q, F, M)
    assert plan == tt.tri_tri_plan(B, Q, F, M)
    assert plan.clusters == -(-F // 32)
    n = plan.list_size
    assert n & (n - 1) == 0 and 32 <= n <= 1024
    assert n >= min(M, F, 1024)
    assert plan.team == (8 if B * Q < 396 else 1)
