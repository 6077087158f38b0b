"""Parity of the port's mesh-mesh intersection
(``shapy_tpu_torch/ops/tri_tri.py``) with the JAX package's
(``shapy_tpu/ops/tri_tri.py``).

On the CPU :func:`mesh_mesh_intersection` runs its plain version, the
oracle of kernel K6 on the card. Both sides get the same f32 triangles,
made with numpy. Meshes share no vertex: where a vertex lies on the other
triangle's plane up to rounding, the sign decisions follow the summation
order, and the JAX code contracts a * b + c into FMAs under jit while the
port does not.

Tolerances: the faces, the order of each query's ids and the -1 padding
are identical; barycentrics within 1e-5 (f32 interpolation along an edge
and a 2x2 solve, rounded differently by the FMAs: ~8e-6 measured);
barycentrics against the JAX function's 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.models.body.assets import icosphere
from shapy_tpu.ops import tri_tri as jt
from shapy_tpu_torch.ops import tri_tri as tt
from shapy_tpu_torch.ops import (
    MeshMeshIntersection,
    mesh_mesh_intersection,
    point_to_barycentric,
)
from shapy_tpu_torch.ops.plane_slice import plane_slice_soa

BCS_TOL = 1e-5


def _both(query, target, max_collisions):
    want = jt.mesh_mesh_intersection(jnp.asarray(query), jnp.asarray(target),
                                     max_collisions)
    got = mesh_mesh_intersection(torch.from_numpy(query),
                                 torch.from_numpy(target), max_collisions)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _assert_same(want, got):
    (wf, wb), (gf, gb) = want, got
    assert gf.dtype == np.int32 and gb.dtype == np.float32
    assert gf.shape == wf.shape and gb.shape == wb.shape
    np.testing.assert_array_equal(gf, wf)
    np.testing.assert_allclose(gb, wb, atol=BCS_TOL)
    assert (gb[gf < 0] == 0).all()


def _spheres():
    """Batch 2: an icosphere against a shifted copy, and a shrunk copy
    against another shift (no axis-aligned shift: the vertices would meet
    the other mesh's planes)."""
    v, f = icosphere(2)
    tri = v[f].astype(np.float32)  # (320, 3, 3)
    query = np.stack([tri, tri * np.float32(0.9)])
    target = np.stack([tri + np.float32([0.2, 0.3, 0.4]),
                       tri + np.float32([0.5, 0.1, 0.05])])
    return query, target


def test_point_to_barycentric_matches_jax():
    rng = np.random.default_rng(0)
    # well-shaped triangles: a rotated equilateral one, perturbed
    base = np.asarray([[1.0, 0, 0], [-0.5, 0.87, 0], [-0.5, -0.87, 0]])
    rot = np.linalg.qr(rng.normal(size=(50, 3, 3)))[0]
    tri = (np.einsum("nij,kj->nki", rot, base) + rng.normal(size=(50, 1, 3))
           + rng.normal(size=(50, 3, 3)) * 0.1).astype(np.float32)
    w = rng.dirichlet(np.ones(3), size=50)
    p = np.einsum("nk,nkd->nd", w, tri).astype(np.float32)
    off = (p + rng.normal(size=(50, 3)) * 0.1).astype(np.float32)
    for q in (p, off):
        want = np.asarray(jt.point_to_barycentric(jnp.asarray(tri),
                                                  jnp.asarray(q)))
        got = point_to_barycentric(torch.from_numpy(tri), torch.from_numpy(q))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        if q is p:
            np.testing.assert_allclose(got.numpy(), w, atol=1e-5)


def test_two_crossing_triangles():
    target = np.asarray([[[[-1.0, -1, 0], [1, -1, 0], [0.2, 2, 0]]]],
                        np.float32)
    query = np.asarray([[[[0.0, -1, -1], [0, -1, 1], [0, 2, 0.3]]]],
                       np.float32)
    want, got = _both(query, target, 4)
    _assert_same(want, got)
    faces, bcs = got
    assert faces[0, 0] == 0 and (faces[0, 1:] == -1).all()
    # the endpoints, rebuilt in the target, lie on both planes x=0, z=0
    pts = np.einsum("ek,kd->ed", bcs[0, 0], target[0, 0])
    np.testing.assert_allclose(pts[:, [0, 2]], 0.0, atol=1e-5)


def test_disjoint_triangles():
    target = np.asarray([[[[0.0, 0, 0], [1, 0, 0], [0, 1, 0]]]], np.float32)
    query = np.asarray([[[[5.0, 5, 5], [6, 5, 5], [5, 6, 5]]]], np.float32)
    want, got = _both(query, target, 2)
    _assert_same(want, got)
    assert (got[0] == -1).all() and (got[1] == 0).all()


@pytest.mark.parametrize("max_collisions", [16, 2],
                         ids=["all-hits", "truncated"])
def test_shifted_spheres_match_jax(max_collisions):
    """Batch 2 of 320-face icospheres. At 16 every hit is kept; at 2 most
    crossing queries have more hits than slots, so the first two valid ids
    in index order must be the ones kept."""
    query, target = _spheres()
    want, got = _both(query, target, max_collisions)
    _assert_same(want, got)
    faces = got[0].reshape(2, 320, max_collisions)
    hits = (faces >= 0).sum(-1)
    assert hits.sum() > 100
    # ids ascend inside each query's slots, then -1
    for row in faces.reshape(-1, max_collisions):
        kept = row[row >= 0]
        assert (np.diff(kept) > 0).all() and (row[len(kept):] == -1).all()
    full = mesh_mesh_intersection(torch.from_numpy(query),
                                  torch.from_numpy(target), 16)[0].numpy()
    full = full.reshape(2, 320, 16)
    if max_collisions == 16:
        assert (hits < 16).all()  # nothing was cut
    else:
        assert ((full >= 0).sum(-1) > 2).any()  # something was cut
        np.testing.assert_array_equal(faces, full[..., :2])


def test_endpoints_lie_on_both_planes():
    query, target = _spheres()
    faces, bcs = (t.numpy() for t in mesh_mesh_intersection(
        torch.from_numpy(query), torch.from_numpy(target), 16))
    for b in range(2):
        slots = np.nonzero(faces[b] >= 0)[0]
        tri_t = target[b, faces[b, slots]]
        tri_q = query[b, slots // 16]
        pts = np.einsum("sek,skd->sed", bcs[b, slots], tri_t)
        for tri in (tri_t, tri_q):
            n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
            n /= np.linalg.norm(n, axis=-1, keepdims=True)
            dist = np.einsum("sed,sd->se", pts - tri[:, None, 0], n)
            assert np.abs(dist).max() < 1e-5


@pytest.mark.parametrize("scale", [1.0, 0.005], ids=["large", "small"])
def test_barycentrics_follow_the_jax_clamp(scale):
    """``point_to_barycentric`` clamps d00 d11 - d01^2 = (2 area)^2 at
    1e-9 in absolute units: for a target of 5 mm legs ((2 area)^2 = 6e-10
    m^4) the port returns JAX's clamped barycentrics, whose rebuilt
    endpoints leave the query's plane, while the same pair at 1 m scale
    rebuilds them on it."""
    target = np.asarray([[[[0.0, 0, 0], [1, 0, 0], [0, 1, 0]]]]) * scale
    query = np.asarray([[[[0.3, 0.2, -0.5], [0.3, 0.2, 0.5],
                          [0.3, 1.2, 0.1]]]]) * scale
    target, query = target.astype(np.float32), query.astype(np.float32)
    want, got = _both(query, target, 2)
    _assert_same(want, got)
    faces, bcs = got
    assert faces[0, 0] == 0
    pts = bcs[0, 0] @ target[0, 0]
    np.testing.assert_allclose(pts[:, 2], 0.0, atol=1e-7)  # target's plane
    off = np.abs(pts[:, 0] - 0.3 * scale).max()  # query's plane x = 0.3 s
    if scale == 1.0:
        assert off < 1e-6
    else:
        assert off > 1e-4


def test_fewer_targets_than_slots_pads():
    """F < max_collisions: the k = min(max_collisions, F) branch pads the
    rest of each query's slots with -1 and zeros."""
    query, target = _spheres()
    target = np.ascontiguousarray(target[:, 40:48])
    want, got = _both(query, target, 16)
    _assert_same(want, got)
    assert (got[0] >= 0).any()


def test_plane_query_matches_exact_slice():
    """The reference's own use: a horizontal plane (the +-1 m quad of two
    triangles) as the query finds exactly the faces that the port's
    exact-mode slice (``plane_slice_soa``) marks as crossed, and every
    endpoint lies at the plane's height."""
    verts, faces = icosphere(2)
    verts = verts * np.asarray([0.3, 0.8, 0.25])
    tris = verts[faces].astype(np.float32)[None]
    h = 0.31
    plane = np.asarray([[[-1.0, h, -1], [1, h, -1], [1, h, 1]],
                        [[-1.0, h, -1], [1, h, 1], [-1, h, 1]]],
                       np.float32)[None]
    want, got = _both(plane, tris, 128)
    _assert_same(want, got)
    isect = MeshMeshIntersection(max_collisions=128)
    coll_faces, coll_bcs = (t.numpy() for t in isect(
        torch.from_numpy(plane), torch.from_numpy(tris)))
    found = set(coll_faces[0][coll_faces[0] >= 0].tolist())

    t = torch.from_numpy(tris).permute(0, 3, 2, 1)  # (1, xyz, vertex, F)
    _, _, mask = plane_slice_soa(t[:, 1], t[:, 0], t[:, 2],
                                 torch.tensor([h]))
    F = tris.shape[1]
    expected = set(np.nonzero(mask[0, :F].numpy())[0].tolist())
    assert found == expected and len(found) > 10

    for slot in np.nonzero(coll_faces[0] >= 0)[0]:
        pts = coll_bcs[0, slot] @ tris[0, coll_faces[0, slot]]
        np.testing.assert_allclose(pts[:, 1], h, atol=1e-5)


def test_plain_version_is_the_cpu_path():
    query, target = _spheres()
    q, t = torch.from_numpy(query), torch.from_numpy(target)
    a = mesh_mesh_intersection(q, t, 4, query_chunk=7)
    b = tt.mesh_mesh_intersection_plain(q, t, 4, query_chunk=320)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
