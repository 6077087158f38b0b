"""Parity of the port's triangle (array-of-structures) measurement surface
(``BodyMeasurements.forward`` and the functions under it, the plain
version of kernel K1-AoS) with the JAX package's.

Shaped bodies from seeded betas on the synthetic SMPL-X mesh
(``subdivisions=2``, batch 2) go to both sides as ``v[:, faces]``, and
hand-made triangles test the slice's edge cases. The JAX functions run
eagerly: under ``jax.jit`` XLA contracts a * b + c into FMAs and moves hit
decisions.

Tolerances: masks equal; slice points 1e-6 m (the same f32 operations);
circumferences and heights 1e-6 m and mass rel 1e-6 (sums of the same
terms, reduced in another order); gradients 1e-4 of the largest (the
hull's max / min and the centroid's sums in another order); exact hulls
1e-9 m (the same points, f64 on the host).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.core import geometry as jgeometry
from shapy_tpu.measure import cwh as jcwh
from shapy_tpu.measure import measurements as jmeas
from shapy_tpu.ops import convex_hull as jhull
from shapy_tpu.ops import plane_slice as jslice
from shapy_tpu_torch.core import geometry
from shapy_tpu_torch.measure import BodyMeasurements, MeasurementAnchors
from shapy_tpu_torch.measure.cwh import ChestWaistHipsMeasurements
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
from shapy_tpu_torch.ops import convex_hull, plane_slice

torch.set_num_threads(2)
PLANES = ("chest", "waist", "hips")
MODES = ("reference", "exact")


@pytest.fixture(scope="module")
def bodies():
    data = make_synthetic_model_data("smplx", subdivisions=2, seed=0)
    v_t = data["v_template"].astype(np.float32)
    dirs = data["shapedirs"][:, :, :10].astype(np.float32)
    faces = data["f"]
    betas = np.random.default_rng(0).normal(size=(2, 10)) * 1.5
    verts = (v_t[None] + np.einsum("bl,vkl->bvk", betas, dirs)).astype(
        np.float32)
    anchors = MeasurementAnchors.synthetic(faces, v_t)
    janchors = jmeas.MeasurementAnchors.synthetic(faces, v_t)
    return faces, verts, verts[:, faces], anchors, janchors


def _modules(bodies, mode, cls=BodyMeasurements,
             jcls=jmeas.BodyMeasurements):
    faces, _, _, anchors, janchors = bodies
    return (cls(anchors, faces, 128, slice_mode=mode),
            jcls(anchors=janchors, num_hull_directions=128, slice_mode=mode))


def _edge_triangles():
    """Random triangles around y = 0.1, then a vertex on the plane, an
    edge on it, faces parallel to it (on it and off it) and faces crossed
    at a vertex and an edge."""
    rng = np.random.default_rng(7)
    tris = rng.uniform(-0.8, 0.8, size=(2, 64, 3, 3)).astype(np.float32)
    tris[..., 1] = rng.uniform(-0.2, 0.4, size=(2, 64, 3))
    h = np.float32(0.1)
    tris[:, 0, 0, 1] = h                       # one vertex on the plane
    tris[:, 1, :2, 1] = h                      # an edge on the plane
    tris[:, 2, :, 1] = h                       # the face lies on it
    tris[:, 3, :, 1] = 0.3                     # parallel, above
    tris[:, 4, :, 1] = [h, 0.0, 0.2]           # crossed at a vertex
    return tris, np.full((2,), h, np.float32)


def test_plane_slices_and_hull_match_jax():
    tris, h = _edge_triangles()
    tt, th = torch.from_numpy(tris), torch.from_numpy(h)
    for fn, jfn in ((plane_slice.plane_slice_triangles,
                     jslice.plane_slice_triangles),
                    (plane_slice.plane_slice_reference,
                     jslice.plane_slice_reference)):
        pts, mask = fn(tt, th)
        jpts, jmask = jfn(jnp.asarray(tris), jnp.asarray(h))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=1e-6,
                                   rtol=0)
        assert mask.any()
        flat = pts.reshape(2, -1, 3)[..., [0, 2]]
        fmask = mask if mask.shape[-1] == flat.shape[1] else \
            torch.repeat_interleave(mask, 2, dim=-1)
        got = convex_hull.hull_perimeter_support(flat, fmask, 64)
        want = jhull.hull_perimeter_support(
            jnp.asarray(flat.numpy()), jnp.asarray(fmask.numpy()), 64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)
        for b in range(2):
            p2, m2 = flat[b].numpy(), fmask[b].numpy()
            assert convex_hull.hull_perimeter_exact_np(p2, m2) == \
                pytest.approx(jhull.hull_perimeter_exact_np(p2, m2),
                              abs=1e-9)
    # A vertex or an edge on the plane is a miss in exact mode, and a face
    # on the plane or parallel to it has no crossing.
    valid = plane_slice.plane_slice_triangles(tt, th)[1]
    assert not valid[:, 1:5].any()


def test_geometry_helpers_match_jax(bodies):
    faces, verts, tris = bodies[0], bodies[1], bodies[2]
    got = geometry.gather_triangles(torch.from_numpy(verts),
                                    torch.from_numpy(faces))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jgeometry.gather_triangles(jnp.asarray(verts), faces)))
    t, jt = torch.from_numpy(tris), jnp.asarray(tris)
    np.testing.assert_allclose(geometry.signed_volume(t).numpy(), np.asarray(
        jgeometry.signed_volume(jt)), rtol=1e-6)
    bary = (0.2, 0.3, 0.5)
    np.testing.assert_allclose(
        geometry.face_barycentric_point(t, 7, bary).numpy(),
        np.asarray(jgeometry.face_barycentric_point(jt, 7, jnp.asarray(
            bary))), atol=1e-7)


def _check_outputs(got, want, keys=("mass", "height") + PLANES):
    assert set(got) == set(want) == set(keys)
    for k in keys:
        assert set(got[k]) == set(want[k]), k
        for field, g in got[k].items():
            w = np.asarray(want[k][field])
            assert tuple(g.shape) == w.shape, (k, field)
            if field == "valid_points":
                np.testing.assert_array_equal(g.numpy(), w)
            elif k == "mass":
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-6)
            else:
                np.testing.assert_allclose(g.detach().numpy(), w, atol=1e-6,
                                           rtol=0, err_msg=f"{k} {field}")


@pytest.mark.parametrize("mode", MODES)
def test_forward_matches_jax(bodies, mode):
    tm, jm = _modules(bodies, mode)
    tris = bodies[2]
    got = tm(torch.from_numpy(tris))["measurements"]
    _check_outputs(got, jm(jnp.asarray(tris))["measurements"])
    assert got["chest"]["valid_points"].any(dim=-1).all()
    # The same faces in the same order as the vertex entry on all faces.
    soa = tm.forward_from_vertices(torch.from_numpy(bodies[1]),
                                   use_face_subsets=False)["measurements"]
    for k in ("mass", "height") + PLANES:
        for field, v in soa[k].items():
            np.testing.assert_allclose(got[k][field].detach().numpy(),
                                       v.numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=f"{k} {field}")
    # forward is the plain version on CPU tensors.
    plain = tm.forward_plain(torch.from_numpy(tris))["measurements"]
    for k in got:
        for field, v in got[k].items():
            assert torch.equal(v, plain[k][field]), (k, field)


@pytest.mark.parametrize("flags", [
    dict(compute_mass=False),
    dict(compute_height=False, compute_waist=False),
    dict(compute_chest=False, compute_hips=False, compute_mass=False),
])
def test_compute_flags_match_jax(bodies, flags):
    tm, jm = _modules(bodies, "reference")
    tris = bodies[2]
    got = tm.forward(torch.from_numpy(tris), **flags)["measurements"]
    want = jm.forward(jnp.asarray(tris), **flags)["measurements"]
    _check_outputs(got, want, tuple(want))
    t, jt = torch.from_numpy(tris), jnp.asarray(tris)
    np.testing.assert_allclose(tm.compute_mass(t).numpy(),
                               np.asarray(jm.compute_mass(jt)), rtol=1e-6)
    h, pts = tm.compute_height(t)
    jh, jpts = jm.compute_height(jt)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-6)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=1e-6)
    anchor = tm.anchors.waist
    one = tm.compute_periphery(t, anchor)
    jone = jm.compute_periphery(jt, jm.anchors.waist)
    _check_outputs({"waist": one}, {"waist": jone}, ("waist",))


@pytest.mark.parametrize("mode", MODES)
def test_forward_gradient_matches_jax(bodies, mode):
    """The gradient of the weighted sum of the values, in the vertices
    through ``v[:, faces]`` (what the fit differentiates), and of mass and
    height in the triangles themselves.

    Per triangle, the circumferences' gradients are not comparable: a
    crossed edge is shared by two faces whose crossing points agree only
    to rounding, and which of the two wins a direction's max depends on
    the last bit of the centroid's sum, reduced in another order on each
    side; per vertex the two shares land on the same edge's vertices."""
    tm, jm = _modules(bodies, mode)
    faces, verts, tris = bodies[0], bodies[1], bodies[2]
    w = dict(zip(("mass", "height") + PLANES, (1.0, 10.0, 10.0, 10.0, 10.0)))

    def jloss(t):
        m = jm.forward(t)["measurements"]
        return sum(wk * jnp.sum(m[k]["tensor"]) for k, wk in w.items())

    def jloss_mass_height(t):
        return (w["mass"] * jnp.sum(jm.compute_mass(t))
                + w["height"] * jnp.sum(jm.compute_height(t)[0]))

    want_v = np.asarray(jax.grad(lambda v: jloss(v[:, faces]))(
        jnp.asarray(verts)))
    want_t = np.asarray(jax.grad(jloss_mass_height)(jnp.asarray(tris)))
    v = torch.from_numpy(verts).requires_grad_()
    m = tm(v[:, torch.from_numpy(faces)])["measurements"]
    sum(wk * m[k]["tensor"].sum() for k, wk in w.items()).backward()
    t = torch.from_numpy(tris).requires_grad_()
    (w["mass"] * tm.compute_mass(t).sum()
     + w["height"] * tm.compute_height(t)[0].sum()).backward()
    for got, want in ((v.grad, want_v), (t.grad, want_t)):
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    for name in PLANES:  # the slice points carry a gradient, the masks not
        assert m[name]["points"].requires_grad
        assert not m[name]["valid_points"].requires_grad
    assert m["height"]["points"].requires_grad


@pytest.mark.parametrize("mode", MODES)
def test_points_gradient_matches_jax(bodies, mode):
    """The gradient of a weighted sum of the slice points (``points``, as
    returned: masked slots included), in the vertices through ``v[:,
    faces]``, against ``jax.grad`` of the same function of the JAX
    ``BodyMeasurements.forward``: through each hit's crossed edge (or its
    quad-edge cast) and through the plane height to the anchor triangle.
    Held per mesh vertex, as the circumferences' gradients; tolerance 1e-5
    of the largest (the same f32 operations, their cotangents summed in
    another order)."""
    tm, jm = _modules(bodies, mode)
    faces, verts = bodies[0], bodies[1]
    rng = np.random.default_rng(3)
    out = tm(torch.from_numpy(bodies[2]))["measurements"]
    w = {k: rng.normal(size=tuple(out[k]["points"].shape)).astype(np.float32)
         for k in PLANES}

    def jloss(v):
        m = jm.forward(v[:, faces])["measurements"]
        return sum(jnp.sum(jnp.asarray(w[k]) * m[k]["points"])
                   for k in PLANES)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(verts)))
    v = torch.from_numpy(verts).requires_grad_()
    m = tm(v[:, torch.from_numpy(faces)])["measurements"]
    sum((torch.from_numpy(w[k]) * m[k]["points"]).sum()
        for k in PLANES).backward()
    got = v.grad.numpy()
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("mode", MODES)
def test_periphery_exact_np_matches_jax(bodies, mode):
    tm, jm = _modules(bodies, mode)
    tris = bodies[2]
    for name in PLANES:
        got = tm.periphery_exact_np(tris, name)
        want = jm.periphery_exact_np(tris, name)
        np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)
        assert (got > 0.3).all()
        # The 128-direction support hull is within 1 mm of the exact one.
        approx = tm(torch.from_numpy(tris))["measurements"][name]["tensor"]
        assert np.abs(approx.numpy() - got).max() < 1e-3


def test_chest_waist_hips_matches_jax(bodies):
    tm, jm = _modules(bodies, "exact", ChestWaistHipsMeasurements,
                      jcwh.ChestWaistHipsMeasurements)
    tris = bodies[2]
    _check_outputs(tm(torch.from_numpy(tris))["measurements"],
                   jm.forward(jnp.asarray(tris))["measurements"], PLANES)
    got = tm(torch.from_numpy(tris), compute_waist=False)["measurements"]
    assert set(got) == {"chest", "hips"}


def test_anchor_beyond_the_triangles_is_refused(bodies):
    """K1-AoS reads the anchors' faces unchecked on the card: a mesh with
    fewer faces than an anchor names is refused first (the plain version
    raises on the index too)."""
    tm, _ = _modules(bodies, "reference")
    small = torch.zeros((1, tm.anchors.head_top.face_idx, 3, 3))
    with pytest.raises((ValueError, IndexError)):
        tm(small)
