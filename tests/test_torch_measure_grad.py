"""The gradient of the port's measurements (kernel K1's and K1-exact's
plain version under autograd) against ``jax.vjp`` of the JAX package's
``forward_from_vertices``, in both slice modes, with and without face
subsets.

Shaped bodies from seeded betas (~1.5 sigma) on the synthetic SMPL-X mesh
at ``subdivisions=3``, K=128 hull directions, batch 2, and seeded
cotangents on all five measurements and the three plane heights go to
both sides. The fixture asserts that tied extreme hits occur: about a
tenth of the reference-mode hits duplicate another hit exactly (shared
body edges, the quad diagonal), and the max / min of the hull split the
gradient evenly among ties on both sides. Tolerance: 1e-5 of the largest
gradient (f32 on both sides, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.measure import measurements as jmeas
from shapy_tpu_torch.measure import measurements as meas
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
from shapy_tpu_torch.ops.convex_hull import hull_directions
from shapy_tpu_torch.ops.plane_slice import plane_slice_reference_soa

torch.set_num_threads(2)
K = 128
PLANES = meas.PLANES
KEYS = ("mass", "height") + PLANES


@pytest.fixture(scope="module")
def setup():
    data = make_synthetic_model_data("smplx", subdivisions=3, seed=0)
    v_t = data["v_template"].astype(np.float32)
    dirs = data["shapedirs"][:, :, :10].astype(np.float32)
    faces = data["f"]
    anchors = meas.MeasurementAnchors.synthetic(faces, v_t)
    janchors = jmeas.MeasurementAnchors.synthetic(faces, v_t)
    subsets = meas.candidate_faces(v_t, dirs, faces, anchors, pad_to=64)
    rng = np.random.default_rng(0)
    betas = rng.normal(size=(2, 10)).astype(np.float32) * 1.5
    verts = (v_t[None] + np.einsum("bl,vkl->bvk", betas, dirs)).astype(
        np.float32)
    g_vals = rng.normal(size=(2, 5)).astype(np.float32)
    g_heights = rng.normal(size=(2, 3)).astype(np.float32)
    return faces, anchors, janchors, subsets, verts, g_vals, g_heights


def _tied_directions(setup) -> int:
    """Directions (of all planes and bodies) whose extreme hit in the
    reference-mode slice is reached by more than one hit, on all faces."""
    faces, anchors, _, _, verts, _, _ = setup
    tx, ty, tz = meas._soa(torch.from_numpy(verts), torch.from_numpy(faces))
    cos, sin = hull_directions(K)
    tied = 0
    for name in PLANES:
        a = getattr(anchors, name)
        h = (ty[:, :, a.face_idx] * torch.tensor(a.bary)).sum(-1)
        xs, zs, m = plane_slice_reference_soa(ty, tx, tz, h)
        for b in range(verts.shape[0]):
            x, z = xs[b][m[b]], zs[b][m[b]]
            proj = (x - x.mean())[:, None] * cos + (z - z.mean())[:, None] * sin
            for ext in (proj.max(0).values, proj.min(0).values):
                tied += int(((proj == ext).sum(0) > 1).sum())
    return tied


def test_fixture_has_tied_extreme_hits(setup):
    assert _tied_directions(setup) > 20


def _jax_vjp(setup, slice_mode, use_subsets):
    faces, _, janchors, subsets, verts, g_vals, g_heights = setup
    jm = jmeas.BodyMeasurements(anchors=janchors, num_hull_directions=K,
                                slice_mode=slice_mode, face_subsets=subsets)

    def f(v):
        m = jm.forward_from_vertices(v, faces,
                                     use_face_subsets=use_subsets)
        m = m["measurements"]
        return (jnp.stack([m[k]["tensor"] for k in KEYS], axis=-1),
                jnp.stack([m[k]["plane_height"] for k in PLANES], axis=-1))

    out, vjp = jax.vjp(f, jnp.asarray(verts))
    (grad,) = vjp((jnp.asarray(g_vals), jnp.asarray(g_heights)))
    return out, np.asarray(grad)


def _port_grad(setup, slice_mode, use_subsets):
    faces, anchors, _, subsets, verts, g_vals, g_heights = setup
    tm = meas.BodyMeasurements(anchors, faces, num_hull_directions=K,
                               slice_mode=slice_mode, face_subsets=subsets)
    v = torch.from_numpy(verts).requires_grad_()
    m = tm.forward_from_vertices(v, use_face_subsets=use_subsets)
    m = m["measurements"]
    vals = torch.stack([m[k]["tensor"] for k in KEYS], dim=-1)
    heights = torch.stack([m[k]["plane_height"] for k in PLANES], dim=-1)
    torch.autograd.backward([vals, heights], [torch.from_numpy(g_vals),
                                              torch.from_numpy(g_heights)])
    return (vals.detach(), heights.detach()), v.grad.numpy()


@pytest.mark.parametrize("slice_mode,use_subsets", [
    ("reference", True), ("reference", False), ("exact", True),
    ("exact", False),
], ids=["reference-subsets", "reference-all-faces", "exact-subsets",
        "exact-all-faces"])
def test_measurement_gradient_matches_jax_vjp(setup, slice_mode,
                                              use_subsets):
    (want_vals, want_h), want = _jax_vjp(setup, slice_mode, use_subsets)
    (got_vals, got_h), got = _port_grad(setup, slice_mode, use_subsets)
    np.testing.assert_allclose(got_vals.numpy(), np.asarray(want_vals),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-6)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("column", range(5), ids=KEYS)
def test_each_measurement_gradient_matches_jax_vjp(setup, column):
    """One measurement at a time, reference mode on all faces (the fit's
    and the train step's path), so the mass term does not hide the
    circumferences' gradients: 1e-5 of the largest gradient."""
    faces, anchors, janchors, subsets, verts, _, _ = setup
    g_vals = np.zeros((2, 5), np.float32)
    g_vals[:, column] = [1.0, -0.5]
    g_heights = np.zeros((2, 3), np.float32)
    case = (faces, anchors, janchors, subsets, verts, g_vals, g_heights)
    _, want = _jax_vjp(case, "reference", False)
    _, got = _port_grad(case, "reference", False)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def test_plane_with_fewer_than_two_hits_has_no_gradient(setup):
    """A body far to the side of the reference's [-1, 1]^2 plane quad
    leaves every plane without hits: circumferences 0 and no gradient
    through them on both sides; mass and height still have one."""
    faces, anchors, janchors, subsets, verts, g_vals, g_heights = setup
    shifted = verts + np.asarray([5.0, 0.0, 0.0], np.float32)
    case = (faces, anchors, janchors, subsets, shifted, g_vals, g_heights)
    (jv, _), want = _jax_vjp(case, "reference", False)
    (tv, _), got = _port_grad(case, "reference", False)
    np.testing.assert_array_equal(tv.numpy()[:, 2:], 0.0)
    np.testing.assert_array_equal(np.asarray(jv)[:, 2:], 0.0)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
