"""Parity of the port's measurements (kernel K1's plain version, and the
exact slice mode) with the JAX package's ``forward_from_vertices``.

Shaped bodies from seeded betas on the synthetic SMPL-X mesh go to both
sides. Tolerances: mass and height rel 1e-5 (f32 sums of ~1e3 signed
volumes in another order); circumferences atol 1e-5 m (the same hit
points, centred and projected in f32; well inside the 1 mm parity
budget).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.measure import measurements as jmeas
from shapy_tpu_torch.measure import measurements as meas
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data

torch.set_num_threads(2)
PLANES = ("chest", "waist", "hips")


@pytest.fixture(scope="module")
def setup():
    data = make_synthetic_model_data("smplx", subdivisions=3, seed=0)
    v_t = data["v_template"].astype(np.float32)
    dirs = data["shapedirs"][:, :, :10].astype(np.float32)
    faces = data["f"]
    anchors = meas.MeasurementAnchors.synthetic(faces, v_t)
    janchors = jmeas.MeasurementAnchors.synthetic(faces, v_t)
    assert [tuple(vars(a).values()) for a in anchors.ordered()] == [
        (janchors.head_top.face_idx, janchors.head_top.bary),
        (janchors.left_heel.face_idx, janchors.left_heel.bary),
        (janchors.chest.face_idx, janchors.chest.bary),
        (janchors.waist.face_idx, janchors.waist.bary),
        (janchors.hips.face_idx, janchors.hips.bary)]
    subsets = meas.candidate_faces(v_t, dirs, faces, anchors)
    jsubsets = jmeas.candidate_faces(v_t, dirs, faces, janchors)
    for name in PLANES:
        np.testing.assert_array_equal(subsets[name], jsubsets[name])
    betas = np.random.default_rng(0).normal(size=(3, 10)).astype(np.float32)
    verts = (v_t[None] + np.einsum("bl,vkl->bvk", betas, dirs)).astype(
        np.float32)
    return faces, anchors, janchors, subsets, verts


def _run(setup, slice_mode, use_subsets, verts=None):
    faces, anchors, janchors, subsets, v = setup
    v = v if verts is None else verts
    jm = jmeas.BodyMeasurements(anchors=janchors, num_hull_directions=256,
                                slice_mode=slice_mode, face_subsets=subsets)
    tm = meas.BodyMeasurements(anchors, faces, num_hull_directions=256,
                               slice_mode=slice_mode, face_subsets=subsets)
    want = jm.forward_from_vertices(jnp.asarray(v), faces,
                                    use_face_subsets=use_subsets)
    got = tm.forward_from_vertices(torch.from_numpy(v),
                                   use_face_subsets=use_subsets)
    return got["measurements"], want["measurements"]


@pytest.mark.parametrize("slice_mode,use_subsets", [
    ("reference", True), ("reference", False), ("exact", False),
], ids=["reference-subsets", "reference-all-faces", "exact"])
def test_forward_from_vertices_matches_jax(setup, slice_mode, use_subsets):
    got, want = _run(setup, slice_mode, use_subsets)
    for k in ("mass", "height"):
        np.testing.assert_allclose(got[k]["tensor"].numpy(),
                                   np.asarray(want[k]["tensor"]), rtol=1e-5,
                                   err_msg=k)
    for k in PLANES:
        value = got[k]["tensor"].numpy()
        assert (value > 0.5).all(), k  # a real slice, not an empty one
        np.testing.assert_allclose(value, np.asarray(want[k]["tensor"]),
                                   atol=1e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(got[k]["plane_height"].numpy(),
                                   np.asarray(want[k]["plane_height"]),
                                   atol=1e-6, err_msg=k)


def test_subsets_are_exact_inside_the_beta_bound(setup):
    with_sub, _ = _run(setup, "reference", True)
    without, _ = _run(setup, "reference", False)
    for k in PLANES:
        np.testing.assert_allclose(with_sub[k]["tensor"].numpy(),
                                   without[k]["tensor"].numpy(), atol=1e-6)


def test_plane_missing_the_mesh_gives_zero(setup):
    """Shifted 5 m along x the mesh lies outside the reference's [-1, 1]^2
    plane quad: no hit survives and every circumference is 0, as in the
    JAX package."""
    verts = setup[4] + np.asarray([5.0, 0.0, 0.0], np.float32)
    got, want = _run(setup, "reference", True, verts=verts)
    for k in PLANES:
        np.testing.assert_array_equal(got[k]["tensor"].numpy(), 0.0)
        np.testing.assert_array_equal(np.asarray(want[k]["tensor"]), 0.0)
    np.testing.assert_allclose(got["mass"]["tensor"].numpy(),
                               np.asarray(want["mass"]["tensor"]), rtol=1e-5)


def test_out_of_range_ids_are_rejected(setup):
    """The kernel indexes faces, anchors and subsets unchecked, so the
    module validates them once, and the vertex count at each call."""
    faces, anchors, _, subsets, verts = setup
    bad = dict(subsets, chest=np.append(subsets["chest"], len(faces)))
    with pytest.raises(ValueError):
        meas.BodyMeasurements(anchors, faces, face_subsets=bad)
    tm = meas.BodyMeasurements(anchors, faces, face_subsets=subsets)
    with pytest.raises(ValueError):
        tm.forward_from_vertices(torch.from_numpy(verts[:, :-1]))
