"""The port's CUDA kernels against their plain PyTorch versions, on the
card. A CUDA kernel has no CPU mode, so these tests are marked ``cuda`` and
skip without a card; run them on a machine with one:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest

(``--noconftest``: ``tests/conftest.py`` imports jax, which the port's
GPU machine need not have.)

``chip_smoke.py`` runs the same comparisons at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from shapy_tpu_torch.core.kinematics import batch_rigid_transform
from shapy_tpu_torch.core.rotations import aa_to_rotmat
from shapy_tpu_torch.data.crop import (
    INGEST_KERNEL,
    crop_normalize,
    crop_normalize_plain,
)
from shapy_tpu_torch.measure.measurements import (
    MEASURE_KERNEL,
    PLANES,
    BodyMeasurements,
    MeasurementAnchors,
    candidate_faces,
    measure_plain,
)
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
from shapy_tpu_torch.models.body.lbs import SKIN_KERNEL, skin, skin_plain
from shapy_tpu_torch.models.body.model import SMPLX

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def body(dev):
    data = make_synthetic_model_data("smplx", subdivisions=3, seed=0)
    model = SMPLX(data).to(dev)
    v_t = data["v_template"]
    anchors = MeasurementAnchors.synthetic(model.faces, v_t)
    subsets = candidate_faces(v_t, data["shapedirs"][:, :, :10],
                              model.faces, anchors)
    meas = BodyMeasurements(anchors, model.faces, 256,
                            face_subsets=subsets).to(dev)
    return model, meas


@pytest.mark.parametrize("use_subsets,shift", [
    (True, 0.0), (False, 0.0), (True, 5.0)],
    ids=["subsets", "all-faces", "plane-misses-mesh"])
def test_measure_kernel_matches_plain(dev, body, use_subsets, shift):
    model, meas = body
    betas = torch.randn(5, 10, generator=torch.Generator().manual_seed(0))
    v = model.forward_shape(betas.to(dev))["v_shaped"]
    v = (v + torch.tensor([shift, 0.0, 0.0], device=dev)).contiguous()
    before = MEASURE_KERNEL.launches
    got = meas.forward_from_vertices(v, use_face_subsets=use_subsets)
    assert MEASURE_KERNEL.launches == before + 1
    plane_faces = ([getattr(meas, f"subset_{n}") for n in PLANES]
                   if use_subsets else None)
    want, _ = measure_plain(v, meas.faces, plane_faces, meas.anchors, 256)
    got = got["measurements"]
    for i, k in enumerate(("mass", "height")):
        torch.testing.assert_close(got[k]["tensor"], want[:, i], rtol=1e-5,
                                   atol=0)
    for i, k in enumerate(PLANES):
        torch.testing.assert_close(got[k]["tensor"], want[:, 2 + i],
                                   rtol=0, atol=1e-5)
        # Shifted 5 m along x, no hit lies in the plane quad: 0.
        assert bool((got[k]["tensor"] > 0.5).all()) == (shift == 0.0)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_ingest_kernel_matches_plain(dev, out_dtype):
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (3, 50, 70, 3),
                                           dtype=np.uint8)).to(dev)
    ang = np.deg2rad(20.0)
    A = np.array([[np.cos(ang) * 0.4, -np.sin(ang) * 0.4, 5.0],
                  [np.sin(ang) * 0.4, np.cos(ang) * 0.4, -3.0],
                  [0.0, 0.0, 1.0]], np.float32)
    affines = torch.from_numpy(np.stack([A] * 3)).to(dev)
    before = INGEST_KERNEL.launches
    got = crop_normalize(images, affines, 64, out_dtype=out_dtype)
    assert INGEST_KERNEL.launches == before + 1
    want = crop_normalize_plain(images, affines, 64, out_dtype=out_dtype)
    tol = 1e-5 if out_dtype == torch.float32 else 2.0 ** -6
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


def test_skin_kernel_matches_plain(dev, body):
    model, _ = body
    gen = torch.Generator().manual_seed(1)
    aa = (torch.randn(4, 55, 3, generator=gen) * 0.3).to(dev)
    v = model.forward_shape(torch.zeros(4, 10, device=dev))["v_shaped"]
    joints = torch.matmul(model.J_regressor, v)
    _, rel, _ = batch_rigid_transform(aa_to_rotmat(aa), joints,
                                      model.parents)
    before = SKIN_KERNEL.launches
    got = skin(model.lbs_weights, rel.contiguous(), v.contiguous())
    assert SKIN_KERNEL.launches == before + 1
    torch.testing.assert_close(
        got, skin_plain(model.lbs_weights, rel, v), rtol=0, atol=1e-5)
