"""The port's CUDA kernels against their plain PyTorch versions, on the
card. A CUDA kernel has no CPU mode, so these tests are marked ``cuda`` and
skip without a card; run them on a machine with one:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest

(``--noconftest``: ``tests/conftest.py`` imports jax, which the port's
GPU machine need not have.)

``chip_smoke.py`` runs the same comparisons at the main path's shapes.
Tolerances are stated beside each test, with their reason.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from shapy_tpu_torch.core.kinematics import (
    CHAIN_KERNEL,
    batch_rigid_transform,
    batch_rigid_transform_plain,
    chain_backward_replay,
    chain_forward_replay,
)
from shapy_tpu_torch.core.rotations import aa_to_rotmat
from shapy_tpu_torch.data.crop import (
    INGEST_KERNEL,
    crop_normalize,
    crop_normalize_plain,
    ingest_plan,
)
from shapy_tpu_torch.eval import metrics
from shapy_tpu_torch.eval.metrics import (
    ALIGN_KERNEL,
    NN_KERNEL,
    REGRESS_KERNEL,
    SparsePointRegressor,
    _aligned_point_errors_cuda,
    _point_regress_cuda,
    align_plan,
    aligned_point_error,
    aligned_point_error_plain,
    aligned_point_errors,
    aligned_sums_replay,
    point_regress_error,
    point_regress_error_plain,
    regress_plan,
    regress_sums_replay,
)
from shapy_tpu_torch.measure.measurements import (
    MEASURE_KERNEL,
    PLANES,
    BodyMeasurements,
    MeasurementAnchors,
    _MeasureKernel,
    _Walk,
    candidate_faces,
    measure_plain,
    measure_plan,
    saved_centroids,
    saved_hits_plain,
)
from shapy_tpu_torch.models.backbones import hrnet, layers
from shapy_tpu_torch.models.backbones.hrnet import (
    FUSE_KERNEL,
    HighResolutionModule,
    HRNet,
    _hr_fuse_backward_cuda,
    hr_fuse,
    hr_fuse_backward_plain,
    hr_fuse_plain,
)
from shapy_tpu_torch.models.backbones.layers import (
    BN_KERNEL,
    CONV_KERNEL,
    POOL_KERNEL,
    batch_norm_train,
    batch_norm_train_backward_plain,
    batch_norm_train_plain,
    conv2d_act,
    conv2d_act_bf16_tolerance,
    conv2d_act_plain,
    conv2d_backward_plain,
    conv2d_input_plain,
    conv2d_wgrad_bf16_tolerance,
    conv_act,
    fold_bn_,
    max_pool2d,
    max_pool2d_backward_plain,
    max_pool2d_plain,
    relu_mask_plain,
    stem_plan,
)
from shapy_tpu_torch.models.backbones.resnet import ResNet
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
from shapy_tpu_torch.models.body.lbs import (
    SKIN_KERNEL,
    skin,
    skin_backward_replay,
    skin_forward_replay,
    skin_plain,
)
from shapy_tpu_torch.models.body.model import SMPLX
from shapy_tpu_torch.ops import (
    MeshMeshIntersection,
    mesh_mesh_intersection,
    repulsion_loss,
)
from shapy_tpu_torch.ops import repulsion, tri_tri
from shapy_tpu_torch.core import geometry
from shapy_tpu_torch.ops.plane_slice import (
    plane_slice_reference,
    plane_slice_soa,
    plane_slice_triangles,
)
from shapy_tpu_torch.ops.repulsion import REPULSION_KERNEL
from shapy_tpu_torch.ops.tri_tri import TRI_KERNEL

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]


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
    """K2 bit-equal to its plain version: the same f32 operations in the
    same order, built without FMA contraction."""
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
    assert torch.equal(got, want)


def _ingest_case(case, dev):
    """(images, affines) of one K2 case: the served requests at batch 32
    and 128, the extremes of ``tests/test_torch_ingest_plan.py``
    (magnification 4, a 90 degree rotation, a crop wholly outside) and
    odd shapes (rows of 213 and 132 bytes, not 16-byte aligned, which
    stage no tile; crops of 100 and 37 pixels)."""
    from shapy_tpu_torch.flagship import synthetic_requests
    from tests.test_torch_ingest_plan import extreme_affines

    if case.startswith("served"):
        images, affines = synthetic_requests(int(case[6:]), 360, 480, 256, 0)
        return torch.from_numpy(images).to(dev), torch.from_numpy(
            affines).to(dev), 256
    H, W, S = {"extreme": (360, 480, 256), "odd100": (50, 71, 100),
               "odd37": (33, 44, 37)}[case]
    rng = np.random.default_rng(S)
    images = torch.from_numpy(rng.integers(0, 256, (3, H, W, 3),
                                           dtype=np.uint8)).to(dev)
    return images, torch.from_numpy(extreme_affines(H, W, S)).to(dev), S


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("case", ["served32", "served128", "extreme",
                                  "odd100", "odd37"])
def test_ingest_kernel_bit_equal_in_both_regimes(dev, case, in_dtype,
                                                 out_dtype):
    """K2 bit-equal to ``crop_normalize_plain`` for every input and output
    kind, on the served requests (every tile staged for uint8) and on
    tiles that take the direct regime (``ingest_plan``), one launch."""
    images, affines, S = _ingest_case(case, dev)
    if in_dtype == torch.float32:
        images = images.to(torch.float32) * (1.0 / 255.0)
    H, W = images.shape[1:3]
    plan = ingest_plan(affines, H, W, S, in_dtype, images.data_ptr())
    if case == "extreme":
        assert bool(plan["staged"].any()) and not bool(plan["staged"].all())
    before = INGEST_KERNEL.launches
    got = crop_normalize(images, affines, S, out_dtype=out_dtype)
    assert INGEST_KERNEL.launches == before + 1
    assert torch.equal(got, crop_normalize_plain(images, affines, S,
                                                 out_dtype=out_dtype))
    assert torch.equal(got, crop_normalize(images, affines, S,
                                           out_dtype=out_dtype))
    # a view that starts inside its allocation, with other alignment
    view = images[1:]
    assert torch.equal(crop_normalize(view, affines[1:], S,
                                      out_dtype=out_dtype), got[1:])


# K3's shapes: SMPL-X at the real template's counts (served at 32, trained
# at 48, one body), SMPL and SMPL-H, the kernel's 76 joints (the most shared
# memory either kernel asks for: a launch refused it raises), ragged tiles.
SKIN_SHAPES = [(1, 10475, 55), (32, 10475, 55), (48, 10475, 55),
               (5, 6890, 24), (5, 300, 52), (128, 300, 76), (3, 1, 55),
               (9, 127, 55)]


def _skin_inputs(dev, B, V, J, seed):
    """Dense skinning weights (rows summing to 1), rigid transforms with
    rotations of ~0.3 rad and translations of ~0.2 m, and bodies of ~1 m,
    as contiguous f32 tensors on ``dev``."""
    gen = torch.Generator().manual_seed(seed)
    w = torch.rand(V, J, generator=gen)
    w = w / w.sum(1, keepdim=True)
    rel = torch.zeros(B, J, 4, 4)
    rel[:, :, :3, :3] = aa_to_rotmat(torch.randn(B, J, 3, generator=gen)
                                     * 0.3)
    rel[:, :, :3, 3] = torch.randn(B, J, 3, generator=gen) * 0.2
    rel[:, :, 3, 3] = 1.0
    v = torch.randn(B, V, 3, generator=gen) * 0.5
    dv = torch.randn(B, V, 3, generator=gen)
    return tuple(t.contiguous().to(dev) for t in (w, rel, v, dv))


@pytest.mark.parametrize("shape", SKIN_SHAPES, ids=str)
def test_skin_kernel_matches_plain(dev, shape):
    """K3 forward against the plain version (atol 1e-5 m: sums of J
    weighted transforms in another order) and bit-equal to its replay,
    ``skin_forward_replay`` (the same fma chains in the same order)."""
    w, rel, v, _ = _skin_inputs(dev, *shape, seed=1)
    before = SKIN_KERNEL.launches
    got = skin(w, rel, v)
    assert SKIN_KERNEL.launches == before + 1
    torch.testing.assert_close(got, skin_plain(w, rel, v), rtol=0,
                               atol=1e-5)
    assert torch.equal(got, skin_forward_replay(w, rel, v))


def test_skin_kernel_on_a_body(dev, body):
    """K3 forward on posed bodies of the synthetic SMPL-X."""
    model, _ = body
    gen = torch.Generator().manual_seed(1)
    aa = (torch.randn(4, 55, 3, generator=gen) * 0.3).to(dev)
    v = model.forward_shape(torch.zeros(4, 10, device=dev))["v_shaped"]
    joints = torch.matmul(model.J_regressor, v)
    _, rel, _ = batch_rigid_transform(aa_to_rotmat(aa), joints,
                                      model.parents)
    got = skin(model.lbs_weights, rel.contiguous(), v.contiguous())
    torch.testing.assert_close(
        got, skin_plain(model.lbs_weights, rel, v), rtol=0, atol=1e-5)


def _skin_grads(fn, w, rel, v, dv, dtype=torch.float32):
    a = rel.to(dtype, copy=True).requires_grad_()
    b = v.to(dtype, copy=True).requires_grad_()
    fn(w.to(dtype), a, b).backward(dv.to(dtype))
    return a.grad.float(), b.grad.float()


@pytest.mark.parametrize("shape", [(1, 10475, 55), (32, 10475, 55),
                                   (48, 10475, 55), (128, 300, 76)],
                         ids=str)
def test_skin_kernel_stable_and_batch_invariant(dev, shape):
    """Two calls give the same bits, and a body alone the same bits as
    its row of the batch, forward and backward: every sum's order is
    fixed by V and J alone (``skin_plan``)."""
    w, rel, v, dv = _skin_inputs(dev, *shape, seed=2)
    B = shape[0]
    out = skin(w, rel, v)
    grads = _skin_grads(skin, w, rel, v, dv)
    assert torch.equal(out, skin(w, rel, v))
    assert all(torch.equal(a, b) for a, b in
               zip(grads, _skin_grads(skin, w, rel, v, dv)))
    for i in sorted({0, B // 2, B - 1}):
        s = slice(i, i + 1)
        assert torch.equal(skin(w, rel[s], v[s])[0], out[i])
        alone = _skin_grads(skin, w, rel[s], v[s], dv[s])
        assert torch.equal(alone[0][0], grads[0][i])
        assert torch.equal(alone[1][0], grads[1][i])


def test_skin_rejects_too_many_joints(dev):
    """The kernels take at most 76 joints (``_SKIN_MAX_JOINTS``)."""
    w, rel, v, _ = _skin_inputs(dev, 2, 10, 77, seed=3)
    with pytest.raises(ValueError):
        skin(w, rel, v)


def _clouds(dev, B, P, seed):
    """Well-conditioned clouds (distinct extents per axis) and a noisy,
    rotated, scaled and shifted copy."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((B, P, 3), generator=gen) * torch.tensor([0.8, 0.3, 0.15])
    R = torch.linalg.qr(torch.randn((B, 3, 3), generator=gen))[0]
    R = R * torch.linalg.det(R).sign()[:, None, None]  # proper rotations
    y = 1.3 * torch.einsum("bij,bpj->bpi", R, x) + torch.tensor(
        [0.2, -1.0, 3.0])
    noise = 0.01 * torch.randn((B, P, 3), generator=gen)
    return x.to(dev), y.to(dev), (y + noise).to(dev)


@pytest.mark.parametrize("P", [10475, 55, 14], ids=["v2v", "mpjpe",
                                                     "mpjpe14"])
@pytest.mark.parametrize("alignment", ["none", "root", "translation",
                                       "scale", "procrustes"])
def test_align_error_kernel_matches_plain(dev, alignment, P):
    """K8b at the evaluator's shapes (B=32), against the plain version in
    f64 (atol 1e-5 m: the kernel forms the aligned points in f32) and in
    f32 (atol 1e-5 m for sums in another order; 3e-5 m for procrustes,
    whose f32 SVD gives a rotation good to ~3e-6, and points lie up to
    ~4 m from the centroid)."""
    x, _, y = _clouds(dev, 32, P, seed=P)
    root = (2, 3)
    before = ALIGN_KERNEL.launches
    got = aligned_point_error(y, x, alignment, root)
    assert ALIGN_KERNEL.launches == before + 1
    exact = aligned_point_error_plain(y.double(), x.double(), alignment, root)
    torch.testing.assert_close(got, exact.float(), rtol=0, atol=1e-5)
    want = aligned_point_error_plain(y, x, alignment, root)
    tol = 3e-5 if alignment == "procrustes" else 1e-5
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    # fixed-order reductions: the same bits on every run
    assert torch.equal(got, aligned_point_error(y, x, alignment, root))


# The evaluator's group a batch: v2v_t (v_shaped: scale, translation), v2v
# (posed: procrustes, scale, translation), mpjpe (55 joints: root,
# procrustes), mpjpe14 (root on the hips, procrustes).
EVAL_GROUP = ((10475, ("scale", "translation"), None),
              (10475, ("procrustes", "scale", "translation"), None),
              (55, ("root", "procrustes"), (0,)),
              (14, ("root", "procrustes"), (2, 3)))
# Boundary shapes: one point, fewer points than a cluster's CTAs, a split
# that is not a multiple of the cluster, clusters of two sizes in one
# launch, every mode on one pair.
EDGE_GROUP = ((1, ("none", "translation", "scale"), None),
              (3, ("root", "procrustes"), (2, 0, 1)),
              (1537, ("none", "root", "translation", "scale",
                      "procrustes"), (5, 1536)),
              (10001, ("procrustes", "translation"), None))


def _group(dev, B, spec, seed):
    pairs = []
    for i, (P, names, root) in enumerate(spec):
        x, _, y = _clouds(dev, B, P, seed=seed + i)
        pairs.append((y, x, names, root))
    return pairs


def _check_group(pairs):
    """The grouped kernel: one launch; each alignment within atol 1e-5 m
    of the f64 plain version and of the f32 one (3e-5 m for procrustes, as
    test_align_error_kernel_matches_plain); bit-equal run to run and to
    each pair as a group of one; the totals bit-equal to their replay."""
    before = ALIGN_KERNEL.launches
    got, sums = _aligned_point_errors_cuda(
        [(y, x, tuple(n), tuple(r or (0,))) for y, x, n, r in pairs])
    assert ALIGN_KERNEL.launches == before + 1
    again = aligned_point_errors(pairs)
    for (y, x, names, root), out, out2, tot in zip(pairs, got, again, sums):
        root = root or (0,)
        alone = aligned_point_errors([(y, x, names, root)])[0]
        for name in names:
            exact = aligned_point_error_plain(y.double(), x.double(), name,
                                              root)
            torch.testing.assert_close(out[name], exact.float(), rtol=0,
                                       atol=1e-5)
            tol = 3e-5 if name == "procrustes" else 1e-5
            torch.testing.assert_close(
                out[name], aligned_point_error_plain(y, x, name, root),
                rtol=0, atol=tol)
            assert torch.equal(out[name], out2[name])
            assert torch.equal(out[name], alone[name])
        assert torch.equal(tot, aligned_sums_replay(y, x, names, root))


@pytest.mark.parametrize("B", [32, 1])
def test_align_error_group_matches_plain(dev, B):
    """K8b's group at the evaluator's shapes (B = 32) and for one body."""
    _check_group(_group(dev, B, EVAL_GROUP, seed=20))
    assert align_plan(10475, B).cluster > 1  # the cluster path runs


@pytest.mark.parametrize("B", [5, 1])
def test_align_error_group_edge_shapes(dev, B):
    _check_group(_group(dev, B, EDGE_GROUP, seed=30))


def test_procrustes_kernel_recovers_a_similarity_and_keeps_mirrors(dev):
    x, y, _ = _clouds(dev, 32, 10475, seed=1)
    err = aligned_point_error(y, x, "procrustes")
    assert float(err.max()) < 1e-5  # an exact similarity: error ~ 0
    mirrored = (x * torch.tensor([-1.0, 1.0, 1.0], device=dev)).contiguous()
    got = aligned_point_error(mirrored, x, "procrustes")
    assert float(got.mean(dim=1).min()) > 1e-3  # no reflections
    # against the plain version in f64, as above (atol 1e-5 m)
    exact = aligned_point_error_plain(mirrored.double(), x.double(),
                                      "procrustes")
    torch.testing.assert_close(got, exact.float(), rtol=0, atol=1e-5)


def _regressor(dev, V, P, K, seed):
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, V, (P, K), generator=gen)
    w = torch.rand((P, K), generator=gen)
    return SparsePointRegressor(idx.numpy(), (w / w.sum(1, keepdim=True))
                                .numpy(), device=dev)


@pytest.mark.parametrize("case", ["same", "target", "no-align"])
def test_point_regress_kernel_matches_plain(dev, case):
    """K8a at the P2P-20k shapes: B=32, V=10475, P=20000, K=3; a separate
    target regressor (V=6890, K=2); align=False. Tolerance atol 1e-5 m:
    the translation's means are summed in another order."""
    gen = torch.Generator().manual_seed(2)
    v_in = torch.randn((32, 10475, 3), generator=gen).to(dev)
    reg = _regressor(dev, 10475, 20000, 3, seed=3)
    tr = reg
    v_tgt = (v_in + 0.01 * torch.randn((32, 10475, 3), generator=gen)
             .to(dev) + 0.5)
    if case == "target":
        tr = _regressor(dev, 6890, 20000, 2, seed=4)
        v_tgt = torch.randn((32, 6890, 3), generator=gen).to(dev)
    args = (v_in, v_tgt, reg.indices, reg.weights, tr.indices, tr.weights,
            case != "no-align")
    before = REGRESS_KERNEL.launches
    got = point_regress_error(*args)
    assert REGRESS_KERNEL.launches == before + 1
    want = point_regress_error_plain(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(got, point_regress_error(*args))
    # The regressor's sorted rows (the evaluator's route): one launch, the
    # same tolerance, the same bits twice, the totals as their replay.
    reg.align = tr.align = case != "no-align"
    before = REGRESS_KERNEL.launches
    sorted_rows = reg(v_in, v_tgt, tr)
    assert REGRESS_KERNEL.launches == before + 1
    torch.testing.assert_close(sorted_rows, want, rtol=0, atol=1e-5)
    assert torch.equal(sorted_rows, reg(v_in, v_tgt, tr))
    rows = reg.kernel_rows(tr)
    _, sums = _point_regress_cuda(v_in, v_tgt, *rows[:4], args[-1], rows[4])
    if case == "no-align":
        assert not bool(sums.any())
    else:
        assert torch.equal(sums, regress_sums_replay(v_in, v_tgt,
                                                     *rows[:4]))
    if case == "same":  # a constant offset is removed by the alignment
        shifted = (v_in + torch.tensor([1.0, -2.0, 0.5], device=dev))
        assert float(reg(shifted.contiguous(), v_in).max()) < 1e-5


@pytest.mark.parametrize("B,P", [(3, 5), (2, 2049), (1, 20000)],
                         ids=["fewer-than-a-cluster", "not-a-multiple",
                              "one-body"])
def test_point_regress_kernel_edge_shapes(dev, B, P):
    """K8a at the plan's edges (atol 1e-5 m, as above; one launch; the
    same bits twice; the totals as their replay)."""
    gen = torch.Generator().manual_seed(P)
    v_in = torch.randn((B, 300, 3), generator=gen).to(dev)
    v_tgt = (v_in + 0.01 * torch.randn((B, 300, 3), generator=gen).to(dev)
             + 0.5)
    reg = _regressor(dev, 300, P, 3, seed=P)
    before = REGRESS_KERNEL.launches
    got = reg(v_in, v_tgt)
    assert REGRESS_KERNEL.launches == before + 1
    torch.testing.assert_close(got, reg.plain(v_in, v_tgt), rtol=0,
                               atol=1e-5)
    assert torch.equal(got, reg(v_in, v_tgt))
    rows = reg.kernel_rows()
    _, sums = _point_regress_cuda(v_in, v_tgt, *rows[:4], True, rows[4])
    assert torch.equal(sums, regress_sums_replay(v_in, v_tgt, *rows[:4]))
    assert regress_plan(P, B).cluster * regress_plan(P, B).span >= P


def test_k8_wrappers_reject_what_the_kernels_do_not_take(dev):
    x, y, _ = _clouds(dev, 2, 50, seed=5)
    with pytest.raises(TypeError):
        aligned_point_error(y.double(), x.double(), "procrustes")
    with pytest.raises(ValueError):
        aligned_point_error(y, x[:, :40].contiguous(), "procrustes")
    with pytest.raises(ValueError, match="contiguous"):
        aligned_point_error(y.transpose(1, 2).transpose(1, 2)[:, ::2],
                            x[:, ::2], "scale")
    with pytest.raises(ValueError, match="root"):
        aligned_point_error(y, x, "root", root=(50,))
    reg = _regressor(dev, 50, 30, 3, seed=6)
    with pytest.raises(TypeError):
        point_regress_error(y, x, reg.indices.long(), reg.weights,
                            reg.indices, reg.weights)
    with pytest.raises(ValueError):
        point_regress_error(y, x.cpu(), reg.indices, reg.weights,
                            reg.indices, reg.weights)
    with pytest.raises(ValueError, match="indexes"):
        reg(y[:, :10].contiguous(), x)


def test_k8_cuda_tensors_never_fall_back_to_plain(dev, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for CUDA tensors")

    monkeypatch.setattr(metrics, "aligned_point_error_plain", refuse)
    monkeypatch.setattr(metrics, "point_regress_error_plain", refuse)
    x, y, _ = _clouds(dev, 2, 60, seed=7)
    reg = _regressor(dev, 60, 40, 3, seed=8)
    a, r = ALIGN_KERNEL.launches, REGRESS_KERNEL.launches
    metrics.PointError("procrustes")(y, x)
    reg(y, x)
    assert (ALIGN_KERNEL.launches, REGRESS_KERNEL.launches) == (a + 1, r + 1)


def _chain_inputs(dev, B, seed):
    gen = torch.Generator().manual_seed(seed)
    data = make_synthetic_model_data("smplx", subdivisions=1)
    parents = data["kintree_table"][0].astype(np.int64)
    parents[0] = -1
    J = len(parents)
    rot = aa_to_rotmat(torch.randn(B, J, 3, generator=gen) * 0.5)
    joints = torch.randn(B, J, 3, generator=gen) * 0.3
    cts = [torch.randn(s, generator=gen) for s in
           ((B, J, 3), (B, J, 4, 4), (B, J, 4, 4))]
    return parents, rot.to(dev), joints.to(dev), [c.to(dev) for c in cts]


@pytest.mark.parametrize("with_world", [True, False],
                         ids=["d_world", "no-d_world"])
def test_chain_kernel_matches_plain(dev, with_world):
    """K3-chain forward within 1e-5 of the plain version (f32 3x4
    products in another order) and its backward within 1e-5 of autograd
    through the plain version in f64 and in f32 (the SMPL-X tree, 48
    bodies); two runs give the same bits."""
    parents, rot, joints, cts = _chain_inputs(dev, 48, seed=3)
    if not with_world:
        cts[2] = torch.zeros_like(cts[2])
    r, j = rot.clone().requires_grad_(), joints.clone().requires_grad_()
    before = dict(CHAIN_KERNEL.counts)
    got = batch_rigid_transform(r, j, parents)
    n = 3 if with_world else 2  # without: autograd passes no d_world
    torch.autograd.backward(got[:n], cts[:n])
    assert CHAIN_KERNEL.counts["chain_forward"] == before["chain_forward"] + 1
    assert CHAIN_KERNEL.counts["chain_backward"] == (
        before["chain_backward"] + 1)
    for dtype in (torch.float64, torch.float32):
        r2 = rot.to(dtype, copy=True).requires_grad_()
        j2 = joints.to(dtype, copy=True).requires_grad_()
        want = batch_rigid_transform_plain(r2, j2, parents)
        torch.autograd.backward(want, [c.to(dtype) for c in cts])
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w.float(), rtol=0, atol=1e-5)
        torch.testing.assert_close(r.grad, r2.grad.float(), rtol=0,
                                   atol=1e-5)
        torch.testing.assert_close(j.grad, j2.grad.float(), rtol=0,
                                   atol=1e-5)
    r3, j3 = rot.clone().requires_grad_(), joints.clone().requires_grad_()
    again = batch_rigid_transform(r3, j3, parents)
    torch.autograd.backward(again, cts)
    r4, j4 = rot.clone().requires_grad_(), joints.clone().requires_grad_()
    torch.autograd.backward(batch_rigid_transform(r4, j4, parents), cts)
    assert torch.equal(r3.grad, r4.grad) and torch.equal(j3.grad, j4.grad)


@pytest.mark.parametrize("B", [1, 32, 48])
@pytest.mark.parametrize("tree", ["synthetic_smplx", "smplx", "path64",
                                  "star64", "smpl"])
def test_chain_kernel_bit_equal_to_its_replays(dev, tree, B):
    """K3-chain's forward and backward bit-equal to
    ``chain_forward_replay`` / ``chain_backward_replay`` (the kernels'
    operations in their order), across two calls, and for a body alone
    as in its batch; one launch each."""
    from tests.chain_trees import TREES

    parents = TREES[tree]
    gen = torch.Generator().manual_seed(B)
    J = len(parents)
    rot = aa_to_rotmat(torch.randn(B, J, 3, generator=gen) * 0.3).to(dev)
    joints = (torch.randn(B, J, 3, generator=gen) * 0.3).to(dev)
    cts = [torch.randn(s, generator=gen).to(dev) for s in
           ((B, J, 3), (B, J, 4, 4), (B, J, 4, 4))]

    def run(sl=slice(None)):
        r = rot[sl].clone().requires_grad_()
        j = joints[sl].clone().requires_grad_()
        out = batch_rigid_transform(r, j, parents)
        return out, torch.autograd.grad(out, (r, j), [c[sl] for c in cts])

    before = dict(CHAIN_KERNEL.counts)
    out, grads = run()
    assert CHAIN_KERNEL.counts == {k: v + 1 for k, v in before.items()}
    want = chain_forward_replay(rot, joints, parents)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    want = chain_backward_replay(rot, joints, parents, *cts)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    out2, grads2 = run()
    assert all(torch.equal(a, b) for a, b in zip(out + grads, out2 + grads2))
    for i in sorted({0, B // 2, B - 1}):
        one, g1 = run(slice(i, i + 1))
        assert all(torch.equal(a[0], b[i]) for a, b in zip(one + g1,
                                                           out + grads))


@pytest.mark.parametrize("shape", SKIN_SHAPES, ids=str)
def test_skin_backward_kernel_matches_plain(dev, shape):
    """K3 backward: d rel_transforms and d v_posed against autograd
    through the plain version in f64 and f32 (atol 1e-5 of the largest
    gradient: sums over the vertices in f32), bit-equal to its order
    replay (``skin_backward_replay``), one launch a call."""
    w, rel, v, dv = _skin_inputs(dev, *shape, seed=4)
    before = SKIN_KERNEL.counts["skin_backward"]
    got = _skin_grads(skin, w, rel, v, dv)
    assert SKIN_KERNEL.counts["skin_backward"] == before + 1
    for dtype in (torch.float64, torch.float32):
        for g, want in zip(got, _skin_grads(skin_plain, w, rel, v, dv,
                                            dtype)):
            scale = max(1.0, float(want.abs().max()))
            torch.testing.assert_close(g, want, rtol=0, atol=1e-5 * scale)
    replay = skin_backward_replay(w, rel, v, dv)
    assert torch.equal(got[0], replay[0]) and torch.equal(got[1], replay[1])


@pytest.mark.parametrize("regime", [None, True, False],
                         ids=["planned", "fused", "split"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(48, 64, 16, 16), (6, 2048, 8, 8),
                                   (48, 384, 8, 8), (3, 48, 5, 7),
                                   (2, 36, 5, 5)],
                         ids=["stem", "stage4-head", "stage4-branch3",
                              "ragged", "c36"])
def test_batch_norm_kernel_matches_plain(dev, dtype, shape, regime,
                                         monkeypatch):
    """K4 forward and backward against the plain versions on the card:
    f32 rel 1e-4 (sums in another order), bf16 within one bf16 step of
    the values (the same roundings, f32 sums in another order); the
    running stats rel 1e-5; two runs give the same bits. Both passes in
    the regimes ``_bn_plan`` picks, and forced into each of its two (one
    cluster launch; partials, finalize and the elementwise pass); 36
    channels take one channel a thread."""
    if regime is not None:
        monkeypatch.setattr(layers, "_bn_plan", lambda R, C, forward=False:
                            layers._bn_plan_regime(R, C, regime))
    gen = torch.Generator().manual_seed(5)
    x = (torch.randn(shape, generator=gen) * 2 + 0.3).to(dev, dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    C = shape[1]
    gamma = (torch.rand(C, generator=gen) + 0.5).to(dev)
    beta = torch.randn(C, generator=gen).to(dev)
    dy = torch.randn(shape, generator=gen).to(dev, dtype).contiguous(
        memory_format=torch.channels_last)
    rm, rv = torch.zeros(C, device=dev), torch.ones(C, device=dev)

    def run():
        xs = x.clone().requires_grad_()
        g, b = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
        m, v = rm.clone(), rv.clone()
        y = batch_norm_train(xs, g, b, m, v)
        y.backward(dy)
        return y, xs.grad, g.grad, b.grad, m, v

    before = dict(BN_KERNEL.counts)
    got = run()
    assert BN_KERNEL.counts == {k: n + 1 for k, n in before.items()}
    y_p, mean_p, var_p = batch_norm_train_plain(x, gamma, beta)
    inv_p = torch.rsqrt(var_p + 1e-5)
    dx_p, dg_p, db_p = batch_norm_train_backward_plain(dy, x, gamma, mean_p,
                                                       inv_p)
    n = x.numel() // C
    m_p = 0.9 * rm + 0.1 * mean_p
    v_p = 0.9 * rv + 0.1 * var_p * (n / (n - 1))
    tol = (dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else
           dict(rtol=2 ** -7, atol=2 ** -7))
    for g, w in ((got[0], y_p), (got[1], dx_p)):
        torch.testing.assert_close(g.float(), w.float(), **tol)
    for g, w in ((got[2], dg_p), (got[3], db_p)):
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * scale)
    torch.testing.assert_close(got[4], m_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[5], v_p, rtol=1e-5, atol=1e-6)
    again = run()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("fused", [True, False], ids=["cluster", "split"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(48, 64, 32, 32), (48, 384, 8, 8),
                                   (3, 36, 5, 7)],
                         ids=["stem-like", "stage4", "ragged-c36"])
def test_batch_norm_forward_kernel_matches_plain(dev, dtype, shape, fused):
    """K4's forward (``_bn_forward_cuda``) forced into each regime (one
    cluster launch; partials, finalize and the elementwise pass) against
    ``batch_norm_train_plain``: y rel 1e-4 in f32, within one bf16 step
    of the values in bf16 (the same roundings; f32 sums in another order);
    the saved mean and inv and the running stats rel 1e-4 (f32 sums in
    another order); one ``bn_forward`` launch; two calls bit-equal. 36
    channels take one channel a thread."""
    gen = torch.Generator().manual_seed(15)
    x = (torch.randn(shape, generator=gen) * 2 + 0.3).to(dev, dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    C = shape[1]
    R = x.numel() // C
    gamma = (torch.rand(C, generator=gen) + 0.5).to(dev)
    beta = torch.randn(C, generator=gen).to(dev)
    rm0 = torch.randn(C, generator=gen).to(dev)
    rv0 = (torch.rand(C, generator=gen) + 0.5).to(dev)
    plan = layers._bn_plan_regime(R, C, fused)

    def run():
        rm, rv = rm0.clone(), rv0.clone()
        before = BN_KERNEL.counts["bn_forward"]
        y, mean, inv = layers._bn_forward_cuda(x, gamma, beta, rm, rv,
                                               1e-5, 0.1, plan)
        assert BN_KERNEL.counts["bn_forward"] == before + 1
        return y, mean, inv, rm, rv

    got = run()
    y_p, mean_p, var_p = batch_norm_train_plain(x, gamma, beta)
    inv_p = torch.rsqrt(var_p + 1e-5)
    m_p = 0.9 * rm0 + 0.1 * mean_p
    v_p = 0.9 * rv0 + 0.1 * var_p * (R / (R - 1))
    assert got[0].shape == x.shape
    assert got[0].is_contiguous(memory_format=torch.channels_last)
    tol = (dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else
           dict(rtol=2 ** -7, atol=2 ** -7))
    torch.testing.assert_close(got[0].float(), y_p.float(), **tol)
    for g, w in zip(got[1:], (mean_p, inv_p, m_p, v_p)):
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))
    again = run()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_batch_norm_kernel_is_the_gradient(dev):
    """K4's backward (f32) against autograd through the plain forward in
    f64: rel 1e-4 of the largest value."""
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((8, 40, 6, 6), generator=gen).to(dev) * 3 + 1
    gamma = (torch.rand(40, generator=gen) + 0.5).to(dev)
    beta = torch.randn(40, generator=gen).to(dev)
    dy = torch.randn(x.shape, generator=gen).to(dev)
    xs = x.clone().requires_grad_()
    g, b = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
    batch_norm_train(xs, g, b).backward(dy)
    x64, g64, b64 = (t.to(torch.float64, copy=True).requires_grad_()
                     for t in (x, gamma, beta))
    batch_norm_train_plain(x64, g64, b64)[0].backward(dy.double())
    for got, want in ((xs.grad, x64.grad), (g.grad, g64.grad),
                      (b.grad, b64.grad)):
        scale = float(want.abs().max())
        torch.testing.assert_close(got.double(), want, rtol=0,
                                   atol=1e-4 * scale)


def _measure_grads(meas, v, g_vals, g_heights, use_subsets, plain=False,
                   dtype=torch.float32, centroids=None):
    """d (measurements . g) / d v through the kernel, or autograd through
    the plain version in ``dtype`` (given ``centroids``, if any)."""
    x = v.to(dtype, copy=True).requires_grad_()
    if not plain:
        out = meas.measure(x, use_subsets)
    else:
        plane_faces = ([getattr(meas, f"subset_{n}") for n in PLANES]
                       if use_subsets else None)
        out = measure_plain(x, meas.faces, plane_faces, meas.anchors,
                            meas.num_hull_directions, meas.density,
                            meas.slice_mode, centroids)
    torch.autograd.backward(out, [g_vals.to(dtype), g_heights.to(dtype)],
                            retain_graph=not plain)
    return out, x.grad


def _tied_extremes(meas, vals) -> int:
    """Directions, over bodies and planes, whose max or min over the hits
    the kernel saved (centred on its centroids) more than one hit
    reaches."""
    _, hits, _, stats, _ = vals.grad_fn.saved_tensors
    tied = 0
    for b in range(hits.shape[0]):
        for p in range(3):
            n, cx, cz = stats[b, p, 0], stats[b, p, 1], stats[b, p, 2]
            q = hits[b, p, :int(n)]
            proj = ((q[:, :1] - cx) * meas.hull_cos
                    + (q[:, 1:] - cz) * meas.hull_sin)
            for ext in (proj.amax(0), proj.amin(0)):
                tied += int(((proj == ext).sum(0) > 1).sum())
    return tied


@pytest.mark.parametrize("slice_mode", ["reference", "exact"])
@pytest.mark.parametrize("case", ["all-faces", "subsets", "circumferences",
                                  "no-hits"])
def test_measure_backward_kernel_matches_plain(dev, body, slice_mode, case):
    """K1's backward (reference mode) and K1-exact's forward and backward
    against the plain version: forward as K1's test; the gradient for
    seeded cotangents on all eight outputs (or on the circumferences
    only) within 1e-4 of the largest gradient of autograd through the
    plain version in f32 given the kernel's centroids (``saved_centroids``:
    hits whose projections tie within the rounding of the centroid's sum
    then split the gradient alike; in exact mode y - h cancels near the
    plane and the two sides order its terms differently, 3.2e-5
    measured), and within 1e-4 of autograd in f64 on at least 99.5% of
    the vertices (the rest belong to hits at such ties or to hit tests
    that f64 decides the other way). The bodies (~1.5 sigma betas) give
    tied extreme hits (asserted in reference mode on all faces: duplicate
    hits of shared edges and the quad diagonal); subsets of face 0 alone
    (near the head) leave no plane with 2 hits. Two calls give the same
    bits, and each launches one forward and one backward."""
    model, base = body
    subsets = {n: (np.zeros(64, np.int32) if case == "no-hits" else
                   getattr(base, f"subset_{n}").cpu().numpy())
               for n in PLANES}
    meas = BodyMeasurements(base.anchors, model.faces, 256,
                            slice_mode=slice_mode,
                            face_subsets=subsets).to(dev)
    gen = torch.Generator().manual_seed(7)
    betas = torch.randn(6, 10, generator=gen) * 1.5
    v = model.forward_shape(betas.to(dev))["v_shaped"].detach().contiguous()
    g_vals = torch.randn(6, 5, generator=gen).to(dev)
    g_heights = torch.randn(6, 3, generator=gen).to(dev)
    if case == "circumferences":
        g_vals[:, :2] = 0.0
        g_heights.zero_()
    use_subsets = case in ("subsets", "no-hits")
    fwd = ("measure_forward" if slice_mode == "reference"
           else "measure_exact_forward")
    bwd = fwd.replace("forward", "backward")
    before = dict(MEASURE_KERNEL.counts)
    (vals, heights), got = _measure_grads(meas, v, g_vals, g_heights,
                                          use_subsets)
    assert MEASURE_KERNEL.counts[fwd] == before[fwd] + 1
    assert MEASURE_KERNEL.counts[bwd] == before[bwd] + 1
    if slice_mode == "reference" and case == "all-faces":
        assert _tied_extremes(meas, vals) > 0
    (want, want_h), want32 = _measure_grads(
        meas, v, g_vals, g_heights, use_subsets, plain=True,
        centroids=saved_centroids(vals).detach())
    torch.testing.assert_close(vals[:, :2], want[:, :2], rtol=1e-5, atol=0)
    torch.testing.assert_close(vals[:, 2:], want[:, 2:], rtol=0, atol=1e-5)
    torch.testing.assert_close(heights, want_h, rtol=0, atol=1e-6)
    assert bool((vals[:, 2:] > 0.5).all()) == (case != "no-hits")
    if case == "no-hits":
        assert bool((vals[:, 2:] == 0).all())
    scale = float(want32.abs().max())
    assert scale > 0
    torch.testing.assert_close(got, want32, rtol=0, atol=1e-4 * scale)
    _, want64 = _measure_grads(meas, v, g_vals, g_heights, use_subsets,
                               plain=True, dtype=torch.float64)
    per_vertex = ((got.double() - want64).abs().amax(-1)
                  / float(want64.abs().max()))
    assert float((per_vertex <= 1e-4).double().mean()) >= 0.995
    _, again = _measure_grads(meas, v, g_vals, g_heights, use_subsets)
    assert torch.equal(got, again)


@pytest.fixture(scope="module")
def full_body(dev):
    """The flagship's synthetic SMPL-X at the real counts (10475 vertices,
    20908 faces) with its candidate subsets: K1's cluster at its widest
    (16 CTAs on all faces)."""
    data = make_synthetic_model_data("smplx", subdivisions=5, seed=0,
                                     exact_counts=True)
    model = SMPLX(data).to(dev)
    anchors = MeasurementAnchors.synthetic(model.faces, data["v_template"])
    subsets = candidate_faces(data["v_template"], data["shapedirs"],
                              model.faces, anchors)
    return model, anchors, subsets


@pytest.mark.parametrize("batch", [1, 48])
@pytest.mark.parametrize("walk", ["all-faces", "subsets"])
@pytest.mark.parametrize("slice_mode", ["reference", "exact"])
def test_measure_forward_cluster_matches_plain(dev, full_body, slice_mode,
                                               walk, batch):
    """K1's forward (a thread-block cluster per (body, plane), sized by
    ``measure_plan``) at the real counts: mass and height rel 1e-5 (f32
    sums in another order), circumferences 1e-5 m (the same hit tests
    without FMA; centroid sums in another order), plane heights 1e-6;
    the saved hits and codes equal, in face order, those the plain slice's
    masks give at the kernel's plane heights (``saved_hits_plain``; in
    reference mode the code's candidate bits are the kernel's alone); two
    calls bit-equal; one launch."""
    model, anchors, subsets = full_body
    meas = BodyMeasurements(anchors, model.faces, 256, slice_mode=slice_mode,
                            face_subsets=subsets).to(dev)
    use_subsets = walk == "subsets"
    gen = torch.Generator().manual_seed(batch)
    betas = torch.randn(batch, 10, generator=gen) * 1.5
    v = model.forward_shape(betas.to(dev))["v_shaped"].detach().contiguous()
    plane_faces = ([getattr(meas, f"subset_{n}") for n in PLANES]
                   if use_subsets else None)
    F = meas.faces.shape[0]
    counts = meas.subset_counts if use_subsets else (F, F, F)
    if not use_subsets and batch == 1:
        assert measure_plan(counts, F, batch).cluster == 16
    fwd = ("measure_forward" if slice_mode == "reference"
           else "measure_exact_forward")
    before = MEASURE_KERNEL.counts[fwd]
    x = v.clone().requires_grad_()
    vals, heights = meas.measure(x, use_subsets)
    assert MEASURE_KERNEL.counts[fwd] == before + 1
    want, want_h = measure_plain(v, meas.faces, plane_faces, meas.anchors,
                                 256, meas.density, slice_mode)
    torch.testing.assert_close(vals[:, :2], want[:, :2], rtol=1e-5, atol=0)
    torch.testing.assert_close(vals[:, 2:], want[:, 2:], rtol=0, atol=1e-5)
    torch.testing.assert_close(heights, want_h, rtol=0, atol=1e-6)
    assert bool((vals[:, 2:] > 0.5).all())
    _, hits, codes, stats, _ = vals.grad_fn.saved_tensors
    ref = saved_hits_plain(v, meas.faces, plane_faces, heights.detach(),
                           slice_mode)
    keep = ~7 if slice_mode == "reference" else -1
    for b in range(batch):
        for p in range(3):
            pts, cds = ref[b][p]
            n = int(stats[b, p, 0])
            assert n == cds.shape[0]
            assert torch.equal(hits[b, p, :n], pts)
            assert torch.equal(codes[b, p, :n] & keep, cds)
    again, again_h = meas.measure(v, use_subsets)
    assert torch.equal(vals, again) and torch.equal(heights, again_h)
    vals2, _ = meas.measure(v.clone().requires_grad_(), use_subsets)
    _, hits2, codes2, stats2, _ = vals2.grad_fn.saved_tensors
    # stats: per plane the hit count and centroid, the volume sum
    assert torch.equal(stats[:, :3, :3], stats2[:, :3, :3])
    assert torch.equal(stats[:, 3, 0], stats2[:, 3, 0])
    for b in range(batch):
        for p in range(3):
            n = int(stats[b, p, 0])
            assert torch.equal(hits[b, p, :n], hits2[b, p, :n])
            assert torch.equal(codes[b, p, :n], codes2[b, p, :n])


def test_measure_cuda_tensors_never_fall_back_to_plain(dev, body,
                                                       monkeypatch):
    """Both slice modes launch their kernels on CUDA tensors, forward and
    backward; the plain version is never called."""
    from shapy_tpu_torch.measure import measurements

    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for CUDA tensors")

    monkeypatch.setattr(measurements, "measure_plain", refuse)
    model, base = body
    for mode in ("reference", "exact"):
        meas = BodyMeasurements(base.anchors, model.faces, 256,
                                slice_mode=mode).to(dev)
        betas = torch.zeros(2, 10, device=dev, requires_grad=True)
        v = model.forward_shape(betas)["v_shaped"]
        out = meas.forward_from_vertices(v, use_face_subsets=False)
        out["measurements"]["chest"]["tensor"].sum().backward()
        assert betas.grad is not None and bool(torch.isfinite(betas.grad)
                                               .all())


# -- K1-AoS: the triangle measurement surface --------------------------------


def _identity_plain(meas, tri, centroids=None, dtype=torch.float32):
    """K1's plain version on the triangles as (B, 3F, 3) vertices with the
    faces (3f, 3f + 1, 3f + 2): the values K1-AoS computes."""
    B, F = tri.shape[:2]
    faces = torch.arange(3 * F, device=tri.device).view(F, 3)
    return measure_plain(tri.reshape(B, 3 * F, 3).to(dtype), faces, None,
                         meas.anchors, meas.num_hull_directions, meas.density,
                         meas.slice_mode, centroids)


def _aos_case(model, dev, case, gen):
    """Mesh vertices (B, V, 3), their triangles (B, F', 3, 3) and
    ``forward`` keywords of a K1-AoS case:
    "body" 5 shaped bodies; "odd-F" 3 bodies cut to their first 1279 faces
    (F' odd, F' % 8 = 7: rows that start off 16 bytes); "even-F" cut to 1278
    (F' % 8 = 6: the reference masks' rows start off 16 bytes); "batch-1";
    "no-hit" 3 bodies, the second flattened onto one height (no plane cuts
    it: every row of its is empty); "unwalked" 2 bodies without the waist
    (the third plane walks no faces)."""
    batch = {"body": 5, "batch-1": 1, "unwalked": 2}.get(case, 3)
    betas = torch.randn(batch, 10, generator=gen) * 1.5
    v = model.forward_shape(betas.to(dev))["v_shaped"].detach().contiguous()
    if case == "no-hit":
        v[1, :, 1] = v[1, 0, 1]
    tri = v[:, model.faces_tensor.long()]
    F = {"odd-F": 1279, "even-F": 1278}.get(case, tri.shape[1])
    kwargs = {"compute_waist": False} if case == "unwalked" else {}
    return v, tri[:, :F].contiguous(), kwargs


AOS_CASES = ["body", "odd-F", "even-F", "batch-1", "no-hit", "unwalked"]


def _aos_saved(got):
    """The K1-AoS forward's saves (vertices, hits, codes, stats, plane_h),
    from its outputs."""
    return got["mass"]["tensor"]._base.grad_fn.saved_tensors


@pytest.mark.parametrize("case", AOS_CASES)
@pytest.mark.parametrize("slice_mode", ["reference", "exact"])
def test_measure_aos_kernel_matches_plain(dev, body, slice_mode, case):
    """K1-AoS (K1 on the triangles, then ``measure_points``) against the
    plain AoS version on the card: mass and height rel 1e-5 (f32 sums in
    another order), circumferences 1e-5 m, masks equal, points bit-equal
    in reference mode and within 1e-6 m in exact mode (y recomputed with
    the plain version's operations), height points exact; the values
    bit-equal to K1 on the same faces from the vertices; one launch of
    each kernel; the points and masks of every row (unwalked ones too)
    bit-equal to ``measure_points_replay`` on the forward's saves and on
    the plain saves, and a second call's; the gradient within 1e-4 of the
    largest of autograd through K1's plain version on the triangles given
    the kernel's centroids."""
    from shapy_tpu_torch.measure.measurements import (
        measure_points,
        measure_points_replay,
        saved_points_plain,
    )

    model, base = body
    meas = BodyMeasurements(base.anchors, model.faces, 256,
                            slice_mode=slice_mode).to(dev)
    gen = torch.Generator().manual_seed(9)
    v, tri, kwargs = _aos_case(model, dev, case, gen)
    B, F = tri.shape[:2]
    tri = tri.requires_grad_()
    fwd = ("measure_forward" if slice_mode == "reference"
           else "measure_exact_forward")
    before = dict(MEASURE_KERNEL.counts)
    got = meas(tri, **kwargs)["measurements"]
    assert MEASURE_KERNEL.counts[fwd] == before[fwd] + 1
    assert MEASURE_KERNEL.counts["measure_points"] == \
        before["measure_points"] + 1
    planes = [k for k in PLANES if k in got]
    assert len(planes) == (2 if case == "unwalked" else 3)
    with torch.no_grad():
        want = meas.forward_plain(tri, **kwargs)["measurements"]
    flat = torch.zeros(B, dtype=torch.bool, device=dev)
    if case == "no-hit":
        flat[1] = True
    for k in ("mass", "height"):
        g, w = got[k]["tensor"], want[k]["tensor"]
        torch.testing.assert_close(g[~flat], w[~flat], rtol=1e-5, atol=0)
        # the flat body's mass and height are 0 up to rounding: within
        # 1e-5 of the batch's largest
        torch.testing.assert_close(g[flat], w[flat], rtol=0,
                                   atol=1e-5 * float(w.abs().max()))
    assert torch.equal(got["height"]["points"], want["height"]["points"])
    for k in planes:
        g, w = got[k], want[k]
        torch.testing.assert_close(g["tensor"], w["tensor"], rtol=0,
                                   atol=1e-5)
        assert torch.equal(g["plane_height"], w["plane_height"])
        assert torch.equal(g["valid_points"], w["valid_points"])
        if slice_mode == "reference":
            assert torch.equal(g["points"], w["points"])
        else:
            torch.testing.assert_close(g["points"], w["points"], rtol=0,
                                       atol=1e-6)
        assert g["points"].requires_grad
        assert not g["valid_points"].requires_grad
    hit_rows = torch.stack([got[k]["valid_points"].reshape(B, -1).any(-1)
                            for k in planes], -1)
    assert bool(hit_rows.all()) == (case != "no-hit")
    saved = _aos_saved(got)
    points, valid = measure_points(saved, slice_mode)
    counts = (F, F, 0) if case == "unwalked" else (F, F, F)
    plain_saved = saved_points_plain(tri, saved[4], counts, slice_mode)
    for s in (saved, plain_saved):
        r_points, r_valid = measure_points_replay(s, slice_mode)
        assert torch.equal(points, r_points)
        assert torch.equal(valid, r_valid)
    again = measure_points(saved, slice_mode)
    assert torch.equal(again[0], points) and torch.equal(again[1], valid)
    for p, k in enumerate(planes):
        assert torch.equal(points[:, p].reshape(got[k]["points"].shape),
                           got[k]["points"])
    if case in ("body", "batch-1"):
        soa = meas.forward_from_vertices(v, use_face_subsets=False)
        for k in ("mass", "height") + PLANES:
            assert torch.equal(got[k]["tensor"],
                               soa["measurements"][k]["tensor"])
    if case == "no-hit":
        return  # the flattened body's planes have no gradient to compare
    keys = ("mass", "height", *planes)
    g_vals = torch.randn(B, len(keys), generator=gen).to(dev)
    loss = sum((g_vals[:, i] * got[k]["tensor"]).sum()
               for i, k in enumerate(keys))
    cents = saved_centroids(got["mass"]["tensor"]._base).detach()
    if case == "unwalked":  # the walk's planes: chest, hips, none
        cents = cents[:, [0, 0, 1]]
    grad = torch.autograd.grad(loss, tri)[0]
    x = tri.detach().clone().requires_grad_()
    vals, _ = _identity_plain(meas, x, cents)
    cols = [("mass", "height", *PLANES).index(k) for k in keys]
    want_g = torch.autograd.grad((vals[:, cols] * g_vals).sum(), x)[0]
    scale = float(want_g.abs().max())
    torch.testing.assert_close(grad, want_g, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("case", AOS_CASES)
@pytest.mark.parametrize("slice_mode", ["reference", "exact"])
def test_measure_points_backward_matches_plain(dev, body, slice_mode, case):
    """``measure_points_backward``: the gradient of a weighted sum of the
    slice points (masked slots included), in the triangles, against
    autograd through the plain AoS slice in f64 at the forward's plane
    heights (pinned values, gradient to the anchor triangle: the points'
    gradient is ill-conditioned in the height wherever a crossed edge is
    nearly horizontal, so a height one f32 rounding away is another
    reference), with the same hits (the masks are compared first),
    within 1e-5 of the largest gradient; one launch per backward; on the
    forward's saves, the gradient and the plane heights' cotangent
    bit-equal to ``measure_points_backward_replay`` and to a second
    call's, and nothing through a plane that walks no faces."""
    from shapy_tpu_torch.measure.measurements import (
        measure_points_backward,
        measure_points_backward_replay,
    )

    model, base = body
    meas = BodyMeasurements(base.anchors, model.faces, 256,
                            slice_mode=slice_mode).to(dev)
    gen = torch.Generator().manual_seed(10)
    _, tri, kwargs = _aos_case(model, dev, case, gen)
    B, F = tri.shape[:2]
    x = tri.clone().requires_grad_()
    got = meas(x, **kwargs)["measurements"]
    saved = _aos_saved(got)  # before the backward frees them
    planes = [k for k in PLANES if k in got]
    x64 = tri.double().requires_grad_()
    want = {}
    for k in planes:
        anchor = getattr(meas.anchors, k)
        h = geometry.face_barycentric_point(x64, anchor.face_idx,
                                            anchor.bary)[..., 1]
        h = h + (got[k]["plane_height"].detach().double() - h).detach()
        want[k] = (plane_slice_reference if slice_mode == "reference"
                   else plane_slice_triangles)(x64, h)
    w = {k: torch.randn(got[k]["points"].shape, generator=gen).to(dev)
         for k in planes}
    for k in planes:
        assert torch.equal(got[k]["valid_points"], want[k][1])
    before = MEASURE_KERNEL.counts["measure_points_backward"]
    grad = torch.autograd.grad(sum((w[k] * got[k]["points"]).sum()
                                   for k in planes), x)[0]
    assert MEASURE_KERNEL.counts["measure_points_backward"] == before + 1
    want_g = torch.autograd.grad(sum((w[k].double() * want[k][0]).sum()
                                     for k in planes), x64)[0]
    scale = float(want_g.abs().max())
    assert scale > 0
    torch.testing.assert_close(grad.double(), want_g, rtol=0,
                               atol=1e-5 * scale)
    counts = (F, F, 0) if case == "unwalked" else (F, F, F)
    g_points = torch.randn((B, 3, 6 * F), generator=gen).to(dev)
    g_tri, g_h = measure_points_backward(saved, g_points, counts, slice_mode)
    r_tri, r_h = measure_points_backward_replay(saved, g_points, counts,
                                                slice_mode)
    assert torch.equal(g_tri, r_tri) and torch.equal(g_h, r_h)
    again = measure_points_backward(saved, g_points, counts, slice_mode)
    assert torch.equal(again[0], g_tri) and torch.equal(again[1], g_h)
    if case == "unwalked":
        assert not bool(g_h[:, 2].any())
        g_points[:, 2] = 0
        assert torch.equal(measure_points_backward(
            saved, g_points, counts, slice_mode)[0], g_tri)


def test_measure_aos_gradient_after_an_inference_mode_call(dev, body):
    """The triangle surface caches its topology and anchor buffers per
    mesh size: a first call under ``inference_mode`` (the scorer's) must
    not leave inference tensors there that a later differentiated call
    saves for its backward."""
    model, base = body
    meas = BodyMeasurements(base.anchors, model.faces, 256).to(dev)
    betas = torch.zeros(2, 10, device=dev)
    faces = model.faces_tensor.long()
    with torch.inference_mode():
        meas(model.forward_shape(betas)["v_shaped"][:, faces])
    v = model.forward_shape(betas)["v_shaped"].detach().requires_grad_()
    m = meas(v[:, faces])["measurements"]
    loss = (m["height"]["tensor"].sum() + m["height"]["points"].sum()
            + m["chest"]["points"].square().sum())
    loss.backward()
    assert bool(torch.isfinite(v.grad).all()) and float(v.grad.abs().max()) > 0


def test_measure_aos_cuda_tensors_never_fall_back_to_plain(dev, body,
                                                           monkeypatch):
    """The triangle surface launches K1-AoS on CUDA tensors in both modes,
    forward and backward, for every ``compute_*`` entry; the plain slices
    and hull are never called; an anchor beyond the triangles raises."""
    from shapy_tpu_torch.measure import measurements

    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for CUDA tensors")

    for name in ("plane_slice_reference", "plane_slice_triangles",
                 "hull_perimeter_support", "signed_volume", "measure_plain"):
        monkeypatch.setattr(measurements, name, refuse)
    model, base = body
    for mode in ("reference", "exact"):
        meas = BodyMeasurements(base.anchors, model.faces, 256,
                                slice_mode=mode).to(dev)
        betas = torch.zeros(2, 10, device=dev, requires_grad=True)
        tri = model.forward_shape(betas)["v_shaped"][
            :, model.faces_tensor.long()]
        out = meas(tri, compute_waist=False)["measurements"]
        assert set(out) == {"mass", "height", "chest", "hips"}
        (out["chest"]["tensor"].sum() + meas.compute_mass(tri).sum()
         + meas.compute_height(tri)[0].sum()).backward()
        assert betas.grad is not None and bool(torch.isfinite(betas.grad)
                                               .all())
        one = meas.compute_periphery(tri.detach(), meas.anchors.hips)
        torch.testing.assert_close(one["tensor"], out["hips"]["tensor"],
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="anchor face"):
        meas(tri[:, :10].detach())


# -- contact and distance kernels: K6, K7, K9 --------------------------------


def _body_pair(model, dev, batch=2, seed=11, shift=(0.02, 0.01, 0.03)):
    """Triangles (batch, F, 3, 3) of bodies A (seeded betas and pose) and
    B (other betas, A's pose, shifted a few cm): the surfaces cross, and
    no vertex is shared."""
    gen = torch.Generator().manual_seed(seed)
    pose = (torch.randn(batch, model.NUM_BODY_JOINTS, 3, generator=gen)
            * 0.2).to(dev)
    faces = model.faces_tensor.long()
    tris = []
    for k in range(2):
        betas = (torch.randn(batch, 10, generator=gen) * 1.5).to(dev)
        v = model(betas=betas, body_pose=pose)["vertices"]
        if k:
            v = v + torch.tensor(shift, device=dev)
        tris.append(v[:, faces].contiguous())
    return tris


@pytest.mark.parametrize("max_collisions", [256, 3],
                         ids=["all-hits", "truncated"])
def test_tri_tri_kernel_matches_plain(dev, body, max_collisions):
    """K6 against its plain version on the card: identical faces (the same
    decisions: no FMA, x-y-z sums) and barycentrics within 1e-5; at 3
    slots the kept ids are the first 3 of the all-hits run, in index
    order; one launch per call."""
    model, _ = body
    a, b = _body_pair(model, dev)
    before = TRI_KERNEL.launches
    faces, bcs = mesh_mesh_intersection(a, b, max_collisions)
    assert TRI_KERNEL.launches == before + 1
    want_f, want_b = tri_tri.mesh_mesh_intersection_plain(
        a, b, max_collisions, query_chunk=256)
    assert torch.equal(faces, want_f)
    torch.testing.assert_close(bcs, want_b, rtol=0, atol=1e-5)
    assert int((faces >= 0).sum()) > 100
    if max_collisions == 3:
        full, _ = mesh_mesh_intersection(a, b, 256)
        full = full.reshape(*full.shape[:1], -1, 256)
        assert bool(((full >= 0).sum(-1) > 3).any())
        assert torch.equal(faces.reshape(*full.shape[:2], 3), full[..., :3])


def test_tri_tri_kernel_plane_query_matches_exact_slice(dev, body):
    """The plane-against-body use: a +-1 m quad at a height crosses
    exactly the faces that the exact slice marks."""
    model, _ = body
    a, _ = _body_pair(model, dev, batch=1)
    F = a.shape[1]
    for h in (-0.3, 0.05, 0.4):
        quad = torch.tensor([[[-1.0, h, -1], [1, h, -1], [1, h, 1]],
                             [[-1.0, h, -1], [1, h, 1], [-1, h, 1]]],
                            device=dev)[None]
        faces, bcs = MeshMeshIntersection(1024)(quad, a)
        found = set(faces[faces >= 0].tolist())
        t = a.permute(0, 3, 2, 1)
        _, _, mask = plane_slice_soa(t[:, 1], t[:, 0], t[:, 2],
                                     torch.tensor([h], device=dev))
        assert found == set(torch.nonzero(mask[0, :F])[:, 0].tolist())
        assert len(found) > 10


def _pairs_from(faces, M, F, C=None):
    """K6's hits as (receiver = target + F, intruder = query) pairs,
    (B, C, 2) int32, -1-padded."""
    out = []
    for row in faces:
        slots = torch.nonzero(row >= 0)[:, 0]
        out.append(torch.stack([row[slots] + F, slots // M], dim=-1))
    C = C or max(len(p) for p in out)
    pairs = torch.full((len(out), C, 2), -1, dtype=torch.int32,
                       device=faces.device)
    for k, p in enumerate(out):
        pairs[k, :len(p)] = p.to(torch.int32)
    return pairs


@pytest.mark.parametrize("penalize_outside", [True, False])
def test_repulsion_kernel_matches_plain(dev, body, penalize_outside):
    """K7 on two crossing bodies' contact pairs (from K6), sigma 0.5 and 2
    cm: the value within rel 1e-5 of the plain version in f32 (the pairs
    summed in another order), the gradient within 1e-4 of the largest of
    autograd through the plain version in f64; two calls give the same
    bits; one forward and one backward launch."""
    model, _ = body
    a, b = _body_pair(model, dev)
    F = a.shape[1]
    faces, _ = mesh_mesh_intersection(a, b, 64)
    pairs = _pairs_from(faces, 64, F)
    tris = torch.cat([a, b], dim=1).contiguous()
    for sigma in (0.5, 0.02):
        kw = dict(sigma=sigma, penalize_outside=penalize_outside)
        cot = torch.tensor([1.0, -0.6], device=dev)
        x = tris.clone().requires_grad_()
        f0, b0 = (REPULSION_KERNEL.counts[k] for k in
                  ("repulsion_forward", "repulsion_backward"))
        loss = repulsion_loss(x, pairs, **kw)
        got, = torch.autograd.grad((loss * cot).sum(), x)
        assert REPULSION_KERNEL.counts["repulsion_forward"] == f0 + 1
        assert REPULSION_KERNEL.counts["repulsion_backward"] == b0 + 1
        want = repulsion.repulsion_loss_plain(tris, pairs, **kw)
        assert bool((want > 0).all())
        torch.testing.assert_close(loss, want, rtol=1e-5, atol=0)
        x64 = tris.double().requires_grad_()
        want64, = torch.autograd.grad(
            (repulsion.repulsion_loss_plain(x64, pairs, **kw)
             * cot.double()).sum(), x64)
        scale = float(want64.abs().max())
        assert float((got.double() - want64).abs().max()) <= 1e-4 * scale
        x2 = tris.clone().requires_grad_()
        again, = torch.autograd.grad(
            (repulsion_loss(x2, pairs, **kw) * cot).sum(), x2)
        assert torch.equal(got, again)


def test_repulsion_kernel_padded_pairs_add_nothing(dev):
    gen = torch.Generator().manual_seed(3)
    tris = (torch.randn(2, 30, 3, 3, generator=gen) * 0.02).to(dev)
    pairs = torch.randint(0, 30, (2, 12, 2), generator=gen,
                          dtype=torch.int32).to(dev)
    padded = torch.cat([pairs, torch.full_like(pairs[:, :5], -1)], dim=1)
    padded[0, 3, 1] = -1
    keep = pairs.clone()
    keep[0, 3] = -1
    x, y = tris.clone().requires_grad_(), tris.clone().requires_grad_()
    l1, l2 = repulsion_loss(x, padded), repulsion_loss(y, keep)
    g1, = torch.autograd.grad(l1.sum(), x)
    g2, = torch.autograd.grad(l2.sum(), y)
    torch.testing.assert_close(l1, l2, rtol=1e-6, atol=0)
    torch.testing.assert_close(g1, g2, rtol=0, atol=0)
    empty = torch.full_like(pairs, -1)
    z = tris.clone().requires_grad_()
    l3 = repulsion_loss(z, empty)
    g3, = torch.autograd.grad(l3.sum(), z)
    assert bool((l3 == 0).all()) and bool((g3 == 0).all())


def _nan_equal(a, b):
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _on_axis_pair(dev):
    """An intruder vertex exactly on the receiver's cone axis, 1 m in
    front (intensity 0): the pair adds 0, and its gradient is NaN in the
    plain version (``tests/test_torch_repulsion_plan.py``)."""
    a = 2.0 ** -6
    tris = torch.zeros(1, 4, 3, 3)
    tris[0, 0] = torch.tensor([[0, 0, 0], [a, 0, 0], [0, a, 0]])
    tris[0, 1] = torch.tensor([[a / 2, a / 2, 1.0],
                               [a / 2, a / 2 + 0.01, 1.0],
                               [a / 2, a / 2, 1.01]])
    tris[0, 2:] = tris[0, :2] + 0.3
    return (tris.to(dev),
            torch.tensor([[[0, 1], [2, 3]]], dtype=torch.int32, device=dev))


def _k7_inputs(case, dev, model):
    if case == "on-axis":
        return _on_axis_pair(dev)
    if case == "face-in-45":
        gen = torch.Generator().manual_seed(7)
        tris = (torch.randn(1, 48, 3, 3, generator=gen) * 0.02).to(dev)
        pairs = torch.randint(0, 48, (1, 90, 2), generator=gen,
                              dtype=torch.int32)
        pairs[0, ::2, 1] = 7
        return tris, pairs.to(dev)
    a, b = _body_pair(model, dev)
    F = a.shape[1]
    faces, _ = mesh_mesh_intersection(a, b, 64)
    pairs = _pairs_from(faces, 64, F)
    tris = torch.cat([a, b], dim=1).contiguous()
    if case == "bodies":
        return tris, pairs
    if case == "padded-row":
        pairs[1] = -1
        pairs[0, 3, 1] = -1
        return tris, pairs
    return tris, pairs[:, :0].contiguous()  # no pairs


@pytest.mark.parametrize("case", ["bodies", "face-in-45", "padded-row",
                                  "no-pairs", "on-axis"])
def test_repulsion_kernel_matches_its_replays(dev, body, case):
    """K7's entry points against the replays, bit for bit: the loss and its
    f64 total against ``repulsion_forward_replay`` of the kernel's
    per-pair penalties (those equal to the plain version's on the card,
    the live bytes to its live mask), the gradient against
    ``repulsion_backward_replay`` of the kernel's entries (NaN where NaN:
    the on-axis pair keeps the plain version's NaN); two calls bit-equal,
    and the state kept between calls (tickets 0, face heads -1) left as
    found."""
    model, _ = body
    tris, pairs = _k7_inputs(case, dev, model)
    B, F = tris.shape[:2]
    consts = repulsion._constants(0.5, True, 1000.0)
    cot = torch.linspace(1.0, -0.5, B, device=dev)
    loss, live, total, pen = repulsion._repulsion_forward_cuda(
        tris, pairs, consts, per_pair=True)
    grad, entries = repulsion._repulsion_backward_cuda(tris, pairs, cot,
                                                       live, consts)
    again = repulsion._repulsion_forward_cuda(tris, pairs, consts)
    grad2, _ = repulsion._repulsion_backward_cuda(tris, pairs, cot, live,
                                                  consts)
    pen_plain, live_plain = repulsion.repulsion_pairs_plain(tris, pairs)
    assert torch.equal(pen, pen_plain)
    assert torch.equal(live.bool(), live_plain)
    rep_loss, rep_total = repulsion.repulsion_forward_replay(pen)
    assert torch.equal(loss, rep_loss) and torch.equal(total, rep_total)
    assert _nan_equal(grad, repulsion.repulsion_backward_replay(
        entries, pairs, F, live, cot))
    assert torch.equal(loss, again[0]) and torch.equal(total, again[2])
    assert _nan_equal(grad, grad2)
    x64 = tris.double().requires_grad_()
    want, = torch.autograd.grad(
        (repulsion.repulsion_loss_plain(x64, pairs) * cot.double()).sum(),
        x64, allow_unused=True)
    if want is None:
        want = torch.zeros_like(x64)
    assert bool((torch.isnan(grad) | ~torch.isnan(want)).all())
    assert bool(torch.isnan(want).any()) == (case == "on-axis")
    for key, t in repulsion._STATE.items():
        assert bool((t == (-1 if key[0] == "heads" else 0)).all())


def test_repulsion_kernel_runs_its_own_device_kernels(dev, body):
    """One device kernel a forward, two a backward (the pair pass, the face
    pass), all of them ``repulsion.cu``'s: no library sort, no
    searchsorted, no memset, from a ``torch.profiler`` trace; a gradient
    of ``loss.sum()`` (a stride-0 cotangent) is taken as it is."""
    model, _ = body
    tris, pairs = _k7_inputs("bodies", dev, model)
    x = tris.clone().requires_grad_()
    own = REPULSION_KERNEL.device_functions()
    total = repulsion_loss(x, pairs).sum()
    torch.autograd.grad(total, x, retain_graph=True)
    torch.cuda.synchronize()
    for fn, n in ((lambda: repulsion_loss(x, pairs), 1),
                  (lambda: torch.autograd.grad(total, x,
                                               retain_graph=True), 2)):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        k7 = [m for m in names if any(f"{f}(" in m for f in own)]
        assert len(k7) == n, names
        # the backward's one other kernel: autograd's fill of the sum's
        # cotangent (1.0), the caller's
        assert len(names) - len(k7) <= n - 1, names


def test_repulsion_kernel_keeps_its_state_per_stream(dev, body):
    """A call on a side stream makes its own tickets and heads and gives
    the same bits as one on the default stream."""
    model, _ = body
    tris, pairs = _k7_inputs("bodies", dev, model)
    cot = torch.tensor([1.0, -0.6], device=dev)
    x = tris.clone().requires_grad_()
    got, = torch.autograd.grad((repulsion_loss(x, pairs) * cot).sum(), x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = tris.clone().requires_grad_()
        loss = repulsion_loss(y, pairs)
        again, = torch.autograd.grad((loss * cot).sum(), y)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    streams = {key[2] for key in repulsion._STATE}
    assert side.cuda_stream in streams and len(streams) >= 2


@pytest.mark.parametrize("case", ["bodies", "identical", "small-b"])
def test_nn_dists_kernel_matches_plain(dev, body, case):
    """K9 against its plain version: distances within 1e-5 m (the same
    f32 expansion summed in the same order, so equal in practice);
    F-score, precision and recall equal unless a point's two distances
    fall on either side of the threshold; identical clouds give distance
    0."""
    model, _ = body
    gen = torch.Generator().manual_seed(5)
    if case == "bodies":
        a, b = (t[0].reshape(-1, 3, 3).mean(1) for t in
                _body_pair(model, dev, batch=1))
    elif case == "identical":
        a = (torch.randn(3000, 3, generator=gen) * 0.4).to(dev)
        b = a.clone()
    else:
        a = (torch.randn(777, 3, generator=gen) * 0.4).to(dev)
        b = (torch.randn(5, 3, generator=gen) * 0.4).to(dev)
    a, b = a.contiguous(), b.contiguous()
    d = []
    for p, q in ((a, b), (b, a)):
        got = metrics._nn_dists(p, q)
        want = metrics.nn_dists_plain(p, q)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        if case == "identical":
            assert bool((got == 0).all())
        d.append((got, want))
    for thresh in (0.005, 0.01, 0.02):
        got = metrics.point_fscore(a, b, thresh)
        want = metrics.fscore_from_dists(d[0][1], d[1][1], thresh)
        if not any(bool(((g < thresh) != (w < thresh)).any()) for g, w in d):
            for k in got:
                assert float(got[k]) == float(want[k]), (case, thresh, k)


def _k6_cases(model, dev):
    """(name, query, target, M, plan) of K6's regimes: a body pair (warp a
    query), the pair's first 300 queries (a block a query), plane quads at
    three heights (more hits than 8 slots), lists forced to overflow, and
    planted coincident boxes (a target repeated) and degenerate triangles
    (a vertex repeated, in a query and in a target)."""
    a, b = _body_pair(model, dev, batch=2)
    F = a.shape[1]
    quads = []
    for h in (-0.3, 0.05, 0.4):
        quads += [[[-1.0, h, -1], [1, h, -1], [1, h, 1]],
                  [[-1.0, h, -1], [1, h, 1], [-1, h, 1]]]
    quads = torch.tensor(quads, device=dev)[None].expand(2, 6, 3, 3)
    quads = quads.contiguous()
    planted = b.clone()
    planted[:, 5] = planted[:, 100]
    planted[:, 7, 2] = planted[:, 7, 0]
    q2 = a.clone()
    q2[:, 9, 1] = q2[:, 9, 0]
    nc = -(-F // 32)
    return [("pair", a, b, 256, None),
            ("team", a[:, :300].contiguous(), b, 256,
             tri_tri.TriTriPlan(nc, 256, 8)),
            ("planes", quads, a, 1024, None),
            ("planes, 8 slots", quads, a, 8, None),
            ("planes, list of 32", quads, a, 1024,
             tri_tri.TriTriPlan(nc, 32, 8)),
            ("pair, list of 1", a, b, 3, tri_tri.TriTriPlan(nc, 1, 1)),
            ("planted", q2, planted, 16, None)]


def test_tri_tri_kernel_matches_its_replay(dev, body):
    """K6 in each regime: ids equal to the plain version's and to the
    replay's, barycentrics bit-equal; its Morton order the replay's; the
    overflow counter the replay's count of queries whose hits overflow
    their list; two calls bit-equal."""
    model, _ = body
    for name, q, t, M, plan in _k6_cases(model, dev):
        tri_tri.reset_overflowed()
        faces, bcs, order = tri_tri._mesh_mesh_intersection_cuda(q, t, M,
                                                                 plan)
        again = tri_tri._mesh_mesh_intersection_cuda(q, t, M, plan)
        over = tri_tri.overflowed_queries()
        want_f, want_b, info = tri_tri.mesh_mesh_intersection_replay(
            q, t, M, plan, query_chunk=256)
        plain_f, plain_b = tri_tri.mesh_mesh_intersection_plain(
            q, t, M, query_chunk=256)
        assert torch.equal(faces, plain_f) and torch.equal(bcs, plain_b), name
        assert torch.equal(want_f, plain_f) and torch.equal(want_b, plain_b)
        assert torch.equal(order.long(), info["order"]), name
        assert torch.equal(faces, again[0]) and torch.equal(bcs, again[1])
        assert over == 2 * int(info["overflowed"].sum()), name
        if "list" in name:
            assert over > 0, name


def test_tri_tri_kernel_counts_the_replays_tests(dev, body):
    """K6's counting build: the same ids and barycentrics as the plain
    build, and the tests its walk made (supercluster boxes, cluster
    boxes, face boxes, Möller tests) the replay's totals, in each
    regime."""
    model, _ = body
    for name, q, t, M, plan in _k6_cases(model, dev):
        tested = torch.zeros(4, dtype=torch.int64, device=dev)
        faces, bcs, _ = tri_tri._mesh_mesh_intersection_cuda(q, t, M, plan)
        got_f, got_b, _ = tri_tri._mesh_mesh_intersection_cuda(q, t, M, plan,
                                                                tested)
        _, _, info = tri_tri.mesh_mesh_intersection_replay(
            q, t, M, plan, query_chunk=256)
        assert torch.equal(faces, got_f) and torch.equal(bcs, got_b), name
        want = [q.shape[0] * q.shape[1] * info["superclusters_tested"],
                *(int(info[k].sum()) for k in (
                    "clusters_tested", "faces_tested", "box_passed"))]
        assert tested.tolist() == want, name


def test_nn_dists_kernel_matches_its_replay(dev, body):
    """K9: distances bit-equal to the plain version both ways and through
    ``nn_dists_both`` (one launch), neighbour indices equal to the
    replay's (the first index on ties: duplicates and equidistant points
    planted in b), also under a plan whose ranges span several staged
    tiles."""
    model, _ = body
    a, b = (t[0].reshape(-1, 3, 3).mean(1) for t in
            _body_pair(model, dev, batch=1))
    gen = torch.Generator().manual_seed(8)
    x = (torch.randn(3000, 3, generator=gen) * 0.3).to(dev)
    y = (torch.randn(5000, 3, generator=gen) * 0.3).to(dev)
    y[100:200] = y[0:100]
    y[4999] = y[5]
    x[:50] = 0.0
    y[300], y[301] = torch.tensor([1e-3, 0, 0]), torch.tensor([-1e-3, 0, 0])
    per = metrics._NN_THREADS * metrics._NN_R
    for p, q, plans in ((a.contiguous(), b.contiguous(), None),
                        (x, y, None),
                        (x, y, (metrics.NNPlan(-(-3000 // per), 1, 5000),
                                metrics.NNPlan(-(-5000 // per), 2, 1500)))):
        before = NN_KERNEL.launches
        d_pq, d_qp = metrics.nn_dists_both(p, q)
        assert NN_KERNEL.launches == before + 1
        assert torch.equal(d_pq, metrics.nn_dists_plain(p, q))
        assert torch.equal(d_qp, metrics.nn_dists_plain(q, p))
        out, idx = metrics._nn_search_cuda(p, q, True, plans)
        plans = plans or metrics.nn_plan(len(p), len(q), True)
        for (u, v), plan, d, i in zip(((p, q), (q, p)), plans,
                                      out.split([len(p), len(q)]),
                                      idx.split([len(p), len(q)])):
            want_d, want_i = metrics.nn_search_replay(u, v, plan)
            assert torch.equal(d, want_d) and torch.equal(i.long(), want_i)
    assert int(idx[0]) == 300


def test_contact_cuda_tensors_never_fall_back_to_plain(dev, monkeypatch):
    """K6, K7 (value and gradient) and K9 launch their kernels on CUDA
    tensors; their plain versions are never called."""
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for CUDA tensors")

    monkeypatch.setattr(tri_tri, "mesh_mesh_intersection_plain", refuse)
    monkeypatch.setattr(repulsion, "repulsion_loss_plain", refuse)
    monkeypatch.setattr(metrics, "nn_dists_plain", refuse)
    gen = torch.Generator().manual_seed(9)
    tris = (torch.randn(1, 40, 3, 3, generator=gen) * 0.1).to(dev)
    counts = (TRI_KERNEL.launches, NN_KERNEL.launches,
              dict(REPULSION_KERNEL.counts))
    mesh_mesh_intersection(tris, tris + 0.01, 8)
    x = tris.clone().requires_grad_()
    pairs = torch.tensor([[[0, 1], [2, 3]]], dtype=torch.int32, device=dev)
    repulsion_loss(x, pairs).sum().backward()
    metrics.point_fscore(tris[0, :, 0].contiguous(),
                         tris[0, :, 1].contiguous(), 0.05)
    assert TRI_KERNEL.launches == counts[0] + 1
    assert NN_KERNEL.launches == counts[1] + 1  # both directions at once
    for k in ("repulsion_forward", "repulsion_backward"):
        assert REPULSION_KERNEL.counts[k] == counts[2][k] + 1


def test_contact_wrappers_reject_what_the_kernels_do_not_take(dev):
    tris = torch.zeros(1, 8, 3, 3, device=dev)
    with pytest.raises(TypeError):
        mesh_mesh_intersection(tris.double(), tris.double())
    with pytest.raises(ValueError, match="contiguous"):
        mesh_mesh_intersection(tris.transpose(2, 3), tris)
    with pytest.raises(ValueError):
        mesh_mesh_intersection(tris, tris[0])
    with pytest.raises(RuntimeError, match="forward-only"):
        mesh_mesh_intersection(tris.clone().requires_grad_(), tris)
    pairs = torch.zeros(1, 2, 2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        repulsion_loss(tris, pairs.long())
    with pytest.raises(TypeError):
        repulsion_loss(tris.double(), pairs)
    pts = torch.zeros(10, 3, device=dev)
    with pytest.raises(ValueError):
        metrics._nn_dists(pts[:, :2].contiguous(), pts)
    with pytest.raises(ValueError, match="contiguous"):
        metrics._nn_dists(pts.t().contiguous().t(), pts)
    with pytest.raises(ValueError, match="empty"):
        metrics._nn_dists(pts, pts[:0])
    with pytest.raises(ValueError, match="on cpu"):
        metrics._nn_dists(pts, pts.cpu())


def test_repulsion_kernel_stops_on_an_id_out_of_range(dev):
    """An id at or above F stops K7 with a device-side assert, as indexing
    a CUDA tensor out of range does, and the next synchronisation raises;
    the wrapper reads no id back to the host. Run in an interpreter of
    its own, since the assert ends its CUDA context."""
    script = (
        "import torch\n"
        "from shapy_tpu_torch.ops import repulsion_loss\n"
        "tris = torch.zeros(1, 8, 3, 3, device='cuda')\n"
        "pairs = torch.tensor([[[0, 1], [8, 2]]], dtype=torch.int32,\n"
        "                     device='cuda')\n"
        "loss = repulsion_loss(tris, pairs)\n"
        "print('launched', flush=True)\n"
        "torch.cuda.synchronize()\n"
        "print('synchronised', flush=True)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert "launched" in proc.stdout, proc.stderr
    assert "synchronised" not in proc.stdout
    assert proc.returncode != 0
    assert "device-side assert" in proc.stderr, proc.stderr


def test_point_fscore_keeps_clouds_on_their_device(dev):
    """point_fscore moves no cloud between devices: a CUDA cloud with a
    CPU one, or with ``device="cpu"``, raises; arrays go to the card by
    default (K9, twice) and give the F-score of the same clouds as
    tensors there."""
    gen = torch.Generator().manual_seed(4)
    a = torch.randn(300, 3, generator=gen) * 0.1
    b = torch.randn(200, 3, generator=gen) * 0.1
    with pytest.raises(ValueError, match="expected"):
        metrics.point_fscore(a.to(dev), b, 0.01)
    with pytest.raises(ValueError, match="expected"):
        metrics.point_fscore(a, b.to(dev), 0.01)
    with pytest.raises(ValueError, match="expected"):
        metrics.point_fscore(a.to(dev), b.to(dev), 0.01, device="cpu")
    before = NN_KERNEL.launches
    got = metrics.point_fscore(a.numpy(), b.numpy(), 0.01)
    assert NN_KERNEL.launches == before + 1
    want = metrics.point_fscore(a.to(dev), b.to(dev), 0.01, device="cuda")
    for k in want:
        assert got[k].device.type == "cuda"
        assert float(got[k]) == float(want[k])


# -- backbone kernels: K5-conv, K5-fuse --------------------------------------


# (Cin, Cout, k, stride, input side, bias, residual, relu): the stem, the
# heaviest 3x3 shapes (Cout 48 and 96 tile badly), a stride-2 fuse hop, a
# residual 1x1 and the head's 2048-channel 1x1, at small batch; then the
# wgmma kernel's K partitions with the residual epilogue (8^2, 11
# partitions at batch 3), a stride-2 3x3 at an odd side with the residual
# (2 partitions), a stride-2 1x1, and 40 channels (K steps of 16 past Cin,
# a ragged N tile).
CONV_CASES = [
    (3, 64, 3, 2, 64, True, False, True),
    (48, 48, 3, 1, 32, True, True, True),
    (96, 96, 3, 1, 16, True, False, True),
    (48, 96, 3, 2, 32, True, False, False),
    (64, 256, 1, 1, 16, True, True, True),
    (384, 48, 1, 1, 8, True, False, False),
    (2048, 2048, 1, 1, 8, False, False, False),
    (256, 48, 3, 1, 17, False, True, True),
    (384, 384, 3, 1, 8, True, True, True),
    (64, 64, 3, 2, 15, True, True, True),
    (48, 96, 1, 2, 9, False, False, True),
    (40, 40, 3, 1, 8, True, True, False),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "-".join(
    str(int(v)) for v in c))
def test_conv_kernel_matches_plain(dev, dtype, case):
    """K5-conv against ``conv2d_act_plain`` (cuDNN without TF32, then the
    eager epilogue) on the card, batch 3: bf16 within
    ``conv2d_act_bf16_tolerance`` (one bf16 step of the plain value at
    each rounding of the epilogue plus the worst-case gap of two f32 sums
    of the same K products in other orders; the sums differ in order
    only); f32 within 1e-5 of the largest |y|; channels_last output, one
    launch."""
    cin, cout, k, stride, size, has_bias, has_res, relu = case
    gen = torch.Generator().manual_seed(cin + cout + k)
    cl = torch.channels_last
    x = torch.randn((3, cin, size, size), generator=gen).abs()
    w = torch.randn((cout, cin, k, k), generator=gen) / (cin * k * k) ** 0.5
    b = torch.randn(cout, generator=gen) * 0.3 if has_bias else None
    out = (size + 2 * (k // 2) - k) // stride + 1
    r = torch.randn((3, cout, out, out), generator=gen) if has_res else None

    def put(t):
        return None if t is None else t.to(dev, dtype).contiguous(
            memory_format=cl)

    x, w, r = put(x), put(w), put(r)
    b = None if b is None else b.to(dev, dtype)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = CONV_KERNEL.launches
        got = conv2d_act(x, w, b, r, relu, stride)
        assert CONV_KERNEL.launches == before + 1
        want = conv2d_act_plain(x, w, b, r, relu, stride)
        c = torch.nn.functional.conv2d(x, w, None, stride, k // 2).float()
        terms = torch.nn.functional.conv2d(x.abs().float(), w.abs().float(),
                                           None, stride, k // 2)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert got.shape == want.shape and got.dtype == dtype
    assert got.is_contiguous(memory_format=cl)
    assert torch.equal(got, conv2d_act(x, w, b, r, relu, stride))
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-5 * float(want.abs().max())
        return
    tol = conv2d_act_bf16_tolerance(c, b, r, terms, cin, k)
    assert bool((diff <= tol).all()), float((diff / tol).max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_hr_fuse_kernel_matches_plain(dev, dtype):
    """K5-fuse, bit-equal to ``hr_fuse_plain`` at every target of a
    stage-4 module (W48 widths, 32^2 down to 4^2, batch 2), with the fuse
    convs through K5-conv; one launch per target."""
    module = HighResolutionModule("stage4")
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    fold_bn_(module)
    module = module.eval().to(dev, dtype, memory_format=torch.channels_last)
    chans = hrnet._branch_channels("stage4")
    xs = [torch.randn((2, c, 32 >> b, 32 >> b), generator=gen).to(
        dev, dtype).contiguous(memory_format=torch.channels_last)
        for b, c in enumerate(chans)]
    n = len(xs)
    with torch.no_grad():
        for i in range(n):
            row = module.fuse_layers[i]
            terms = [(conv_act(row[j][0], row[j][1], xs[j]), j - i)
                     if j > i else (row[j](xs[j]), 0)
                     for j in list(range(i + 1, n)) + list(range(i))]
            before = FUSE_KERNEL.launches
            got = hr_fuse(xs[i], terms)
            assert FUSE_KERNEL.launches == before + 1
            assert torch.equal(got, hr_fuse_plain(xs[i], terms))
            assert got.is_contiguous(memory_format=torch.channels_last)


def test_k5_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.randn(1, 16, 8, 8, device=dev)
    w = torch.randn(16, 16, 3, 3, device=dev)
    cl = torch.channels_last
    with pytest.raises(ValueError, match="channels_last"):
        conv2d_act(x, w.contiguous(memory_format=cl))  # x NCHW
    with pytest.raises(ValueError, match="OHWI"):
        conv2d_act(x.contiguous(memory_format=cl), w)
    with pytest.raises(ValueError):
        conv2d_act(x.contiguous(memory_format=cl),
                   torch.randn(16, 16, 5, 5, device=dev).contiguous(
                       memory_format=cl))
    with pytest.raises(ValueError, match="term"):
        hr_fuse(x.contiguous(memory_format=cl), [(x[:, :, :3], 1)])


def test_k5_kernel_backward_raises(dev):
    """On CUDA tensors a backward that K5-dgrad does not take (the data
    gradient of a conv whose input channels are not a multiple of 8, as
    the stem's images would need) raises instead of falling back to the
    plain version."""
    cl = torch.channels_last
    x = torch.randn(1, 3, 8, 8, device=dev).contiguous(
        memory_format=cl).requires_grad_()
    w = torch.randn(16, 3, 3, 3, device=dev).contiguous(memory_format=cl)
    with pytest.raises(ValueError, match="conv2d_dgrad"):
        conv2d_act(x, w, stride=2).sum().backward()


# (Cin, Cout, k, stride, input side, bias, residual, relu, batch): stride
# 1 and 2 for k 1 and 3, the stem's conv2 (64 -> 64, 3x3, stride 2), a
# subsample conv with its bias, the 48-channel 3x3 (the longest K5-wgrad
# row sums), a residual and ReLU epilogue (the mask, dresidual), and the
# head's 2048-channel 1x1; at batch 48 the 8^2 384-channel 3x3 (K5-dgrad's
# K partitions), the head's 1x1 and the 16^2 192-channel 3x3; a 256 -> 96
# stride-2 3x3 at 64^2 (four parity classes) and a stride-2 3x3 at an odd
# side (ragged classes).
CONV_BWD_CASES = [
    (64, 64, 3, 2, 32, False, False, False, 4),
    (384, 384, 3, 1, 8, False, False, False, 48),
    (192, 192, 3, 1, 16, False, False, False, 48),
    (2048, 2048, 1, 1, 8, False, False, False, 48),
    (256, 96, 3, 2, 64, False, False, False, 4),
    (64, 64, 3, 2, 15, False, False, False, 4),
    (48, 48, 3, 1, 32, False, False, False, 8),
    (48, 96, 3, 2, 16, False, False, False, 4),
    (96, 192, 3, 2, 8, True, False, False, 4),
    (256, 48, 1, 1, 16, False, False, False, 4),
    (48, 96, 1, 2, 16, False, False, False, 4),
    (64, 256, 1, 1, 16, True, True, True, 3),
    (2048, 2048, 1, 1, 8, False, False, False, 2),
]


def _conv_backward(x, w, b, r, relu, stride, dy):
    """(y, (dx, dw, db, dr)) of conv2d_act; every leaf needs a gradient."""
    leaves = [t for t in (x, w, b, r) if t is not None]
    for t in leaves:
        t.grad = None
    y = conv2d_act(x, w, b, r, relu, stride)
    y.backward(dy)
    return y, tuple(None if t is None else t.grad for t in (x, w, b, r))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", CONV_BWD_CASES, ids=lambda c: "-".join(
    str(int(v)) for v in c))
def test_conv_backward_kernels_match_plain(dev, dtype, case):
    """K5-wgrad and K5-dgrad (the VJP of ``conv2d_act`` on the card)
    against ``conv2d_backward_plain`` (cuDNN's data and weight gradients
    without TF32): f32 dx and dw within 1e-5 of the largest |value|, dbias
    within 1e-5 sum|dy|; bf16 dx within one bf16 step (at the larger of
    the exact sum and the two values: roundings that straddle a power of
    two differ by a step of the upper binade) plus 2 K 2^-24 sum|terms|
    (K = k^2 Cout: two f32 sums of the same products in other orders);
    bf16 dw and dbias within half a bf16 step plus 2 sqrt(K) 2^-24
    sum|terms| of the exact sum (K = N Ho Wo,
    ``conv2d_wgrad_bf16_tolerance``); dresidual (the masked dy) equal. One
    K5-wgrad and one K5-dgrad launch per backward, and a second backward
    bit-equal to the first (no atomics)."""
    cin, cout, k, stride, size, has_bias, has_res, relu, n = case
    if dtype == torch.float32 and n > 8:
        # The f32 route's limit, 1e-5 of the largest |value|, is for the
        # few hundred rows of phase 4's batch 2: its dw sums over the
        # 3072-12288 rows of the batch-48 cases' random cotangents differ
        # from cuDNN's by up to ~2e-5. Those cases run f32 at batch 2.
        n = 2
    gen = torch.Generator().manual_seed(cin + 3 * cout + k + stride)
    cl = torch.channels_last
    out = (size + 2 * (k // 2) - k) // stride + 1

    def put(t):
        return None if t is None else t.to(dev, dtype).contiguous(
            memory_format=cl if t.dim() == 4 else torch.contiguous_format
        ).requires_grad_()

    x = put(torch.randn((n, cin, size, size), generator=gen))
    w = put(torch.randn((cout, cin, k, k), generator=gen)
            / (cin * k * k) ** 0.5)
    b = put(torch.randn(cout, generator=gen)) if has_bias else None
    r = put(torch.randn((n, cout, out, out), generator=gen)) if has_res \
        else None
    dy = torch.randn((n, cout, out, out), generator=gen).to(
        dev, dtype).contiguous(memory_format=cl)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        c0 = dict(CONV_KERNEL.counts)
        y, got = _conv_backward(x, w, b, r, relu, stride, dy)
        counts = {f: CONV_KERNEL.counts[f] - c0[f] for f in c0}
        _, again = _conv_backward(x, w, b, r, relu, stride, dy)
        want = conv2d_backward_plain(
            dy, x.detach(), w.detach(), y.detach() if relu else None,
            stride, True, True, has_bias, has_res)
        g = (torch.where(y > 0, dy, 0) if relu else dy).float()
        exact = conv2d_backward_plain(
            g.double(), x.detach().double(), w.detach().double(), None,
            stride, True, True, has_bias, False)
        terms = conv2d_backward_plain(
            g.abs(), x.detach().abs().float(), w.detach().abs().float(),
            None, stride, True, True, has_bias, False)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert counts == {"conv2d_act_forward": 1, "conv2d_dgrad": 1,
                      "conv2d_wgrad": 1, "conv2d_relu_mask": 0,
                      "conv2d_stem_forward": 0, "conv2d_stem_wgrad": 0}
    for a, b_ in zip(got, again):
        assert a is None or torch.equal(a, b_)
    assert got[0].is_contiguous(memory_format=cl)
    if has_res:
        assert torch.equal(got[3], want[3])
    sum_dy = float(g.abs().sum())
    if dtype == torch.float32:
        for i in (0, 1):
            err = float((got[i] - want[i]).abs().max())
            assert err <= 1e-5 * float(want[i].abs().max()), (i, err)
        if has_bias:
            assert float((got[2] - want[2]).abs().max()) <= 1e-5 * sum_dy
        return
    a, b_ = got[0].float(), want[0].float()
    mag = torch.maximum(exact[0].float().abs(),
                        torch.maximum(a.abs(), b_.abs()))
    tol = conv2d_act_bf16_tolerance(mag, None, None, terms[0], k * k * cout,
                                    1)
    diff = (a - b_).abs()
    assert bool((diff <= tol).all()), float((diff / tol).max())
    for i in (1, 2):
        if got[i] is None:
            continue
        tol = conv2d_wgrad_bf16_tolerance(got[i], terms[i],
                                          n * out * out).double()
        diff = (got[i].double() - exact[i]).abs()
        assert bool((diff <= tol).all()), (i, float((diff / tol).max()))


def test_conv_backward_stem_and_expanded_cotangent(dev):
    """The stem's first conv (Cin 3, stride 2; the images take no
    gradient): no K5-dgrad launch, K5-wgrad on its scalar path; and a
    head conv under the mean pool, whose cotangent is expanded (stride
    0): made channels_last before the kernels read it. bf16: the stem's
    dw within ``conv2d_wgrad_bf16_tolerance`` of the exact sum, the head
    conv's gradients within 1e-2 relative L2 of the plain versions."""
    cl = torch.channels_last
    gen = torch.Generator().manual_seed(21)
    x = torch.randn((4, 3, 64, 64), generator=gen).to(dev, torch.bfloat16
                                                       ).contiguous(
        memory_format=cl)
    w = (torch.randn((64, 3, 3, 3), generator=gen) * 0.2).to(
        dev, torch.bfloat16).contiguous(memory_format=cl).requires_grad_()
    dy = torch.randn((4, 64, 32, 32), generator=gen).to(
        dev, torch.bfloat16).contiguous(memory_format=cl)
    c0 = dict(CONV_KERNEL.counts)
    conv2d_act(x, w, stride=2).backward(dy)
    assert CONV_KERNEL.counts["conv2d_dgrad"] == c0["conv2d_dgrad"]
    assert CONV_KERNEL.counts["conv2d_wgrad"] == c0["conv2d_wgrad"] + 1
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        _, exact, _, _ = conv2d_backward_plain(
            dy.double(), x.double(), w.detach().double(), None, 2, False,
            True, False, False)
        _, terms, _, _ = conv2d_backward_plain(
            dy.abs().float(), x.abs().float(), w.detach().float(), None, 2,
            False, True, False, False)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    tol = conv2d_wgrad_bf16_tolerance(w.grad, terms, 4 * 32 * 32).double()
    assert bool(((w.grad.double() - exact).abs() <= tol).all())

    xh = torch.randn((2, 512, 8, 8), generator=gen).to(
        dev, torch.bfloat16).contiguous(memory_format=cl).requires_grad_()
    wh = (torch.randn((2048, 512, 1, 1), generator=gen) * 0.05).to(
        dev, torch.bfloat16).contiguous(memory_format=cl).requires_grad_()
    gh = torch.randn((2, 2048), generator=gen).to(dev, torch.bfloat16)
    (conv2d_act(xh, wh).mean(dim=(2, 3)) * gh).sum().backward()
    dy = (gh[:, :, None, None] / 64).expand(2, 2048, 8, 8)
    want = conv2d_backward_plain(dy.contiguous(), xh.detach(), wh.detach(),
                                 None, 1, True, True, False, False)
    for got, ref in ((xh.grad, want[0]), (wh.grad, want[1])):
        assert bool(torch.isfinite(got).all())
        rel = float((got.float() - ref.float()).norm() / ref.float().norm())
        assert rel <= 1e-2, rel


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_backward_frozen_weight_masks_without_wgrad(dev, dtype):
    """A ReLU epilogue whose weight takes no gradient: the mask kernel
    alone (no K5-wgrad launch) gives the masked dy, bit-equal to
    ``relu_mask_plain`` as dresidual, and K5-dgrad reads it."""
    cl = torch.channels_last
    gen = torch.Generator().manual_seed(22)
    x = torch.randn((2, 48, 16, 16), generator=gen).to(dev, dtype).contiguous(
        memory_format=cl).requires_grad_()
    w = (torch.randn((64, 48, 3, 3), generator=gen) * 0.1).to(
        dev, dtype).contiguous(memory_format=cl)
    r = torch.randn((2, 64, 16, 16), generator=gen).to(dev, dtype).contiguous(
        memory_format=cl).requires_grad_()
    dy = torch.randn((2, 64, 16, 16), generator=gen).to(dev, dtype)
    c0 = dict(CONV_KERNEL.counts)
    y = conv2d_act(x, w, None, r, True)
    y.backward(dy)
    counts = {f: CONV_KERNEL.counts[f] - c0[f] for f in c0}
    assert counts == {"conv2d_act_forward": 1, "conv2d_dgrad": 1,
                      "conv2d_wgrad": 0, "conv2d_relu_mask": 1,
                      "conv2d_stem_forward": 0, "conv2d_stem_wgrad": 0}
    g = relu_mask_plain(dy, y.detach())
    assert torch.equal(r.grad, g)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = conv2d_input_plain(x.shape, w.float(), g.float(), 1)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert float((x.grad.float() - want).abs().max()) <= tol * float(
        want.abs().max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_hr_fuse_backward_kernel_matches_plain(dev, dtype):
    """K5-fuse's backward at every target of a stage-4 module (W48 widths,
    32^2 down to 4^2, batch 2; shifts 1-3 and 0): dx and each term's
    gradient bit-equal to ``hr_fuse_backward_plain`` in f32 and within one
    bf16 step in bf16; one launch per target; two calls bit-equal."""
    gen = torch.Generator().manual_seed(8)
    cl = torch.channels_last
    chans = hrnet._branch_channels("stage4")
    n = len(chans)
    xs = [torch.randn((2, c, 32 >> b, 32 >> b), generator=gen)
          for b, c in enumerate(chans)]
    for i in range(n):
        order = list(range(i + 1, n)) + list(range(i))
        x = xs[i].to(dev, dtype).contiguous(memory_format=cl)
        terms = [(torch.randn((2, chans[i], (32 >> i) >> (j - i if j > i
                                                           else 0),
                               (32 >> i) >> (j - i if j > i else 0)),
                              generator=gen).to(dev, dtype).contiguous(
            memory_format=cl).requires_grad_(), j - i if j > i else 0)
            for j in order]
        x.requires_grad_()
        dy = torch.randn(x.shape, generator=gen).to(dev, dtype).contiguous(
            memory_format=cl)
        before = FUSE_KERNEL.counts["hr_fuse_backward"]
        y = hr_fuse(x, terms)
        got = torch.autograd.grad(y, [x] + [t for t, _ in terms], dy)
        assert FUSE_KERNEL.counts["hr_fuse_backward"] == before + 1
        again = torch.autograd.grad(hr_fuse(x, terms),
                                    [x] + [t for t, _ in terms], dy)
        dx, grads = hr_fuse_backward_plain(dy, y.detach(),
                                           [s for _, s in terms])
        for a, b_, want in zip(got, again, [dx] + grads):
            assert torch.equal(a, b_)
            assert a.shape == want.shape
            if dtype == torch.float32:
                assert torch.equal(a, want)
            else:
                step = layers.bf16_step(want.float().abs())
                assert bool(((a.float() - want.float()).abs() <= step).all())


def _w48_fuse_targets(crop: int):
    """(channels, side, shifts) of the 26 fusion targets of a W48 forward
    (stage 2's module, stage 3's four, stage 4's three)."""
    out = []
    for stage in ("stage2", "stage3", "stage4"):
        modules, n = hrnet.W48_STAGES[stage][:2]
        chans = hrnet._branch_channels(stage)
        for _ in range(modules):
            for i in range(n):
                shifts = [j - i for j in range(i + 1, n)] + [0] * i
                out.append((chans[i], (crop // 4) >> i, shifts))
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_hr_fuse_backward_kernel_at_every_w48_target(dev, dtype):
    """K5-fuse's backward at each of a W48 train step's 26 (shape, shifts)
    at 256^2 crops, batch 2: f32 bit-equal to ``hr_fuse_backward_plain``
    (the same tree of f32 adds), bf16 within one bf16 step (the same sums,
    rounded once); two calls bit-equal; each shift-0 gradient equal to
    dx."""
    gen = torch.Generator().manual_seed(9)
    cl = torch.channels_last
    targets = _w48_fuse_targets(256)
    assert len(targets) == 26
    for C, side, shifts in targets:
        dy, y = (torch.randn((2, C, side, side), generator=gen).to(dev, dtype)
                 .contiguous(memory_format=cl) for _ in range(2))
        before = FUSE_KERNEL.counts["hr_fuse_backward"]
        dx, grads = _hr_fuse_backward_cuda(dy, y, shifts)
        assert FUSE_KERNEL.counts["hr_fuse_backward"] == before + 1
        dx2, grads2 = _hr_fuse_backward_cuda(dy, y, shifts)
        want_dx, want = hr_fuse_backward_plain(dy, y, shifts)
        for a, b_, w in zip([dx] + grads, [dx2] + grads2, [want_dx] + want):
            assert torch.equal(a, b_)
            assert a.shape == w.shape
            if dtype == torch.float32:
                assert torch.equal(a, w), (C, side, shifts)
            else:
                step = layers.bf16_step(w.float().abs())
                assert bool(((a.float() - w.float()).abs() <= step).all())
        for g, s in zip(grads, shifts):
            if s == 0:
                assert torch.equal(g, dx)


def test_backbone_cuda_train_never_reaches_cudnn_or_plain(dev, monkeypatch):
    """A train step of the bf16 backbone on CUDA tensors (BN unfolded, f32
    master weights) runs K5 only: ``F.conv2d``, ``nn.Upsample`` and the
    plain versions, forward or backward, are never called; one forward
    and backward make 331 K5-conv, 330 K5-dgrad (the stem's first conv
    has none), 331 K5-wgrad, 26 K5-fuse and 26 K5-fuse backward launches;
    every conv weight gets a finite gradient."""
    net = HRNet().train().to(dev, memory_format=torch.channels_last)

    def refuse(*args, **kwargs):
        raise AssertionError("cuDNN or a plain version reached")

    for mod, name in ((torch.nn.functional, "conv2d"),
                      (torch.nn.Upsample, "forward"),
                      (layers, "conv2d_act_plain"),
                      (layers, "conv2d_backward_plain"),
                      (hrnet, "hr_fuse_plain"),
                      (hrnet, "hr_fuse_backward_plain")):
        monkeypatch.setattr(mod, name, refuse)
    x = torch.randn(2, 3, 64, 64, device=dev).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    c0, f0 = dict(CONV_KERNEL.counts), dict(FUSE_KERNEL.counts)
    feat = net(x)
    feat.float().square().sum().backward()
    conv = {k: CONV_KERNEL.counts[k] - c0[k] for k in c0}
    fuse = {k: FUSE_KERNEL.counts[k] - f0[k] for k in f0}
    assert conv == {"conv2d_act_forward": 331, "conv2d_dgrad": 330,
                    "conv2d_wgrad": 331, "conv2d_relu_mask": 0,
                    "conv2d_stem_forward": 0, "conv2d_stem_wgrad": 0}
    assert fuse == {"hr_fuse_forward": 26, "hr_fuse_backward": 26}
    convs = [m for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 331
    assert all(m.weight.grad is not None and bool(
        torch.isfinite(m.weight.grad).all()) for m in convs)


def test_backbone_cuda_eval_never_reaches_cudnn_or_plain(dev, monkeypatch):
    """The eval backbone on CUDA tensors (BN folded, bf16) runs K5-conv
    and K5-fuse only: ``F.conv2d``, ``nn.Upsample`` and the plain versions
    are never called, and one forward makes 331 K5-conv and 26 K5-fuse
    launches; its features are finite."""
    net = HRNet()
    fold_bn_(net)
    net = net.eval().to(dev, torch.bfloat16, memory_format=torch.channels_last)

    def refuse(*args, **kwargs):
        raise AssertionError("cuDNN or a plain version reached")

    monkeypatch.setattr(torch.nn.functional, "conv2d", refuse)
    monkeypatch.setattr(torch.nn.Upsample, "forward", refuse)
    monkeypatch.setattr(layers, "conv2d_act_plain", refuse)
    monkeypatch.setattr(hrnet, "hr_fuse_plain", refuse)
    x = torch.randn(2, 3, 64, 64, device=dev).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    conv0, fuse0 = CONV_KERNEL.launches, FUSE_KERNEL.launches
    with torch.inference_mode():
        feat = net(x)
    assert CONV_KERNEL.launches - conv0 == 331
    assert FUSE_KERNEL.launches - fuse0 == 26
    assert feat.shape == (2, 2048) and bool(torch.isfinite(feat).all())


# -- K10 and K11: the ResNet's stem and max pool ------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("epilogue", ["bias-relu", "bare"])
@pytest.mark.parametrize("side", [61, 301])
def test_stem7_kernel_matches_plain(dev, dtype, epilogue, side):
    """K10's forward (the 7x7 / stride-2 / pad-3 conv on 3 channels; eval:
    the folded BN's bias and the ReLU, training: the bare conv) against
    ``conv2d_act_plain`` at odd sides (151 output columns: bf16's
    ``stem7_kernel`` takes a row in two runs, the second ragged), batch 3:
    bf16 within ``conv2d_act_bf16_tolerance`` (K5's limit), f32 within
    1e-5 of the largest |y|; one ``conv2d_stem_forward`` launch, no
    K5-conv."""
    full = epilogue == "bias-relu"
    gen = torch.Generator().manual_seed(31)
    cl = torch.channels_last
    x = torch.randn((3, 3, side, side), generator=gen).to(dev, dtype
                                                          ).contiguous(
        memory_format=cl)
    w = (torch.randn((64, 3, 7, 7), generator=gen) / 147 ** 0.5).to(
        dev, dtype).contiguous(memory_format=cl)
    b = (torch.randn(64, generator=gen) * 0.3).to(dev, dtype) if full else None
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        c0 = dict(CONV_KERNEL.counts)
        got = conv2d_act(x, w, b, None, full, 2)
        assert CONV_KERNEL.counts["conv2d_stem_forward"] == (
            c0["conv2d_stem_forward"] + 1)
        assert CONV_KERNEL.counts["conv2d_act_forward"] == (
            c0["conv2d_act_forward"])
        want = conv2d_act_plain(x, w, b, None, full, 2)
        c = torch.nn.functional.conv2d(x, w, None, 2, 3).float()
        terms = torch.nn.functional.conv2d(x.abs().float(), w.abs().float(),
                                           None, 2, 3)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    out = (side - 1) // 2 + 1
    assert got.shape == (3, 64, out, out)
    assert got.is_contiguous(memory_format=cl)
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-5 * float(want.abs().max())
        return
    tol = conv2d_act_bf16_tolerance(c, b, None, terms, 3, 7)
    assert bool((diff <= tol).all()), float((diff / tol).max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("epilogue", ["bias-relu", "bare"])
@pytest.mark.parametrize("n,side", [(4, 64), (3, 300)],
                         ids=["wo32", "wo150"])
def test_stem7_wgrad_kernel_matches_exact_sum(dev, dtype, epilogue, n, side):
    """K10's weight gradient (with dbias and the ReLU mask, as a train
    step with the BN folded would take it; training's bare conv, no bias
    and no mask, too), at 32 output columns (a run shorter than 128) and
    at 150 (a row in two runs, the second ragged; an input row of 900
    elements, not on a 16-byte boundary), batch 4 and 3: bf16
    (``stem7_wgrad_kernel``) within ``conv2d_wgrad_bf16_tolerance`` of the
    exact (f64) sum, f32 within 1e-5 of the largest |dw| (dbias 1e-5 of
    sum |dy|); two calls bit-equal; one ``conv2d_stem_wgrad`` launch and
    no data gradient (the images take none)."""
    full = epilogue == "bias-relu"
    gen = torch.Generator().manual_seed(32)
    cl = torch.channels_last
    out = (side - 1) // 2 + 1
    x = torch.randn((n, 3, side, side), generator=gen).to(
        dev, dtype).contiguous(memory_format=cl)
    w0 = (torch.randn((64, 3, 7, 7), generator=gen) / 147 ** 0.5).to(
        dev, dtype).contiguous(memory_format=cl)
    b0 = (torch.randn(64, generator=gen) * 0.3).to(dev, dtype)
    dy = torch.randn((n, 64, out, out), generator=gen).to(
        dev, dtype).contiguous(memory_format=cl)

    def run():
        w, b = w0.clone().requires_grad_(), b0.clone().requires_grad_()
        c0 = dict(CONV_KERNEL.counts)
        y = conv2d_act(x, w, b if full else None, None, full, 2)
        y.backward(dy)
        counts = {k: CONV_KERNEL.counts[k] - c0[k] for k in c0}
        return y.detach(), w.grad, b.grad, counts

    y, dw, db, counts = run()
    _, dw2, db2, _ = run()
    assert counts == {"conv2d_act_forward": 0, "conv2d_dgrad": 0,
                      "conv2d_wgrad": 0, "conv2d_relu_mask": 0,
                      "conv2d_stem_forward": 1, "conv2d_stem_wgrad": 1}
    assert torch.equal(dw, dw2)
    assert (db is None) == (not full)
    g = torch.where(y > 0, dy, 0) if full else dy
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        _, exact, exact_b, _ = conv2d_backward_plain(
            g.double(), x.double(), w0.double(), None, 2, False, True, True,
            False)
        _, terms, terms_b, _ = conv2d_backward_plain(
            g.abs().float(), x.abs().float(), w0.float(), None, 2, False,
            True, True, False)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    pairs = [(dw, exact, terms)]
    if full:
        assert torch.equal(db, db2)
        pairs.append((db, exact_b, terms_b))
    if dtype == torch.float32:
        assert float((dw.double() - exact).abs().max()) <= 1e-5 * float(
            exact.abs().max())
        if full:
            assert float((db.double() - exact_b).abs().max()) <= 1e-5 * (
                float(g.abs().sum()))
        return
    rows = n * out * out
    for got, want, t in pairs:
        tol = conv2d_wgrad_bf16_tolerance(got, t, rows).double()
        assert bool(((got.double() - want).abs() <= tol).all())


def _pool_input(shape, dtype, dev, gen):
    """Small integers after a ReLU: most windows tie, a corner all zero."""
    x = torch.randint(-2, 3, shape, generator=gen).float().clamp_min(0)
    x[0, :, :6, :6] = 0.0
    return x.to(dev, dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("side", [(32, 32), (33, 17)])
def test_max_pool_kernel_matches_plain(dev, dtype, side):
    """K11 forward and backward against ``max_pool2d_plain`` /
    ``max_pool2d_backward_plain`` on tied and all-zero windows, even and
    odd sides: the forward bit-equal; the backward bit-equal in f32 (the
    same first maxima, the same sums in the same order) and within one
    bf16 step in bf16 (one rounding of the same f32 sum); one launch each;
    and the gradient equals ``F.max_pool2d``'s autograd on the card."""
    gen = torch.Generator().manual_seed(33)
    x = _pool_input((2, 64, *side), dtype, dev, gen)
    Ho, Wo = (side[0] - 1) // 2 + 1, (side[1] - 1) // 2 + 1
    dy = torch.randn((2, 64, Ho, Wo), generator=gen).to(dev, dtype).contiguous(
        memory_format=torch.channels_last)
    c0 = dict(POOL_KERNEL.counts)
    xr = x.clone().requires_grad_()
    y = max_pool2d(xr)
    y.backward(dy)
    assert {k: POOL_KERNEL.counts[k] - c0[k] for k in c0} == {
        "max_pool_forward": 1, "max_pool_backward": 1}
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, max_pool2d_plain(x))
    want = max_pool2d_backward_plain(dy, x)
    if dtype == torch.float32:
        assert torch.equal(xr.grad, want)
        xf = x.clone().requires_grad_()
        torch.nn.functional.max_pool2d(xf, 3, 2, 1).backward(dy)
        assert torch.equal(xr.grad, xf.grad)
    else:
        step = layers.bf16_step(want.float().abs())
        assert bool(((xr.grad.float() - want.float()).abs() <= step).all())


def test_max_pool_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x = torch.zeros((1, 12, 8, 8), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        max_pool2d(x.contiguous(memory_format=torch.channels_last))
    with pytest.raises(ValueError, match="channels_last"):
        max_pool2d(torch.zeros((1, 16, 8, 8), device=dev))


@pytest.mark.parametrize("dtype,shape", [
    (torch.bfloat16, (48, 64, 128, 128)),  # the train shape
    (torch.float32, (4, 64, 128, 128)),    # two 32-channel slices
    (torch.bfloat16, (2, 64, 33, 17)),     # odd sides
    (torch.bfloat16, (2, 64, 35, 35)),     # Ho 18: ragged, halo at the edge
    (torch.bfloat16, (2, 128, 37, 21)),    # Ho 19, two 64-channel slices
    (torch.bfloat16, (3, 8, 21, 19)),      # 8-channel rows
    (torch.float32, (3, 4, 19, 21)),       # 4-channel rows
    (torch.bfloat16, (1, 8, 1, 1)),
    (torch.bfloat16, (2, 8, 2, 3)),
    (torch.float32, (2, 16, 17, 33))])
def test_max_pool_backward_one_launch_bit_equal(dev, dtype, shape):
    """K11's backward, one launch on the tiles of
    ``max_pool_backward_plan`` (8 x 8 windows; at Ho 18 and 19 the last
    tile row is ragged and its halo windows fall on the image's last
    rows and columns; several channel slices): bit-equal to
    ``max_pool2d_backward_plain`` in bf16 and f32 on tied and all-zero
    windows (small integers after a ReLU, planted zero blocks and a tie
    across two windows' overlap), two calls bit-equal."""
    gen = torch.Generator().manual_seed(34)
    n, c, h, w = shape
    x = torch.randint(-2, 3, shape, generator=gen).float().clamp_min(0)
    x[0, :, :8, :8] = 0.0
    if h > 5 and w > 7:
        x[-1, :, 4, 3:8] = 1.5
        x[-1, :, 3:6, 5] = 1.5
    x = x.to(dev, dtype).contiguous(memory_format=torch.channels_last)
    dy = torch.randn((n, c, (h - 1) // 2 + 1, (w - 1) // 2 + 1),
                     generator=gen).to(dev, dtype).contiguous(
        memory_format=torch.channels_last)
    n0 = POOL_KERNEL.counts["max_pool_backward"]
    got = layers._max_pool2d_backward_cuda(dy, x)
    again = layers._max_pool2d_backward_cuda(dy, x)
    assert POOL_KERNEL.counts["max_pool_backward"] - n0 == 2
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, max_pool2d_backward_plain(dy, x))
    assert torch.equal(got, again)


@pytest.mark.parametrize("epilogue", ["bias-relu", "bare"])
@pytest.mark.parametrize("n,side", [(2, 256), (3, 200), (2, 224), (1, 64),
                                    (3, 61), (2, 301)])
def test_stem7_kernel_bit_stable(dev, epilogue, n, side):
    """K10's forward in bf16 at the staged sides (6 W % 16 == 0; 200 and
    224: 100 and 112 output columns, the row's last group of 32 ragged) and
    the direct ones (61, 301): within K5's bf16 limit of
    ``conv2d_act_plain``, two calls bit-equal, each image alone bit-equal
    to itself in the batch; the regime as ``stem_plan`` has it."""
    full = epilogue == "bias-relu"
    gen = torch.Generator().manual_seed(35)
    cl = torch.channels_last
    x = torch.randn((n, 3, side, side), generator=gen).to(
        dev, torch.bfloat16).contiguous(memory_format=cl)
    w = (torch.randn((64, 3, 7, 7), generator=gen) / 147 ** 0.5).to(
        dev, torch.bfloat16).contiguous(memory_format=cl)
    b = ((torch.randn(64, generator=gen) * 0.3).to(dev, torch.bfloat16)
         if full else None)
    plan = stem_plan(n, side, side, 64, 2, torch.bfloat16)
    assert plan.grid and plan.staged == (6 * side % 16 == 0)
    got = conv2d_act(x, w, b, None, full, 2)
    assert torch.equal(got, conv2d_act(x, w, b, None, full, 2))
    for i in range(n):
        alone = conv2d_act(x[i:i + 1].contiguous(memory_format=cl), w, b,
                           None, full, 2)
        assert torch.equal(alone, got[i:i + 1])
    want = conv2d_act_plain(x, w, b, None, full, 2)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        c = torch.nn.functional.conv2d(x.float(), w.float(), None, 2, 3)
        terms = torch.nn.functional.conv2d(x.abs().float(), w.abs().float(),
                                           None, 2, 3)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    tol = conv2d_act_bf16_tolerance(c, b, None, terms, 3, 7)
    assert bool(((got.float() - want.float()).abs() <= tol).all())


def test_stem7_kernel_bias_at_an_odd_offset(dev):
    """K10's forward reads the bias in bf16 pairs: a contiguous bias view
    at an odd element offset gives the same bits as an aligned copy of it
    (the wrapper copies it), in both regimes, and the CUDA context stays
    usable."""
    gen = torch.Generator().manual_seed(36)
    cl = torch.channels_last
    w = (torch.randn((64, 3, 7, 7), generator=gen) / 147 ** 0.5).to(
        dev, torch.bfloat16).contiguous(memory_format=cl)
    buf = (torch.randn(66, generator=gen) * 0.3).to(dev, torch.bfloat16)
    bias = buf[1:65]
    assert bias.is_contiguous() and bias.data_ptr() % 4
    for side in (64, 61):
        x = torch.randn((2, 3, side, side), generator=gen).to(
            dev, torch.bfloat16).contiguous(memory_format=cl)
        got = conv2d_act(x, w, bias, None, True, 2)
        want = conv2d_act(x, w, bias.clone(), None, True, 2)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("depth", [18, 50])
def test_resnet_cuda_train_never_reaches_cudnn_or_plain(dev, monkeypatch,
                                                        depth):
    """A train step of the bf16 ResNet on CUDA tensors (BN unfolded, f32
    master weights) runs the hand-written kernels only: ``F.conv2d``,
    ``F.max_pool2d`` and the plain versions are never called; one forward
    and backward make (ResNet-50 / ResNet-18) 52 / 19 K5-conv, K5-dgrad
    and K5-wgrad launches, one K10 forward and weight gradient, one K11
    forward and backward, and 53 / 20 K4 forwards and backwards."""
    net = ResNet(depth).train().to(dev, memory_format=torch.channels_last)

    def refuse(*args, **kwargs):
        raise AssertionError("a library kernel or a plain version reached")

    for mod, name in ((torch.nn.functional, "conv2d"),
                      (torch.nn.functional, "max_pool2d"),
                      (layers, "conv2d_act_plain"),
                      (layers, "conv2d_backward_plain"),
                      (layers, "max_pool2d_plain"),
                      (layers, "max_pool2d_backward_plain")):
        monkeypatch.setattr(mod, name, refuse)
    x = torch.randn(2, 3, 64, 64, device=dev).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    kernels = (CONV_KERNEL, POOL_KERNEL, BN_KERNEL)
    c0 = [dict(k.counts) for k in kernels]
    net(x)["avg_pooling"].float().square().sum().backward()
    conv, pool, bn = ({k: kern.counts[k] - c[k] for k in c}
                      for kern, c in zip(kernels, c0))
    n = {50: 52, 18: 19}[depth]
    assert conv == {"conv2d_act_forward": n, "conv2d_dgrad": n,
                    "conv2d_wgrad": n, "conv2d_relu_mask": 0,
                    "conv2d_stem_forward": 1, "conv2d_stem_wgrad": 1}
    assert pool == {"max_pool_forward": 1, "max_pool_backward": 1}
    assert bn == {"bn_forward": n + 1, "bn_backward": n + 1}
    convs = [m for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == n + 1
    assert all(m.weight.grad is not None and bool(
        torch.isfinite(m.weight.grad).all()) for m in convs)


def test_resnet_cuda_eval_never_reaches_cudnn_or_plain(dev, monkeypatch):
    """The eval ResNet-50 on CUDA tensors (BN folded, bf16): 52 K5-conv,
    one K10 and one K11 launch a forward, no ``F.conv2d``,
    ``F.max_pool2d`` or plain version; finite features."""
    net = ResNet(50)
    fold_bn_(net)
    net = net.eval().to(dev, torch.bfloat16, memory_format=torch.channels_last)

    def refuse(*args, **kwargs):
        raise AssertionError("a library kernel or a plain version reached")

    for mod, name in ((torch.nn.functional, "conv2d"),
                      (torch.nn.functional, "max_pool2d"),
                      (layers, "conv2d_act_plain"),
                      (layers, "max_pool2d_plain")):
        monkeypatch.setattr(mod, name, refuse)
    x = torch.randn(2, 3, 64, 64, device=dev).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    c0, p0 = dict(CONV_KERNEL.counts), dict(POOL_KERNEL.counts)
    with torch.inference_mode():
        feat = net(x)["avg_pooling"]
    assert {k: CONV_KERNEL.counts[k] - c0[k] for k in c0} == {
        "conv2d_act_forward": 52, "conv2d_dgrad": 0, "conv2d_wgrad": 0,
        "conv2d_relu_mask": 0, "conv2d_stem_forward": 1,
        "conv2d_stem_wgrad": 0}
    assert POOL_KERNEL.counts["max_pool_forward"] - p0["max_pool_forward"] == 1
    assert feat.shape == (2, 2048) and bool(torch.isfinite(feat).all())
