"""Parity of the port's evaluation metrics and evaluator
(``shapy_tpu_torch/eval``) with the JAX package's (``shapy_tpu/eval``).

On the CPU every wrapper runs its kernel's plain version (K8a P2P-20k,
K8b aligned point error), so these tests hold the plain versions, and the
evaluator around them, against the JAX functions on the same numpy inputs
from a seed. Point clouds are well-conditioned random clouds (distinct
singular values), where the Procrustes rotation is unique.

Tolerances: atol 1e-5 m on per-point and mean errors (f32 on both sides;
means, variances and 3x3 SVDs in another order round differently, by
~1e-7 of values of order 1); rel 1e-5 on accumulated means (f64 host sums
of the same f32 values).
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.spatial.transform import Rotation

from shapy_tpu.eval import evaluator as jev
from shapy_tpu.eval import loop as jloop
from shapy_tpu.eval import metrics as jm
from shapy_tpu_torch.eval import evaluator as tev
from shapy_tpu_torch.eval import loop as tloop
from shapy_tpu_torch.eval import metrics as tm

torch.set_num_threads(2)
ALIGNS = ("none", "root", "translation", "scale", "procrustes")
REFERENCE_CFG = {"evaluation": {"body": {
    "v2v": ("procrustes", "scale", "translation"),
    "v2v_t": ("scale", "translation"),
    "mpjpe": {"alignments": ("root", "procrustes"),
              "root_joints": ("left_hip", "right_hip")},
}}}
NAMES = ["pelvis", "left_hip", "right_hip", "spine1", "head", "neck"]


def _cloud(rng, B=3, P=50):
    scales = np.asarray([1.0, 0.6, 0.3])  # distinct singular values
    return (rng.normal(size=(B, P, 3)) * scales).astype(np.float32)


@pytest.mark.parametrize("alignment", ALIGNS)
def test_alignment_and_point_error_match_jax(alignment):
    rng = np.random.default_rng(0)
    est, gt = _cloud(rng), _cloud(rng)
    root = (0, 2)
    want = jm.PointError(alignment, root=root)(jnp.asarray(est),
                                               jnp.asarray(gt))
    got = tm.PointError(alignment, root=root)(torch.from_numpy(est),
                                              torch.from_numpy(gt))
    assert got.shape == (3, 50) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the aligned sets themselves, and the wrapper's plain version
    ja, jb = jm.build_alignment(alignment, root)(jnp.asarray(est),
                                                 jnp.asarray(gt))
    ta, tb = tm.build_alignment(alignment, root)(torch.from_numpy(est),
                                                 torch.from_numpy(gt))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5)
    np.testing.assert_allclose(
        tm.aligned_point_error_plain(torch.from_numpy(est),
                                     torch.from_numpy(gt), alignment,
                                     root).numpy(), np.asarray(want),
        atol=1e-5)
    np.testing.assert_allclose(
        tm.mpjpe(torch.from_numpy(est), torch.from_numpy(gt), alignment,
                 root).numpy(),
        np.asarray(jm.mpjpe(jnp.asarray(est), jnp.asarray(gt), alignment,
                            root)), atol=1e-5)


def test_point_error_matches_jax():
    rng = np.random.default_rng(1)
    a, b = _cloud(rng), _cloud(rng)
    np.testing.assert_allclose(
        tm.point_error(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jm.point_error(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-6)


def test_procrustes_recovers_a_similarity():
    rng = np.random.default_rng(2)
    x = _cloud(rng)
    R = Rotation.random(3, random_state=0).as_matrix()
    moved = (np.einsum("bij,bpj->bpi", R, x) * 1.7
             + np.asarray([0.3, -0.1, 2.0])).astype(np.float32)
    err = tm.PointError("procrustes")(torch.from_numpy(moved),
                                      torch.from_numpy(x))
    assert float(err.max()) < 1e-5


def test_procrustes_handles_reflection():
    """A mirrored cloud stays unrecoverable: proper rotations only, as the
    JAX package's test_procrustes_handles_reflection."""
    x = _cloud(np.random.default_rng(3), B=1)
    mirrored = x * np.asarray([-1.0, 1.0, 1.0], np.float32)
    got = tm.PointError("procrustes")(torch.from_numpy(mirrored),
                                      torch.from_numpy(x))
    want = jm.PointError("procrustes")(jnp.asarray(mirrored), jnp.asarray(x))
    assert float(got.mean()) > 1e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("case", ["500x700", "identical"])
def test_point_fscore_matches_jax(case):
    """F-score at 5, 10 and 20 mm (K9's plain version on the CPU). Each
    nearest-neighbour distance within 1e-5 m of JAX's (both pick the
    neighbour by the f32 expansion, whose near-ties may go either way, and
    recompute the distance exactly); F-score, precision and recall equal
    unless a point's two distances fall on either side of the threshold
    (possible only within 1e-5 m of it)."""
    rng = np.random.default_rng(20)
    pred = (rng.normal(size=(500, 3)) * [0.3, 0.8, 0.2]).astype(np.float32)
    if case == "identical":
        gt = pred.copy()
    else:
        gt = (pred[rng.integers(0, 500, 700)]
              + rng.normal(size=(700, 3)) * 0.01).astype(np.float32)
    pairs = []
    for a, b in ((pred, gt), (gt, pred)):
        want = np.asarray(jm._nn_dists(jnp.asarray(a), jnp.asarray(b)))
        got = tm._nn_dists(torch.from_numpy(a), torch.from_numpy(b))
        assert got.shape == (len(a),) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        pairs.append((got.numpy(), want))
    if case == "identical":
        assert all((g == 0).all() for g, _ in pairs)
    compared = 0
    for thresh in (0.005, 0.01, 0.02):
        want = jm.point_fscore(pred, gt, thresh)
        got = tm.point_fscore(torch.from_numpy(pred), torch.from_numpy(gt),
                              thresh)
        for k in ("fscore", "precision", "recall"):
            assert got[k].shape == () and got[k].dtype == torch.float32
        if any(((g < thresh) != (w < thresh)).any() for g, w in pairs):
            continue
        compared += 1
        for k in ("fscore", "precision", "recall"):
            assert float(got[k]) == float(want[k]), (thresh, k)
        if case == "identical":
            assert float(got["fscore"]) == 1.0
    assert compared == 3
    got = tm.point_fscore(pred, gt, 0.01, device="cpu")  # arrays
    assert 0.0 < float(got["fscore"]) <= 1.0


@pytest.mark.parametrize("case", ["mixed-devices", "device-differs",
                                  "arrays-ask-for-the-card"])
def test_point_fscore_moves_no_cloud(case, monkeypatch):
    """point_fscore never moves a cloud between devices behind the
    caller's back: tensors on two devices, or on another device than
    ``device``, raise; arrays go to the card unless ``device`` says
    otherwise, so without CUDA they raise instead of running on the
    CPU."""
    a = torch.zeros((4, 3))
    if case == "mixed-devices":
        with pytest.raises(ValueError, match="expected cpu"):
            tm.point_fscore(a, a.to("meta"), 0.1)
    elif case == "device-differs":
        with pytest.raises(ValueError, match="expected meta"):
            tm.point_fscore(a, a, 0.1, device="meta")
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tm.point_fscore(a.numpy(), a.numpy(), 0.1)


def test_point_fscore_empty_overlap_is_zero():
    """No point within the threshold: the denom > 0 guard gives 0."""
    a = np.zeros((4, 3), np.float32)
    b = np.ones((5, 3), np.float32)
    got = tm.point_fscore(torch.from_numpy(a), torch.from_numpy(b), 0.1)
    want = jm.point_fscore(a, b, 0.1)
    for k in ("fscore", "precision", "recall"):
        assert float(got[k]) == float(want[k]) == 0.0


def _random_regressor(rng, P, V, K):
    dense = np.zeros((P, V))
    for i in range(P):
        cols = rng.choice(V, size=K, replace=False)
        w = rng.uniform(size=K)
        dense[i, cols] = w / w.sum()
    return dense


@pytest.mark.parametrize("case", ["same", "target", "no-align"])
def test_sparse_point_regressor_matches_jax_and_scipy(case):
    """V=40, P=100, K=3; a separate target regressor on another mesh
    (V=30, K=2); align=False."""
    rng = np.random.default_rng(4)
    V, P = 40, 100
    dense = _random_regressor(rng, P, V, 3)
    align = case != "no-align"
    reg = tm.SparsePointRegressor.from_scipy(sp.csr_matrix(dense), align,
                                             device="cpu")
    jreg = jm.SparsePointRegressor.from_scipy(sp.csr_matrix(dense), align)
    verts = _cloud(rng, B=2, P=V)
    np.testing.assert_allclose(reg.regress(torch.from_numpy(verts)).numpy(),
                               np.einsum("pv,bvk->bpk", dense, verts),
                               atol=1e-5)
    tr = jtr = None
    target = verts + 0.05 * _cloud(rng, B=2, P=V) + 1.23
    if case == "target":
        tdense = _random_regressor(rng, P, 30, 2)
        tr = tm.SparsePointRegressor.from_scipy(sp.csr_matrix(tdense),
                                                device="cpu")
        jtr = jm.SparsePointRegressor.from_scipy(sp.csr_matrix(tdense))
        target = _cloud(rng, B=2, P=30)
    got = reg(torch.from_numpy(verts), torch.from_numpy(target), tr)
    want = jreg(jnp.asarray(verts), jnp.asarray(target), jtr)
    assert got.shape == (2, P)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(
        reg.plain(torch.from_numpy(verts), torch.from_numpy(target),
                  tr).numpy(), np.asarray(want), atol=1e-5)
    if case == "same":
        # translation alignment removes a constant offset
        err = reg(torch.from_numpy(verts + 1.23), torch.from_numpy(verts))
        assert float(err.max()) < 1e-5


def test_point_regressor_rejects_indices_outside_the_mesh():
    dense = _random_regressor(np.random.default_rng(5), 10, 40, 3)
    reg = tm.SparsePointRegressor.from_scipy(sp.csr_matrix(dense),
                                             device="cpu")
    small = torch.zeros((1, reg.num_vertices - 1, 3))
    with pytest.raises(ValueError, match="indexes"):
        reg(small, small)


def _batch(rng, B=3, V=60, J=6):
    """Outputs and targets for compute_batch_metrics, numpy."""
    v_shaped = _cloud(rng, B, V)
    vertices = _cloud(rng, B, V)
    joints = _cloud(rng, B, J + 2)
    meas = {k: rng.uniform(0.5, 2.0, size=B).astype(np.float32)
            for k in tev.MEASUREMENT_KEYS}
    j14 = rng.uniform(size=(14, V)).astype(np.float32)
    j14 /= j14.sum(1, keepdims=True)
    outputs = {"stage_02": {"v_shaped": v_shaped, "vertices": vertices,
                            "joints": joints, "measurements": meas}}
    gt_j = np.concatenate([joints[:, :J] + 0.02 * _cloud(rng, B, J),
                           np.ones((B, J, 1), np.float32)], -1)
    targets = {
        "gt_v_shaped": v_shaped + 0.01 * _cloud(rng, B, V) + 0.5,
        "gt_vertices": vertices + 0.01 * _cloud(rng, B, V),
        "gt_joints3d": gt_j,
        "gt_joints14": np.einsum("jv,bvn->bjn", j14, vertices)
        + 0.01 * _cloud(rng, B, 14),
        "joints14_valid": np.asarray([1.0, 0.0, 1.0], np.float32)[:B],
        **{k: (v + rng.normal(size=B) * 0.01).astype(np.float32)
           for k, v in meas.items()},
    }
    return outputs, targets, j14, _random_regressor(rng, 80, V, 3)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def _evaluators(j14, dense):
    jreg = jm.SparsePointRegressor.from_scipy(sp.csr_matrix(dense))
    treg = tm.SparsePointRegressor.from_scipy(sp.csr_matrix(dense),
                                              device="cpu")
    want = jev.build_evaluator(REFERENCE_CFG, keypoint_names=NAMES,
                               render_summaries=False, j14_regressor=j14)
    want.point_regressor = jreg
    got = tev.build_evaluator(REFERENCE_CFG, keypoint_names=NAMES,
                              device="cpu", j14_regressor=j14,
                              point_regressor=treg)
    return want, got


def test_compute_batch_metrics_matches_jax():
    rng = np.random.default_rng(6)
    outputs, targets, j14, dense = _batch(rng)
    want_ev, got_ev = _evaluators(j14, dense)
    want = want_ev.compute_batch_metrics(_tree(outputs, jnp.asarray),
                                         _tree(targets, jnp.asarray))
    got = got_ev.compute_batch_metrics(_tree(outputs, torch.from_numpy),
                                       _tree(targets, torch.from_numpy))
    keys = {"v2v_t", "v2v_t_scale", "p2p_t", "v2v", "v2v_scale",
            "v2v_procrustes", "mpjpe_root", "mpjpe_procrustes",
            "mpjpe14_root", "mpjpe14_procrustes",
            *(f"{k}_error" for k in tev.MEASUREMENT_KEYS)}
    assert set(got) == set(want) == keys
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)
    # mpjpe14 of the invalid sample is NaN on both sides
    m14 = got["mpjpe14_root"].numpy()
    assert np.isnan(m14[1]) and np.isfinite(m14[[0, 2]]).all()
    # plain=True gives the same numbers on the CPU
    plain = got_ev.compute_batch_metrics(_tree(outputs, torch.from_numpy),
                                         _tree(targets, torch.from_numpy),
                                         plain=True)
    for k in keys:
        np.testing.assert_array_equal(plain[k].numpy(), got[k].numpy())


def test_root_joint_names_resolve_like_jax():
    want, got = _evaluators(None, _random_regressor(
        np.random.default_rng(7), 4, 6, 3))
    assert got.alignments["root"].root == (1, 2)
    assert want.alignments["root"].align is not None
    assert got.mpjpe14_alignments["root"].root == (2, 3)
    assert set(got.v2v_alignments) == set(want.v2v_alignments)
    assert set(got.v2v_t_alignments) == set(want.v2v_t_alignments)


class _ScalarWriter:
    """Summary writer without figures: the JAX evaluator then logs the BMI
    histogram means as scalars."""

    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars[tag] = value

    def flush(self):
        pass


def _raw_batches(rng, n=2, B=3, V=60, J=6):
    out = []
    for _ in range(n):
        outputs, targets, j14, dense = _batch(rng, B, V, J)
        out.append({
            "images": np.zeros((B, 4, 4, 3), np.float32),
            "gt_v_shaped": targets["gt_v_shaped"],
            "gt_vertices": targets["gt_vertices"],
            "joints3d": targets["gt_joints3d"],
            "joints14": targets["gt_joints14"],
            "joints14_valid": targets["joints14_valid"],
            "height_gt": rng.uniform(1.5, 1.9, size=B).astype(np.float32),
            "mass_gt": rng.uniform(45, 120, size=B).astype(np.float32),
            **{f"{k}_gt": targets[k] for k in ("chest", "waist", "hips")},
            "gender": np.asarray([0, 1, 2][:B], np.int32),
            "genders": ["male", "female", "neutral"][:B],
            "_outputs": outputs,
        })
    return out, j14, dense


def test_adapt_eval_batches_matches_jax():
    raw, _, _ = _raw_batches(np.random.default_rng(8), n=1)
    (want,) = list(jloop.adapt_eval_batches(raw))
    (got,) = list(tloop.adapt_eval_batches(raw, device="cpu"))
    assert set(got["targets"]) == set(want["targets"])
    for k, v in want["targets"].items():
        np.testing.assert_array_equal(got["targets"][k].numpy(),
                                      np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(got["bmi_hist_groups"],
                                  want["bmi_hist_groups"])
    assert got["bmi_buckets"] == want["bmi_buckets"]
    assert got["genders"] == want["genders"]
    np.testing.assert_array_equal(got["model_batch"]["gender"].numpy(),
                                  raw[0]["gender"])


def test_evaluator_run_matches_jax():
    """Group means over genders x BMI buckets and BMI histogram means over
    two batches, each holding an invalid mpjpe14 sample."""
    raw, j14, dense = _raw_batches(np.random.default_rng(9))
    # heights and masses that hit several buckets, one without BMI
    raw[0]["height_gt"][:] = [1.80, 1.70, 1.60]
    raw[0]["mass_gt"][:] = [55.0, 80.0, 110.0]
    raw[1]["height_gt"][:] = [1.75, 0.0, 1.65]
    want_ev, got_ev = _evaluators(j14, dense)
    want_ev.summary_writer = _ScalarWriter()
    outputs = iter([b["_outputs"] for b in raw] * 2)

    want = want_ev.run(lambda images, mb: _tree(next(outputs), jnp.asarray),
                       {"hbw": jloop.adapt_eval_batches(raw)})["hbw"]
    got = got_ev.run(lambda images, mb: _tree(next(outputs),
                                              torch.from_numpy),
                     {"hbw": tloop.adapt_eval_batches(raw, "cpu")})["hbw"]
    assert set(got) == set(want)
    assert "v2v_t/male/underweight" in got
    assert "mass_error/female/unknown" in got
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    hist = got_ev.bmi_histograms["hbw"]
    for name, means in hist.items():
        for gi, gname in enumerate(tev.BMI_HIST_NAMES):
            tag = f"hbw/bmi_histogram/{name}/{gname}"
            ref = want_ev.summary_writer.scalars[tag]
            if np.isnan(means[gi]):
                assert ref == 0.0, tag  # the JAX figure's empty bar
            else:
                np.testing.assert_allclose(means[gi] * 1000.0, ref,
                                           rtol=1e-5, err_msg=tag)


def test_bmi_helpers_match_jax():
    h = np.asarray([1.80, 1.70, 1.60, 1.75, 1.65, 0.0])
    m = np.asarray([55.0, 65.0, 80.0, 100.0, 120.0, 70.0])
    np.testing.assert_array_equal(tev.bmi_hist_group(h, m),
                                  jev.bmi_hist_group(h, m))
    assert [tev.bmi_bucket(a, b) for a, b in zip(h, m)] == [
        jev.bmi_bucket(a, b) for a, b in zip(h, m)]
    acc = tev.MetricAccumulator()
    acc.update(np.asarray([1.0, np.nan, 3.0]), ["a", "a", "b"])
    assert acc.mean == pytest.approx(2.0)
    assert acc.group_means() == {"a": 1.0, "b": 3.0}
    empty = tev.MetricAccumulator()
    empty.update(np.asarray([np.nan]))
    assert np.isnan(empty.mean)


def test_build_evaluator_reads_regressor_files(tmp_path):
    """P2P regressor pickles (separate target) and a J14 .npy / .pkl from
    the config, as the JAX build_evaluator reads them."""
    rng = np.random.default_rng(10)
    outputs, targets, j14, dense = _batch(rng)
    tdense = _random_regressor(rng, 80, 60, 2)
    paths = {}
    for name, mat in (("in", dense), ("tgt", tdense)):
        paths[name] = str(tmp_path / f"{name}.pkl")
        with open(paths[name], "wb") as f:
            pickle.dump(sp.csr_matrix(mat), f)
    np.save(tmp_path / "j14.npy", j14)
    with open(tmp_path / "j14.pkl", "wb") as f:
        pickle.dump(sp.csr_matrix(j14), f)
    for j14_file in ("j14.npy", "j14.pkl"):
        cfg = {"evaluation": {"body": {"p2p_t": {
            "input_point_regressor_path": paths["in"],
            "target_point_regressor_path": paths["tgt"]}}},
            "j14_regressor_path": str(tmp_path / j14_file)}
        want = jev.build_evaluator(cfg, render_summaries=False)
        got = tev.build_evaluator(cfg, device="cpu")
        # the target regressor regresses the GT on its own rows
        assert got.target_point_regressor is not None
        w = want.compute_batch_metrics(_tree(outputs, jnp.asarray),
                                       _tree(targets, jnp.asarray))
        g = got.compute_batch_metrics(_tree(outputs, torch.from_numpy),
                                      _tree(targets, torch.from_numpy))
        assert set(g) == set(w)
        for k in ("p2p_t", "mpjpe14_root", "mpjpe14_procrustes"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       atol=1e-5, err_msg=k)
