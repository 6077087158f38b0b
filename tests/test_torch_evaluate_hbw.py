"""Parity of the port's offline HBW scorer
(``shapy_tpu_torch/cli/evaluate_hbw.py``) with the JAX package's.

On the CPU the scorer runs the plain versions of K8b (V2V), K8a (P2P) and
K1-AoS (the triangle measurements, all faces). Bodies are synthetic SMPL-X
(``subdivisions=2`` for the function, the CLI's own ``subdivisions=5``
assets for its synthetic route, the real counts for its faces-file and
model-folder routes) shaped by seeded betas; fits are the GT plus noise.

Tolerances: atol 1e-5 m on V2V, P2P and the length errors (the same f32
operations in another order); atol 1e-3 kg on the mass error (rel 1e-5 of
a mass of ~100 kg: the signed-volume sum of ~1e3 faces in another order).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from shapy_tpu.cli import evaluate_hbw as jcli
from shapy_tpu.eval.metrics import SparsePointRegressor as JPointRegressor
from shapy_tpu.measure import BodyMeasurements as JBodyMeasurements
from shapy_tpu.measure import MeasurementAnchors as JAnchors
from shapy_tpu_torch.cli import evaluate_hbw as tcli
from shapy_tpu_torch.eval.metrics import SparsePointRegressor
from shapy_tpu_torch.measure.measurements import (
    BodyMeasurements,
    MeasurementAnchors,
)
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data

torch.set_num_threads(2)
KEYS = ("v2v_t", "p2p_t", "height_error", "chest_error", "waist_error",
        "hips_error", "mass_error")


def _bodies(data, n, rng, noise=0.003):
    dirs = data["shapedirs"][:, :, :10]
    betas = rng.normal(size=(n, 10)) * 1.5
    gt = (data["v_template"][None]
          + np.einsum("bl,vkl->bvk", betas, dirs)).astype(np.float32)
    fits = gt + 0.01 * np.einsum("bl,vkl->bvk", rng.normal(size=(n, 10)),
                                 dirs).astype(np.float32)
    fits += rng.normal(size=gt.shape).astype(np.float32) * noise
    return gt, fits.astype(np.float32)


def _barycentric_regressor(faces, V, P, rng):
    """P points with K=3 barycentric weights on random faces."""
    tri = faces[rng.integers(0, len(faces), size=P)]
    w = rng.dirichlet(np.ones(3), size=P)
    rows = np.repeat(np.arange(P), 3)
    return sp.csr_matrix((w.reshape(-1), (rows, tri.reshape(-1))),
                         shape=(P, V))


@pytest.fixture(scope="module")
def smplx():
    data = make_synthetic_model_data("smplx", subdivisions=2, seed=0)
    faces = data["f"]
    anchors = MeasurementAnchors.synthetic(faces, data["v_template"])
    janchors = JAnchors.synthetic(faces, data["v_template"])
    return data, faces, anchors, janchors


def test_all_faces_measurements_equal_the_jax_forward(smplx):
    """K1's plain version on all faces == the JAX AoS forward(v[:, faces])
    that the JAX scorer calls."""
    data, faces, anchors, janchors = smplx
    gt, _ = _bodies(data, 3, np.random.default_rng(0))
    got = BodyMeasurements(anchors, faces).forward_from_vertices(
        torch.from_numpy(gt), use_face_subsets=False)["measurements"]
    want = JBodyMeasurements(anchors=janchors).forward(
        jnp.asarray(gt)[:, faces])["measurements"]
    for k in ("height", "chest", "waist", "hips"):
        np.testing.assert_allclose(got[k]["tensor"].numpy(),
                                   np.asarray(want[k]["tensor"]), atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got["mass"]["tensor"].numpy(),
                               np.asarray(want["mass"]["tensor"]), rtol=1e-5)


@pytest.mark.parametrize("with_p2p", [True, False])
def test_evaluate_submission_matches_jax(smplx, with_p2p):
    data, faces, anchors, janchors = smplx
    rng = np.random.default_rng(1)
    gt, fits = _bodies(data, 5, rng)
    labels = [f"val/s{i:03d}_x/studio/img.jpg" for i in range(5)]
    lookup = {label: gt[i] for i, label in enumerate(labels)}
    mat = _barycentric_regressor(faces, gt.shape[1], 300, rng)
    jreg = treg = None
    if with_p2p:
        jreg = JPointRegressor.from_scipy(mat)
        treg = SparsePointRegressor.from_scipy(mat, device="cpu")
    jmeas = JBodyMeasurements(anchors=janchors)
    want = jcli.evaluate_submission(
        labels, fits, lookup.__getitem__, model_type="smplx",
        point_regressor_gt=jreg, point_regressor_fit=jreg,
        measurements_gt=jmeas, measurements_fit=jmeas, gt_faces=faces,
        fit_faces=faces, batch_size=2)
    meas = BodyMeasurements(anchors, faces)
    # The faces given, or by default the measurement modules' own.
    given = dict(gt_faces=faces, fit_faces=faces) if with_p2p else {}
    got = tcli.evaluate_submission(
        labels, fits, lookup.__getitem__, model_type="smplx",
        point_regressor_gt=treg, point_regressor_fit=treg,
        measurements_gt=meas, measurements_fit=meas, batch_size=2,
        device="cpu", **given)
    keys = set(KEYS) - (set() if with_p2p else {"p2p_t"})
    assert set(got) == set(want) == keys
    for k in keys:
        tol = 1e-3 if k == "mass_error" else 1e-5
        np.testing.assert_allclose(got[k], want[k], atol=tol, err_msg=k)
    assert 0 < got["v2v_t"] < 0.05


def test_evaluate_submission_rejects_a_regressor_beyond_the_mesh(smplx):
    """A P2P regressor for a larger mesh than the fits' is refused before
    any gather (the CUDA kernel reads its indices unchecked)."""
    data, faces, _, _ = smplx
    rng = np.random.default_rng(3)
    gt, fits = _bodies(data, 2, rng)
    reg = SparsePointRegressor.from_scipy(
        _barycentric_regressor(faces, gt.shape[1], 50, rng), device="cpu")
    labels = ["val/a/img.jpg", "val/b/img.jpg"]
    with pytest.raises(ValueError, match="mesh has"):
        tcli.evaluate_submission(
            labels, fits[:, : reg.num_vertices - 1], dict(zip(labels, gt)).get,
            model_type="smpl", point_regressor_gt=reg,
            point_regressor_fit=reg, device="cpu")


def _hbw_tree(tmp_path, gt):
    labels = []
    for i, v in enumerate(gt):
        d = tmp_path / "hbw" / "smplx" / "val"
        d.mkdir(parents=True, exist_ok=True)
        np.save(d / f"{i:03d}.npy", v)
        labels.append(f"val/{i:03d}_subject/studio/img{i}.jpg")
    return labels


@pytest.mark.parametrize("model_type", ["smplx", "smpl"])
def test_main_synthetic_route_prints_what_jax_prints(tmp_path, monkeypatch,
                                                     capsys, model_type):
    """``SHAPY_TPU_SYNTHETIC_BODY=1``: the CLI builds its own subdivisions-5
    body models; SMPL fits are scored on their own topology."""
    monkeypatch.setenv("SHAPY_TPU_SYNTHETIC_BODY", "1")
    rng = np.random.default_rng(2)
    gt, fits = _bodies(make_synthetic_model_data("smplx", subdivisions=5),
                       2, rng)
    if model_type == "smpl":
        fits, _ = _bodies(make_synthetic_model_data("smpl", subdivisions=5),
                          2, rng)
    labels = _hbw_tree(tmp_path, gt)
    sub = tmp_path / "sub.npz"
    np.savez(sub, image_name=np.asarray(labels), v_shaped=fits)
    hbw = str(tmp_path / "hbw")
    assert jcli.main(str(sub), hbw, model_type) == 0
    want = capsys.readouterr().out
    assert tcli.cli(["--input-npz-file", str(sub), "--hbw-folder", hbw,
                     "--model-type", model_type, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and "chest Error" in got
    assert ("V2V Error" in got) == (model_type == "smplx")


@pytest.fixture(scope="module")
def release_tree(tmp_path_factory):
    """An HBW tree at the real mesh counts (the YAML anchors index faces up
    to ~20000): GT npy files of 2 shaped SMPL-X bodies, SMPL-X and SMPL
    submissions, a faces npz, and SMPL-X and SMPL release files (f32) in
    ``hbw/body_models``."""
    root = tmp_path_factory.mktemp("release")
    models = root / "hbw" / "body_models"
    models.mkdir(parents=True)
    rng = np.random.default_rng(4)
    subs = {}
    for model_type, subdiv, name in (("smplx", 5, "SMPLX"),
                                     ("smpl", 4, "SMPL")):
        data = make_synthetic_model_data(model_type, subdivisions=subdiv,
                                         exact_counts=True,
                                         num_shape_dirs=20)
        np.savez(models / f"{name}_NEUTRAL.npz", **{
            k: v.astype(np.float32) if v.dtype.kind == "f" else v
            for k, v in data.items()})
        gt, fits = _bodies(data, 2, rng)
        if model_type == "smplx":
            labels = _hbw_tree(root, gt)
            np.savez(root / "faces.npz", faces=data["f"])
        subs[model_type] = root / f"sub_{model_type}.npz"
        np.savez(subs[model_type], image_name=np.asarray(labels),
                 v_shaped=fits)
    return root, subs


@pytest.mark.parametrize("route,model_type", [
    ("faces", "smplx"), ("faces", "smpl"), ("folder", "smplx"),
    ("folder", "smpl")])
def test_main_release_routes_print_what_jax_prints(release_tree, monkeypatch,
                                                   capsys, route,
                                                   model_type):
    """``--faces-path`` (anchors from the repository's YAMLs, both meshes
    on the npz's faces) and the model folder (SMPL fits on the SMPL
    model's own faces)."""
    monkeypatch.delenv("SHAPY_TPU_SYNTHETIC_BODY", raising=False)
    root, subs = release_tree
    if route == "faces" and model_type == "smpl":
        # SMPL anchors on the npz's SMPL-X faces, as in the JAX CLI: the
        # SMPL-X submission is read as SMPL.
        sub = subs["smplx"]
    else:
        sub = subs[model_type]
    kw = {}
    if route == "faces":
        kw = {"faces_path": str(root / "faces.npz"),
              "body_measurement_folder": str(
                  Path(tcli.__file__).resolve().parents[2] / "assets"
                  / "measurements")}
    assert jcli.main(str(sub), str(root / "hbw"), model_type, **kw) == 0
    want = capsys.readouterr().out
    args = ["--input-npz-file", str(sub), "--hbw-folder",
            str(root / "hbw"), "--model-type", model_type, "--device", "cpu"]
    for key, value in kw.items():
        args += ["--" + key.replace("_", "-"), value]
    assert tcli.cli(args) == 0
    got = capsys.readouterr().out
    assert got == want and "chest Error" in got
    assert ("V2V Error" in got) == (model_type == "smplx")


def test_smpl_fits_on_smplx_faces_are_refused(smplx):
    """Faces that index past the fits' vertices raise before the gather
    (on the card an out-of-range gather would end the CUDA context)."""
    data, faces, anchors, _ = smplx
    gt, fits = _bodies(data, 2, np.random.default_rng(5))
    labels = ["val/a/img.jpg", "val/b/img.jpg"]
    meas = BodyMeasurements(anchors, faces)
    with pytest.raises(ValueError, match="faces index beyond"):
        tcli.evaluate_submission(
            labels, fits[:, :-10], dict(zip(labels, gt)).get,
            model_type="smpl", measurements_gt=meas, measurements_fit=meas,
            device="cpu")


def test_check_submission_format_matches_jax(tmp_path, capsys):
    cases = {
        "good": dict(image_name=np.asarray(["a", "b"]),
                     v_shaped=np.zeros((2, 10475, 3), np.float32)),
        "bad-shape": dict(image_name=np.asarray(["a"]),
                          v_shaped=np.zeros((2, 100, 3), np.float32)),
        "missing": dict(image_name=np.asarray(["a"])),
    }
    for name, arrays in cases.items():
        path = str(tmp_path / f"{name}.npz")
        np.savez(path, **arrays)
        want = jcli.check_submission_format(path)
        want_out = capsys.readouterr().out
        got = tcli.check_submission_format(path)
        assert got == want == (name == "good")
        assert capsys.readouterr().out == want_out
        assert tcli.cli(["--input-npz-file", path,
                         "--check-format-only"]) == (0 if want else 1)
        capsys.readouterr()
    corrupt = tmp_path / "corrupt.npz"
    corrupt.write_bytes(b"not a zip")
    assert not tcli.check_submission_format(str(corrupt))
