"""The port's evaluation CLI end to end on the CPU against the JAX
functions composed the same way.

The port's ``cli.evaluate.main`` (full images padded by the collate,
cropped on the device by ``apply_from_full_images``) runs on synthetic
HBW and 3DPW folders with a tiny regressor (ResNet-18 at 64^2, 2 stages,
MLP (32,), synthetic SMPL-X at ``subdivisions`` 1, 64 hull directions)
whose weights come from the JAX regressor through
``load_regressor_from_jax``. The reference is the JAX package's
``build_all_data_loaders(..., return_full_imgs=True)`` -> the batch's
full images padded with its ``Crop``'s ``crop_to_image`` affines ->
``apply_from_full_images`` -> ``Evaluator.run`` (the JAX CLI itself crops
with ``cv2``, which the port does not use). HBW's GT measurements come
from each package's own measurement module (the registry entry is given
one, as ``tests/test_evaluate_cli.py`` does).

Tolerance: every metric mean and group mean rel 1e-4 (atol 1e-7): f32 on
both sides, the backbone's sums in another order (as the slice tests),
the crops' coordinates rounded in another order (~1e-4 of a pixel).
"""

import pickle
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import shapy_tpu_torch.cli.demo as demo_mod
from shapy_tpu.data import build as jbuild
from shapy_tpu.data.datasets.hbw import HBWDataset as JHBWDataset
from shapy_tpu.eval.evaluator import build_evaluator as jbuild_evaluator
from shapy_tpu.eval.loop import adapt_eval_batches as jadapt
from shapy_tpu.measure import BodyMeasurements as JBodyMeasurements
from shapy_tpu.measure import MeasurementAnchors as JAnchors
from shapy_tpu.models.body import SMPLX as JSMPLX
from shapy_tpu.models.heads import build_body_head as jbuild_body_head
from shapy_tpu_torch.cli import evaluate
from shapy_tpu_torch.data import build
from shapy_tpu_torch.data.datasets.hbw import HBWDataset
from shapy_tpu_torch.eval import evaluator as evaluator_mod
from shapy_tpu_torch.io.from_jax import load_regressor_from_jax
from shapy_tpu_torch.measure.measurements import (
    BodyMeasurements,
    MeasurementAnchors,
)
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
from shapy_tpu_torch.models.body.model import SMPLX
from shapy_tpu_torch.models.heads.regressor import build_body_head
from tests.test_torch_datasets import write_3dpw_tree, write_hbw_tree
from tests.test_torch_regressor import _perturbed_params

torch.set_num_threads(2)
CROP = 64
NETWORK = {"num_stages": 2, "predict_hands": False, "predict_face": False,
           "backbone": {"type": "resnet", "depth": 18},
           "mlp": {"layers": [32], "dropout": 0.0}}


@pytest.fixture(scope="module")
def models():
    data = make_synthetic_model_data("smplx", subdivisions=1, seed=0)
    jmodel = JSMPLX(model_data=data)
    body = SMPLX(data)
    v_t = body.v_template.numpy()
    anchors = MeasurementAnchors.synthetic(body.faces, v_t)
    janchors = JAnchors.synthetic(body.faces, v_t)
    cfg = {"network": {"type": "SMPLXRegressor", "smplx": NETWORK},
           "body_model": {"type": "smplx", "model_folder": "",
                          "smplx": {"betas": {"num": 10}}}}
    jreg = jbuild_body_head(
        cfg, body_model=jmodel,
        measurements=JBodyMeasurements(anchors=janchors,
                                       num_hull_directions=64))
    params = _perturbed_params(jreg.params, jreg.param_slices, seed=8)
    return {"data": data, "jmodel": jmodel, "body": body, "jreg": jreg,
            "params": params, "anchors": anchors, "janchors": janchors,
            "cfg": cfg}


def _port_builder(m):
    def builder(exp_cfg, checkpoint_path="", device="cuda"):
        assert checkpoint_path == ""
        body = SMPLX(m["data"])
        reg = build_body_head(exp_cfg, body_model=body, measurements=(
            BodyMeasurements(m["anchors"], body.faces,
                             num_hull_directions=64)))
        return load_regressor_from_jax(reg, m["params"]).to(device)
    return builder


@contextmanager
def _patched(registry, name, cls):
    if not registry.DATASET_REGISTRY:
        registry._populate_registry()
    orig = registry.DATASET_REGISTRY[name]
    registry.DATASET_REGISTRY[name] = cls
    try:
        yield
    finally:
        registry.DATASET_REGISTRY[name] = orig


def _hbw_with(cls, meas, faces):
    class WithMeasurements(cls):
        def __init__(self, **kwargs):
            super().__init__(measurements_module=meas,
                             body_model_faces=faces, **kwargs)
    return WithMeasurements


def run_port(m, cfg, split, monkeypatch, capsys, hbw_meas=None):
    """The port's CLI on the CPU; returns its evaluator's results and its
    printed lines."""
    results = {}
    real = evaluator_mod.build_evaluator

    def recording(*args, **kwargs):
        ev = real(*args, **kwargs)
        run = ev.run

        def run_and_keep(*a, **k):
            results.update(run(*a, **k))
            return results
        ev.run = run_and_keep
        return ev

    monkeypatch.setattr(evaluator_mod, "build_evaluator", recording)
    monkeypatch.setattr(demo_mod, "build_demo_regressor", _port_builder(m))
    body = m["body"]
    meas = hbw_meas or BodyMeasurements(m["anchors"], body.faces,
                                        num_hull_directions=64)
    capsys.readouterr()
    with _patched(build, "hbw", _hbw_with(HBWDataset, meas, body.faces)):
        rc = evaluate.main(cfg, output_folder=cfg["_out"], split=split,
                           device="cpu")
    assert rc == 0
    return results, capsys.readouterr().out.splitlines()


def run_jax(m, cfg, split):
    """The JAX functions composed as the port's CLI composes them."""
    jmodel, jreg = m["jmodel"], m["jreg"]
    params = jax.tree_util.tree_map(jnp.asarray, m["params"])
    meas = JBodyMeasurements(anchors=m["janchors"], num_hull_directions=64)
    with _patched(jbuild, "hbw", _hbw_with(JHBWDataset, meas,
                                            jmodel.faces)):
        loaders = jbuild.build_all_data_loaders(
            cfg, split=split, target_keypoint_names=jmodel.keypoint_names,
            return_full_imgs=True, enable_augment=False)
    assert loaders

    def keep_affines(collate):
        def fn(samples):
            out = collate(samples)
            out["crop_to_image_affines"] = np.stack(
                [s["crop_to_image"] for s in samples if s is not None])
            return out
        return fn

    def batches(loader):
        loader.collate_fn = keep_affines(loader.collate_fn)
        for batch in loader:
            full = batch["full_images"]
            padded = np.zeros((len(full), max(i.shape[0] for i in full),
                               max(i.shape[1] for i in full), 3), np.float32)
            for i, img in enumerate(full):
                padded[i, :img.shape[0], :img.shape[1]] = img
            out = next(jadapt([dict(batch, images=padded)]))
            out["model_batch"]["affines"] = batch["crop_to_image_affines"]
            yield out

    def model_fn(images, model_batch):
        return jreg.apply_from_full_images(
            params, jnp.asarray(images), jnp.asarray(model_batch["affines"]),
            crop_size=CROP)

    evaluator = jbuild_evaluator(cfg, keypoint_names=jmodel.keypoint_names)
    return evaluator.run(model_fn, {p: batches(l) for p, l in
                                    loaders.items()}, last_stage="stage_01")


def _compare(got, want):
    assert set(got) == set(want)
    for ds in want:
        assert set(got[ds]) == set(want[ds]), ds
        for k, v in want[ds].items():
            np.testing.assert_allclose(got[ds][k], v, rtol=1e-4, atol=1e-7,
                                       err_msg=f"{ds} {k}")


def _p2p_pickle(path, V, g, P=300):
    rows = np.repeat(np.arange(P), 3)
    cols = g.integers(0, V, size=3 * P)
    w = g.dirichlet(np.ones(3), size=P).reshape(-1)
    with open(path, "wb") as f:
        pickle.dump(scipy.sparse.csr_matrix((w, (rows, cols)), shape=(P, V)),
                    f, protocol=2)


def test_evaluate_cli_hbw_matches_jax(models, tmp_path, monkeypatch, capsys):
    g = np.random.default_rng(11)
    root = str(tmp_path / "hbw")
    write_hbw_tree(root, models["body"], g, subjects=2, images=2)
    p2p = tmp_path / "p2p.pkl"
    _p2p_pickle(p2p, models["body"].num_verts, g)
    cfg = dict(models["cfg"], _out=str(tmp_path / "out"), datasets={
        "batch_size": 2, "pose_shape_ratio": 0.0,
        "shape": {"splits": {"val": ["hbw"]},
                  "transforms": {"crop_size": CROP},
                  "hbw": {"data_folder": root}}},
        evaluation={"body": {
            "v2v_t": ["scale", "translation"],
            "p2p_t": {"input_point_regressor_path": str(p2p)}}})
    want = run_jax(models, cfg, "val")
    cache = tmp_path / "hbw" / "_meas_cache_val.npz"
    cache.unlink()  # the port measures its GT itself
    got, lines = run_port(models, cfg, "val", monkeypatch, capsys)
    assert cache.exists()
    _compare(got, want)
    shape = got["shape"]
    for k in ("v2v_t", "v2v_t_scale", "p2p_t", "height_error",
              "chest_error", "waist_error", "hips_error", "mass_error"):
        assert k in shape and np.isfinite(shape[k]), k
    assert any(k.startswith("v2v_t/female") for k in shape)
    assert lines[0] == "=== shape ===" and len(lines) == 1 + len(shape)
    by_name = dict(line.split(": ", 1) for line in lines[1:])
    assert by_name["v2v_t"] == f"{shape['v2v_t'] * 1000:.2f} mm"
    assert by_name["mass_error"] == f"{shape['mass_error']:.2f} kg"


def test_evaluate_cli_threedpw_mpjpe14_matches_jax(models, tmp_path,
                                                   monkeypatch, capsys):
    g = np.random.default_rng(12)
    root = str(tmp_path / "3dpw")
    write_3dpw_tree(root, g, n=4)
    j14 = g.uniform(size=(20, models["body"].num_verts)).astype(np.float32)
    j14 /= j14.sum(1, keepdims=True)
    np.save(tmp_path / "j14.npy", j14)
    cfg = dict(models["cfg"], _out=str(tmp_path / "out"),
               j14_regressor_path=str(tmp_path / "j14.npy"), datasets={
                   "batch_size": 2, "pose_shape_ratio": 1.0,
                   "pose": {"splits": {"test": ["threedpw"]},
                            "transforms": {"crop_size": CROP},
                            "threedpw": {"data_folder": root}}},
               evaluation={"body": {"mpjpe": {
                   "alignments": ["root", "procrustes"]}}})
    want = run_jax(models, cfg, "test")
    got, lines = run_port(models, cfg, "test", monkeypatch, capsys)
    _compare(got, want)
    for k in ("mpjpe14_root", "mpjpe14_procrustes", "mpjpe_root",
              "mpjpe_procrustes"):
        assert np.isfinite(got["pose"][k]), k
    assert "=== pose ===" in lines


def test_evaluate_cli_refusals(tmp_path, monkeypatch, capsys):
    """No datasets for the split: rc 1 before any model is built, as the
    JAX CLI; more than one device raises; the default device is the card,
    which without CUDA raises instead of falling back to the CPU."""
    assert evaluate.main({"datasets": {}}, output_folder=str(
        tmp_path / "none"), device="cpu") == 1
    assert "No evaluation datasets" in capsys.readouterr().err
    with pytest.raises(ValueError, match="one card"):
        evaluate.main({"datasets": {}}, num_devices_data=2, device="cpu")
    args = evaluate.build_parser().parse_args(["--exp-cfg", "x.yaml"])
    assert args.device == "cuda" and args.num_devices == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate.main({"datasets": {}})


NO_CV2_SCRIPT = r"""
import importlib.abc, json, sys
from pathlib import Path

BLOCKED = ("cv2", "jax", "jaxlib", "yaml", "shapy_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import numpy as np
import torch
import chip_smoke
import shapy_tpu_torch.cli.demo as demo_mod
from shapy_tpu_torch.cli import evaluate
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
from shapy_tpu_torch.models.body.model import SMPLX

root = Path(sys.argv[1])
g = np.random.default_rng(0)
for i in range(2):
    rel = Path("val") / f"s00{i}_x" / "studio"
    chip_smoke.write_ppm(root / "photos" / rel / "a.ppm",
                         g.integers(0, 256, (70 + 9 * i, 60, 3), np.uint8))
    body = np.stack([g.uniform(15, 45, 25), g.uniform(15, 55, 25),
                     np.full(25, 0.9)], -1)
    kp = root / "keypoints" / rel / "a.json"
    kp.parent.mkdir(parents=True)
    kp.write_text(json.dumps({"people": [
        {"pose_keypoints_2d": body.reshape(-1).tolist()}]}))
(root / "genders.yaml").write_text("s000: female\ns001: male\n")
data = make_synthetic_model_data("smplx", subdivisions=1, seed=0)
real = demo_mod.build_demo_regressor
demo_mod.build_demo_regressor = (
    lambda cfg, ckpt="", device="cuda": real(cfg, ckpt, device=device))
import os
os.environ["SHAPY_TPU_TEST_SUBDIV"] = "1"
cfg = {"network": {"type": "SMPLXRegressor", "smplx": {
           "num_stages": 2, "predict_hands": False, "predict_face": False,
           "backbone": {"type": "resnet", "depth": 18},
           "mlp": {"layers": [32]}}},
       "datasets": {"batch_size": 2, "pose_shape_ratio": 0.0, "shape": {
           "splits": {"val": ["hbw"]}, "transforms": {"crop_size": 32},
           "hbw": {"data_folder": str(root)}}}}
rc = evaluate.main(cfg, output_folder=str(root / "out"), device="cpu")
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert rc == 0 and not bad, (rc, bad)
print("ok")
"""


def test_evaluate_cli_needs_no_cv2_jax_or_yaml(tmp_path):
    """The CLI's path imports no ``cv2`` (the card's machine has none),
    jax, yaml or JAX-package module: a run on PPM images in a fresh
    interpreter where importing any of them raises."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo), SHAPY_TPU_SYNTHETIC_BODY="1")
    proc = subprocess.run([sys.executable, "-c", NO_CV2_SCRIPT,
                           str(tmp_path / "hbw")], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "ok"
    assert "=== shape ===" in proc.stdout
