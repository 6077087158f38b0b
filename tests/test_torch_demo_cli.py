"""The demo CLI, the reference-checkpoint import and the start-up guards
against the JAX package's (``shapy_tpu/cli/demo.py``,
``io/model_import.py``, ``cli/import_checkpoint.py``,
``utils/device.py``), at the JAX demo tests' sizes: ResNet-18, 64^2 crops,
2 stages, MLP (32,), a synthetic SMPL-X at ``subdivisions`` 1, 5 images
of 120x90 with OpenPose JSONs, batch 4.

Tolerances. The npz parameters, joints, vertices and measurements: atol
1e-5 (m, or the parameters' units) and rel 1e-4, those of
``tests/test_torch_heads.py``'s slice (``transl``'s depth is 2f / (s S),
which scales an error of the camera scale by ~10^4: rel 1e-4); the demo's
overlays are compared bit for bit with the JAX ``HDRenderer`` run on the
port's own npz (its vertices and camera), never pixels of two forwards.
The checkpoint import's forwards: the heads' tolerances.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu_torch.io.from_jax import load_regressor_from_jax

REPO = Path(__file__).resolve().parents[1]
H, W = 90, 120
IMAGES = 5


def _cfg(root):
    return {
        "body_model": {"type": "smplx", "model_folder": "",
                       "smplx": {"betas": {"num": 10}}},
        "network": {"type": "SMPLXRegressor", "smplx": {
            "num_stages": 2, "predict_hands": False, "predict_face": False,
            "backbone": {"type": "resnet", "depth": 18},
            "mlp": {"layers": [32], "dropout": 0.0}}},
        "datasets": {"crop_size": 64, "pose": {"openpose": {
            "data_folder": str(root), "img_folder": "images",
            "keyp_folder": "openpose"}}},
    }


def _write_folder(root: Path) -> None:
    """``IMAGES`` binary PPMs and their OpenPose JSONs, one person each."""
    from shapy_tpu_torch.data.synthetic import write_ppm

    rng = np.random.default_rng(0)
    (root / "images").mkdir(parents=True)
    (root / "openpose").mkdir()
    for i in range(IMAGES):
        write_ppm(str(root / "images" / f"img{i}.ppm"),
                  rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        body = np.stack([rng.uniform(0.3, 0.7, 25) * W,
                         rng.uniform(0.15, 0.85, 25) * H,
                         np.full(25, 0.9)], -1)
        (root / "openpose" / f"img{i}_keypoints.json").write_text(
            json.dumps({"people": [
                {"pose_keypoints_2d": body.reshape(-1).tolist()}]}))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo") / "samples"
    _write_folder(root)
    return root


@pytest.fixture(scope="module")
def regressors(folder):
    """The JAX regressor (its params perturbed so that predictions depend
    on the image) and a builder of the port's with the same weights."""
    from shapy_tpu.measure import BodyMeasurements as JBM
    from shapy_tpu.measure import MeasurementAnchors as JA
    from shapy_tpu.models.body import SMPLX as JSMPLX
    from shapy_tpu.models.heads import build_body_head as jbuild
    from shapy_tpu_torch.measure.measurements import (
        BodyMeasurements,
        MeasurementAnchors,
    )
    from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
    from shapy_tpu_torch.models.body.model import SMPLX
    from shapy_tpu_torch.models.heads.regressor import build_body_head
    from tests.test_torch_regressor import _perturbed_params

    cfg = _cfg(folder)
    data = make_synthetic_model_data("smplx", subdivisions=1)
    jbody = JSMPLX(model_data=data)
    v_t = np.asarray(jbody.params["v_template"])
    jreg = jbuild(cfg, body_model=jbody, measurements=JBM(
        anchors=JA.synthetic(jbody.faces, v_t), num_hull_directions=64))
    jreg.params = jax.tree_util.tree_map(
        jnp.asarray, _perturbed_params(jreg.params, jreg.param_slices,
                                       seed=4))

    def build(exp_cfg=None, checkpoint_path="", device="cpu"):
        model = SMPLX(data)
        reg = build_body_head(cfg, body_model=model,
                              measurements=BodyMeasurements(
                                  MeasurementAnchors.synthetic(
                                      model.faces, v_t), model.faces,
                                  num_hull_directions=64))
        return load_regressor_from_jax(reg, jreg.params).to(device)

    return jreg, build


def _npz(path):
    with np.load(path, allow_pickle=True) as d:
        return {k: d[k] for k in d.files}


def test_demo_matches_jax(folder, regressors, tmp_path, monkeypatch,
                          capsys):
    import shapy_tpu.cli.demo as jdemo
    import shapy_tpu_torch.cli.demo as tdemo
    from shapy_tpu.render import COLORS, HDRenderer

    jreg, build = regressors
    monkeypatch.setattr(jdemo, "build_demo_regressor",
                        lambda cfg, ckpt="": jreg)
    monkeypatch.setattr(tdemo, "build_demo_regressor", build)
    flags = dict(save_vis=True, save_params=True, save_mesh=True,
                 batch_size=4)
    assert jdemo.main(_cfg(folder), str(tmp_path / "jax"), **flags) == 0
    capsys.readouterr()
    assert tdemo.main(_cfg(folder), str(tmp_path / "port"), device="cpu",
                      **flags) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("Average inference time: ")
    assert lines[1].startswith("Throughput: ") and "(batch size 4)" in lines[1]

    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    assert len(files) == 5 * IMAGES
    assert f"img0_hd_stage_01_overlay.png" in files
    for i in range(IMAGES):
        got = _npz(tmp_path / "port" / f"img{i}.npz")
        want = _npz(tmp_path / "jax" / f"img{i}.npz")
        assert got.keys() == want.keys()
        assert str(got["fname"]) == str(want["fname"]) == f"img{i}.ppm"
        for k, v in want.items():
            if k == "fname":
                continue
            if k == "measurements":
                g, w = got[k].item(), v.item()
                assert g.keys() == w.keys()
                for m in w:
                    np.testing.assert_allclose(g[m], w[m], rtol=1e-4,
                                               atol=1e-5, err_msg=m)
                continue
            assert got[k].shape == v.shape, k
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        # The mesh file: the fitted vertices moved by the camera.
        from shapy_tpu.render.ply import load_ply

        gv, gf = load_ply(str(tmp_path / "port" / f"img{i}.ply"))
        wv, wf = load_ply(str(tmp_path / "jax" / f"img{i}.ply"))
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_allclose(gv, wv, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(
            gv, (got["vertices"] + got["transl"]).astype(np.float32))

        # The overlays: the JAX renderer on the port's own npz.
        img = cv2.imread(str(folder / "images" / f"img{i}.ppm"))
        bg = np.transpose(cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(
            np.float32) / 255.0, (2, 0, 1))[None]
        overlay = HDRenderer()(
            got["vertices"][None], jreg.model.faces,
            focal_length=np.asarray([got["focal_length_in_px"]]),
            camera_translation=got["transl"][None],
            camera_center=got["center"][None], bg_imgs=bg,
            return_with_alpha=True, body_color=COLORS["stage_01"])[0]

        def u8(chw):
            return np.clip(np.transpose(chw, (1, 2, 0)) * 255, 0,
                           255).astype(np.uint8)

        def read(name, code):
            return cv2.cvtColor(cv2.imread(
                str(tmp_path / "port" / f"img{i}_{name}.png"),
                cv2.IMREAD_UNCHANGED), code)

        np.testing.assert_array_equal(
            read("hd_stage_01_overlay", cv2.COLOR_BGRA2RGBA), u8(overlay))
        np.testing.assert_array_equal(
            read("hd_stage_01_cat", cv2.COLOR_BGR2RGB),
            u8(np.concatenate([bg[0], overlay[:3]], -1)))
        np.testing.assert_array_equal(read("hd_imgs", cv2.COLOR_BGR2RGB),
                                      u8(bg[0]))


BLOCKED_RUN = r"""
import importlib.abc, runpy, sys

BLOCKED = ("jax", "jaxlib", "yaml", "shapy_tpu", "cv2")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
sys.argv = ["demo"] + sys.argv[1:]
runpy.run_module("shapy_tpu_torch.cli.demo", run_name="__main__")
"""


def _yaml(tree, indent=0) -> str:
    """Nested dicts as block-style YAML; lists and scalars in flow style
    (JSON's spelling, which YAML reads)."""
    out = ""
    for key, value in tree.items():
        if isinstance(value, dict):
            out += " " * indent + f"{key}:\n" + _yaml(value, indent + 2)
        else:
            out += " " * indent + f"{key}: {json.dumps(value)}\n"
    return out


def _cfg_yaml(cfg, path: Path) -> None:
    """The demo config as a YAML file for ``--exp-cfg``."""
    path.write_text(_yaml(cfg))


def test_demo_runs_without_cv2_jax_yaml(folder, tmp_path):
    """``python -m shapy_tpu_torch.cli.demo --device cpu`` in a fresh
    interpreter where cv2, jax, yaml and shapy_tpu cannot be imported
    writes every file; without ``--device cpu`` it asks for the card and,
    with none, exits 3."""
    _cfg_yaml(_cfg(folder), tmp_path / "cfg.yaml")
    env = dict(os.environ, PYTHONPATH=str(REPO),
               SHAPY_TPU_SYNTHETIC_BODY="1", SHAPY_TPU_TEST_SUBDIV="1")
    argv = [sys.executable, "-c", BLOCKED_RUN, "--exp-cfg",
            str(tmp_path / "cfg.yaml"), "--output-folder",
            str(tmp_path / "out"), "--save-vis", "true", "--save-params",
            "true", "--save-mesh", "True", "--batch-size", "2"]
    proc = subprocess.run(argv + ["--device", "cpu"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Throughput:" in proc.stdout
    want = sorted(f"img{i}{s}" for i in range(IMAGES)
                  for s in (".npz", ".ply", "_hd_imgs.png",
                            "_hd_stage_01_overlay.png",
                            "_hd_stage_01_cat.png"))
    assert sorted(os.listdir(tmp_path / "out")) == want
    proc = subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 3, proc.stderr[-3000:]
    assert "CUDA is not available" in proc.stderr


def test_exit_on_device_failure(monkeypatch):
    from shapy_tpu_torch.utils import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        device.exit_on_device_failure()
    assert exc.value.code == device.DEVICE_FAILURE_EXIT_CODE == 3
    device.exit_on_device_failure("cpu")  # the CPU asked for: no exit

    def broken():
        raise RuntimeError("CUDA initialisation failed")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "init", broken)
    with pytest.raises(SystemExit) as exc:
        device.exit_on_device_failure("cuda")
    assert exc.value.code == 3
    device.raise_open_file_limit()
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    assert soft == hard


def _reference_checkpoint(path, names, seed, partial=False):
    """A reference-layout checkpoint (``{'model': state_dict}``) with
    seeded values under the given port names, as
    ``tests/test_cli.py::test_import_checkpoint_cli`` builds one: backbone
    keys with a ``num_batches_tracked`` beside each BN, the head under
    ``regressor.module.``, the mean under ``regressor.mean_param``, and
    body constants that the import skips. ``partial`` keeps every other
    backbone key and no head key."""
    rng = np.random.default_rng(seed)
    sd = {}
    for i, (k, shape) in enumerate(names.items()):
        arr = rng.normal(size=shape).astype(np.float32) * 0.1
        if k.endswith("running_var"):
            arr = np.abs(arr) + 0.5
        if k.startswith("backbone."):
            if partial and i % 2:
                continue
            sd[k] = torch.tensor(arr)
            if k.endswith("running_var"):
                sd[k[:-len("running_var")] + "num_batches_tracked"] = \
                    torch.tensor(7)
        elif k.startswith("head.") and not partial:
            sd["regressor.module." + k[len("head."):]] = torch.tensor(arr)
        elif k == "param_mean" and not partial:
            sd["regressor.mean_param"] = torch.tensor(arr.reshape(-1))
    sd["model.v_template"] = torch.zeros(3, 3)
    sd["body_measurements.faces"] = torch.zeros(2, 3)
    torch.save({"model": sd, "optimizer": {}}, path)
    return sd


def test_reference_checkpoint_matches_jax(folder, regressors, tmp_path):
    """The same reference checkpoint through the JAX package's
    ``load_reference_model_checkpoint`` and the port's: the forwards
    agree at the heads' tolerances; BN folds the imported statistics."""
    from shapy_tpu.io.model_import import (
        load_reference_model_checkpoint as jload)
    from shapy_tpu_torch.io.model_import import (
        load_reference_model_checkpoint)

    jreg, build = regressors
    reg = build()
    names = {k: tuple(v.shape) for k, v in reg.state_dict().items()
             if k.startswith(("backbone.", "head.", "param_mean"))}
    path = str(tmp_path / "ref.ckpt")
    sd = _reference_checkpoint(path, names, seed=11)
    params = jload(path, jreg.params)
    load_reference_model_checkpoint(path, reg)
    np.testing.assert_array_equal(reg.param_mean.numpy(),
                                  np.asarray(params["param_mean"]))
    for k in ("conv1.weight", "bn1.running_var", "layer1.0.conv1.weight"):
        np.testing.assert_array_equal(
            reg.state_dict()[f"backbone.{k}"].numpy(),
            sd[f"backbone.{k}"].numpy())
    reg.prepare_for_eval_()
    images = np.random.default_rng(5).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    want = jax.jit(jreg.apply)(params, jnp.asarray(images))
    with torch.inference_mode():
        got = reg.apply(torch.from_numpy(images))
    np.testing.assert_allclose(got["features"].numpy(),
                               np.asarray(want["features"]), rtol=1e-4,
                               atol=1e-4)
    last, jlast = got["stage_01"], want["stage_01"]
    np.testing.assert_allclose(last["betas"].numpy(),
                               np.asarray(jlast["betas"]), rtol=1e-4,
                               atol=1e-5)
    for key in ("vertices", "joints"):
        np.testing.assert_allclose(last[key].numpy(),
                                   np.asarray(jlast[key]), atol=1e-5)
    with pytest.raises(ValueError, match="prepare_for_eval_"):
        load_reference_model_checkpoint(path, reg)  # BN already folded


def test_partial_checkpoint_keeps_missing_keys(regressors, tmp_path):
    from shapy_tpu.io.model_import import (
        load_reference_model_checkpoint as jload)
    from shapy_tpu_torch.io.model_import import (
        load_reference_model_checkpoint)

    jreg, build = regressors
    reg = build()
    before = {k: v.clone() for k, v in reg.state_dict().items()}
    names = {k: tuple(v.shape) for k, v in before.items()
             if k.startswith(("backbone.", "head.", "param_mean"))}
    path = str(tmp_path / "partial.ckpt")
    sd = _reference_checkpoint(path, names, seed=12, partial=True)
    load_reference_model_checkpoint(path, reg)
    params = jload(path, jreg.params)
    after = reg.state_dict()
    loaded = 0
    for k, v in before.items():
        if k in sd and not k.startswith(("model.", "body_measurements.")):
            loaded += 1
            np.testing.assert_array_equal(after[k].numpy(), sd[k].numpy())
        else:
            np.testing.assert_array_equal(after[k].numpy(), v.numpy(),
                                          err_msg=k)
        if k.startswith("backbone."):  # the JAX merge keeps the same
            np.testing.assert_array_equal(
                np.asarray(params["backbone"][k[len("backbone."):]]).reshape(
                    -1), after[k].numpy().transpose(
                    (2, 3, 1, 0) if after[k].ndim == 4 else range(
                        after[k].ndim)).reshape(-1), err_msg=k)
    assert 0 < loaded < len(names)


def test_import_checkpoint_cli_round_trips(folder, regressors, tmp_path,
                                           monkeypatch, capsys):
    """A reference checkpoint in, the port's ``Checkpointer`` file out,
    with the JAX CLI's flags and ``wrote ...`` line; loaded back, it holds
    the checkpoint's weights."""
    from shapy_tpu_torch.cli import import_checkpoint
    from shapy_tpu_torch.io.checkpoint import Checkpointer

    monkeypatch.setenv("SHAPY_TPU_SYNTHETIC_BODY", "1")
    monkeypatch.setenv("SHAPY_TPU_TEST_SUBDIV", "1")
    _, build = regressors
    names = {k: tuple(v.shape) for k, v in build().state_dict().items()
             if k.startswith(("backbone.", "head.", "param_mean"))}
    ckpt = str(tmp_path / "ref.ckpt")
    sd = _reference_checkpoint(ckpt, names, seed=13)
    _cfg_yaml(_cfg(folder), tmp_path / "cfg.yaml")
    out = tmp_path / "converted"
    rc = import_checkpoint.main([
        "--torch-checkpoint", ckpt, "--exp-cfg", str(tmp_path / "cfg.yaml"),
        "--output-dir", str(out), "--device", "cpu"])
    assert rc == 0
    line = capsys.readouterr().out.strip()
    assert line.startswith(f"wrote {out / 'ckpt_00000000'} (")
    loaded = Checkpointer(save_dir=str(out)).load(use_best=True)
    state = loaded["model"]
    assert f"({len(state)} arrays)" in line
    assert not any(k.startswith(("model.", "body_measurements."))
                   for k in state)
    for k in ("backbone.conv1.weight", "head.output_layer.weight"):
        want = sd[k if k.startswith("backbone.") else
                  "regressor.module." + k[len("head."):]]
        np.testing.assert_array_equal(state[k].numpy(), want.numpy())
    np.testing.assert_array_equal(state["param_mean"].numpy().reshape(-1),
                                  sd["regressor.mean_param"].numpy())
    assert import_checkpoint.main([
        "--torch-checkpoint", str(tmp_path / "absent"), "--device",
        "cpu"]) == 1


def test_demo_entry_points_ask_for_the_card(folder, monkeypatch):
    """The demo and the conversion CLI run on the card unless the CPU is
    asked for: without CUDA their defaults raise."""
    import inspect

    from shapy_tpu_torch.cli import demo, import_checkpoint

    assert demo.build_parser().parse_args([]).device == "cuda"
    assert inspect.signature(demo.main).parameters["device"].default == \
        "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo.main(_cfg(folder))
    monkeypatch.setenv("SHAPY_TPU_SYNTHETIC_BODY", "1")
    monkeypatch.setenv("SHAPY_TPU_TEST_SUBDIV", "1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        import_checkpoint.main(["--torch-checkpoint", __file__])


def test_get_logger_matches_jax(tmp_path):
    """The same sinks, level and format as the JAX package's logger, and
    a file sink added to a configured logger."""
    import logging

    from shapy_tpu.utils.logging import get_logger as jget
    from shapy_tpu_torch.utils.logging import get_logger

    for fn, name in ((jget, "jax_side"), (get_logger, "port_side")):
        log = fn(name, level="debug")
        assert log.level == logging.DEBUG and not log.propagate
        assert [type(h) for h in log.handlers] == [logging.StreamHandler]
        path = str(tmp_path / name / "run.log")
        assert fn(name, level="warning", log_file=path) is log
        assert log.level == logging.WARNING
        assert [type(h) for h in log.handlers] == [logging.StreamHandler,
                                                   logging.FileHandler]
        fn(name, log_file=path)  # the same file: no second sink
        assert len(log.handlers) == 2
        log.warning("hello")
        for h in log.handlers:
            h.flush()
        line = open(path).read()
        assert "[rank 0] WARNING " + name + ": hello" in line
    assert (logging.getLogger("jax_side").handlers[0].formatter._fmt
            == logging.getLogger("port_side").handlers[0].formatter._fmt)
