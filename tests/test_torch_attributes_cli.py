"""The attribute CLIs of the port (``cli.fit_regression``,
``cli.attributes_demo``) against the JAX package's on the same files, on
the CPU: the printed lines equal (a printed betas array's numbers within
1e-5). The models are the configs' polynomials
(``configs/s2a.yaml``, ``configs/a2s_variations/02b_ahw2s.yaml``) on the
synthetic database; the demos read a folder of betas npz files with a
genders YAML and a ratings database written as a plain pickle."""

import contextlib
import inspect
import io
import pickle
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from shapy_tpu.cli import attributes_demo as jdemo
from shapy_tpu.cli import fit_regression as jfit
from shapy_tpu.utils.config import load_config as jload_config
from shapy_tpu_torch.cli import attributes_demo as tdemo
from shapy_tpu_torch.cli import fit_regression as tfit
from shapy_tpu_torch.utils.config import load_config

REPO = Path(__file__).resolve().parents[1]
CONFIGS = {"s2a": "configs/s2a.yaml",
           "a2s": "configs/a2s_variations/02b_ahw2s.yaml"}


def _cfg(name, out, *opts):
    files = [str(REPO / CONFIGS[name])]
    opts = [f"output_dir={out}", "use_synthetic_db=True", *opts]
    cfg = load_config({}, files, opts)
    assert cfg == jload_config({}, files, opts)
    return cfg


NUMBER = re.compile(r"[-+]?\d+\.\d*(?:e[-+]?\d+)?")
ARRAY_LINE = re.compile(r"\s*\[?[-+\d.e\s]+\]?")


def _segments(lines):
    """Text lines, and each run of lines of one printed array joined."""
    out = []
    for line in lines:
        if ARRAY_LINE.fullmatch(line) and out and isinstance(out[-1], list) \
                and not out[-1][-1].rstrip().endswith("]"):
            out[-1].append(line)
        elif ARRAY_LINE.fullmatch(line) and line.lstrip().startswith("["):
            out.append([line])
        else:
            out.append(line)
    return out


def _same_print(got, want):
    """The printed lines equal, except that the numbers of a printed
    betas array (numpy's full f32 print: its padding and wrapping follow
    its values) agree within 1e-5: f32 products summed in another
    order."""
    got, want = _segments(got), _segments(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, str) or isinstance(g, str):
            assert g == w
            continue
        g, w = " ".join(g), " ".join(w)
        np.testing.assert_allclose(
            [float(v) for v in NUMBER.findall(g)],
            [float(v) for v in NUMBER.findall(w)], rtol=1e-5, atol=1e-5)


def _lines(fn, *args, **kwargs):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(*args, **kwargs)
    return rc, out.getvalue().splitlines(), err.getvalue().splitlines()


@pytest.mark.parametrize("name", ["s2a", "a2s"])
@pytest.mark.parametrize("gender", ["female", "male"])
def test_fit_regression_matches_jax(tmp_path, name, gender):
    """``--train`` (report and saved npz) then the evaluation: the same
    printed lines as the JAX CLI; the saved weights equal."""
    cfg = _cfg(name, tmp_path / "port", f"ds_gender={gender}",
               f"model_gender={gender}")
    jcfg = dict(cfg, output_dir=str(tmp_path / "jax"))
    for train in (True, False):
        rc, got, _ = _lines(tfit.main, cfg, train, device="cpu")
        jrc, want, _ = _lines(jfit.main, jcfg, train)
        assert rc == jrc == 0
        assert [ln.replace(str(tmp_path / "port"), "OUT") for ln in got] == \
            [ln.replace(str(tmp_path / "jax"), "OUT") for ln in want]
        assert len(got) >= 2
        if train:
            a = np.load(tmp_path / "port" / "last.ckpt.npz")
            b = np.load(tmp_path / "jax" / "last.ckpt.npz")
            for k in b.files:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-7)
    rc, _, err = _lines(tfit.main, dict(cfg, output_dir=str(tmp_path / "no")),
                        False, device="cpu")
    assert rc == 1 and "No checkpoint found" in err[-1]


def test_cli_devices_default_to_the_card(monkeypatch, tmp_path):
    """Both CLIs run on the card unless the CPU is asked for."""
    assert tfit.build_parser().parse_args([]).device == "cuda"
    assert tdemo.build_parser().parse_args([]).device == "cuda"
    assert inspect.signature(tfit.main).parameters["device"].default == \
        "cuda"
    assert inspect.signature(tdemo.main).parameters["device"].default == \
        "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfit.main(_cfg("s2a", tmp_path), True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdemo.main(_cfg("s2a", tmp_path))


def _demo_files(root: Path, rng):
    """Betas npz files with a genders YAML, and the female ratings
    database as a plain pickle."""
    betas_dir = root / "betas"
    betas_dir.mkdir(parents=True)
    genders = []
    for i in range(5):
        fid = f"img.{i:02d}"  # ids with dots
        np.savez(betas_dir / f"{fid}.npz",
                 betas=rng.normal(size=10).astype(np.float32))
        genders.append(f"{fid}: {('female', 'male')[i % 2]}\n")
    (root / "genders.yaml").write_text("".join(genders))
    n = 4
    db = {"ids": [f"model_{i}" for i in range(n)],
          "ratings": np.clip(rng.normal(3, 1, size=(n, 15)), 1, 5),
          "heights": rng.uniform(1.5, 1.9, n),
          "weight_gt": rng.uniform(50, 90, n).astype(np.float32),
          "bust": rng.uniform(80, 100, n), "waist": rng.uniform(60, 80, n),
          "hips": rng.uniform(85, 105, n)}
    (root / "ratings").mkdir()
    with open(root / "ratings" / "modeldata_for_a2s_female.pt", "wb") as f:
        pickle.dump(db, f)


def _reference_checkpoint(name, cfg, path):
    """The config's model fitted on the synthetic database, written in
    the reference's Lightning layout."""
    from shapy_tpu_torch.models.attributes.build import build
    from shapy_tpu_torch.models.attributes.regression_data import (
        RegressionDataset)

    model = build(cfg)
    model.fit(RegressionDataset.synthetic(
        ds_gender=cfg["ds_gender"], model_gender=cfg["model_gender"]).db)
    # the module's own state dict is the Lightning one: b2a.* / a2b.*
    torch.save({"state_dict": model.state_dict(),
                "hyper_parameters": {"cfg": cfg}}, path)
    return model


def test_attributes_demo_matches_jax(tmp_path):
    """S2A on the npz folder and A2S on the pickled ratings: the printed
    lines equal to the JAX CLI's (rendering off on both), the printed
    betas and ratings those of the loaded model; a missing checkpoint
    warns and runs the untrained polynomial on both sides."""
    _demo_files(tmp_path, np.random.default_rng(0))
    opts = [f"betas_folder={tmp_path / 'betas'}",
            f"ds_genders_path={tmp_path / 'genders.yaml'}",
            f"rating_folder={tmp_path / 'ratings'}"]
    for name in ("s2a", "a2s"):
        ckpt = tmp_path / f"{name}.ckpt"
        cfg = _cfg(name, tmp_path / "none", *opts,
                   f"checkpoint_path={ckpt}")
        model = _reference_checkpoint(name, cfg, ckpt)
        rc, got, _ = _lines(tdemo.main, cfg, str(tmp_path / "out"),
                            render=False, device="cpu")
        jrc, want, _ = _lines(jdemo.main, cfg, str(tmp_path / "jout"),
                              render=False)
        assert rc == jrc == 0 and len(got) > 4
        _same_print(got, want)
        if name == "a2s":
            from shapy_tpu_torch.models.attributes.demo_data import (
                DemoA2SData)

            db = DemoA2SData(rating_folder=str(tmp_path / "ratings")).db
            pred = model.predict(model.create_input_feature_vec(db))
            assert got[0].endswith("model_0")
            first = str(pred[0]).splitlines()
            _same_print(got[1:1 + len(first)], first)
        missing = dict(cfg, checkpoint_path=str(tmp_path / "no.ckpt"))
        rc, got, err = _lines(tdemo.main, missing, str(tmp_path / "out"),
                              render=False, device="cpu")
        _, want, _ = _lines(jdemo.main, missing, str(tmp_path / "jout"),
                            render=False)
        assert rc == 0 and "Checkpoint not found" in err[0]
        _same_print(got, want)


def test_attributes_demo_renders(tmp_path, monkeypatch):
    """A2S with rendering writes one PNG of the demo's size a model."""
    from shapy_tpu_torch.models.body import assets

    _demo_files(tmp_path, np.random.default_rng(1))
    real = assets.make_synthetic_model_data
    monkeypatch.setattr(assets, "make_synthetic_model_data",
                        lambda kind, subdivisions=4, **kw: real(
                            kind, subdivisions=1, **kw))
    cfg = _cfg("a2s", tmp_path, f"rating_folder={tmp_path / 'ratings'}")
    rc, got, _ = _lines(tdemo.main, cfg, str(tmp_path / "png"),
                        smpl_model_path=str(tmp_path / "no_models"),
                        device="cpu")
    assert rc == 0 and len(got) == 8
    for i in range(4):
        data = (tmp_path / "png" / f"model_{i}.png").read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        assert int.from_bytes(data[16:20], "big") == 512


def test_plot_ratings(tmp_path, monkeypatch):
    """One PNG a (attribute, beta) pair, as the JAX package's count; and
    without matplotlib an ImportError that names the function."""
    from shapy_tpu.models.attributes.plots import plot_ratings as jplot
    from shapy_tpu_torch.models.attributes.plots import plot_ratings

    rng = np.random.default_rng(0)
    ratings, betas = rng.uniform(1, 5, (6, 2)), rng.normal(size=(6, 3))
    n = plot_ratings(ratings, betas, "male", str(tmp_path / "port"))
    assert n == jplot(ratings, betas, "male", str(tmp_path / "jax")) == 6
    assert sorted(p.name for p in (tmp_path / "port" / "male").iterdir()) \
        == sorted(p.name for p in (tmp_path / "jax" / "male").iterdir())
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    with pytest.raises(ImportError, match="plot_ratings draws with "
                                          "matplotlib"):
        plot_ratings(ratings, betas, "male", str(tmp_path / "none"))
