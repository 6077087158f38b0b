"""The port's config loader (``utils/config.py`` over ``utils/yaml_subset``)
against the JAX package's (over PyYAML): the repository's configs, dot-list
overrides and the argument parser give equal dicts. Exact equality: both
build the same Python values."""

import glob
from pathlib import Path

import pytest
import yaml

from shapy_tpu.utils import config as jconfig
from shapy_tpu_torch.utils import config, yaml_subset

REPO = Path(__file__).resolve().parents[1]
CONFIGS = ("shapy_eval_shape.yaml", "shapy_demo.yaml", "train_shapy.yaml")


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_load_as_pyyaml(name):
    path = str(REPO / "configs" / name)
    with open(path) as f:
        want = yaml.safe_load(f)
    assert yaml_subset.load(path) == want
    assert config.load_config({}, [path]) == want
    assert config.load_config({}, [path]) == jconfig.load_config({}, [path])


def test_every_repository_yaml_reads_as_pyyaml():
    paths = sorted(glob.glob(str(REPO / "configs" / "**" / "*.yaml"),
                             recursive=True)
                   + glob.glob(str(REPO / "assets" / "**" / "*.yaml"),
                               recursive=True))
    assert len(paths) >= 6
    for path in paths:
        with open(path) as f:
            assert yaml_subset.load(path) == yaml.safe_load(f), path


@pytest.mark.parametrize("text", [
    "a: 1e-4\nb: 1.0e-4\nc: 14400.0\nd: .5\ne: -.inf\n",
    "a: True\nb: yes\nc: Off\nd: ~\ne:\nf: null\n",
    "a: 012\nb: 0x1F\nc: 0b101\nd: +7\ne: 1_000\nf: -0\n",
    "a: [1, [2, 3], 'x y', \"z\", []]\nb: {}\nc: ['']\n",
    "a: '' # a comment\nb: 'c # d'  # e\nc: d#e\n# whole line\n",
    "'001': female\n002: male\ns003: n\n",
    "- a: 1\n  b: [0.9, 0.999]\n- - x\n  - 'it''s'\n",
])
def test_yaml_subset_scalars_as_pyyaml(text):
    assert yaml_subset.loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: {b: 1}", "a: &x 1", "a: *x", "a: !!str 1", "a: 1:30",
    "a: 2020-01-01", "a: |\n  x", 'a: "\\n"', "a: [1, 2",
])
def test_yaml_subset_refuses_the_rest(text):
    with pytest.raises(ValueError):
        yaml_subset.loads(text)


def test_overrides_and_parser_match_jax(tmp_path):
    path = str(REPO / "configs" / "shapy_eval_shape.yaml")
    extra = tmp_path / "extra.yaml"
    extra.write_text("datasets:\n  shape:\n    hbw:\n"
                     "      data_folder: '/data/HBW'   # moved\n")
    opts = ["network.smplx.num_stages=2", "datasets.batch_size=8",
            "network.smplx.mlp.layers=[64,64]", "pretrained=none",
            "network.smplx.predict_face=false", "output_folder=out"]
    want = jconfig.load_config({"seed": 1}, [path, str(extra)], opts)
    assert config.load_config({"seed": 1}, [path, str(extra)], opts) == want
    assert config.parse_dotlist(opts) == jconfig.parse_dotlist(opts)
    base = {"a": {"b": 1, "c": [1]}, "d": 2}
    over = {"a": {"c": [2], "e": 3}}
    assert config.deep_merge(base, over) == jconfig.deep_merge(base, over)
    argv = ["--exp-cfg", path, "--exp-opts", *opts]
    got, exp = config.parse_args(argv), jconfig.parse_args(argv)
    got.pop("_args")
    exp.pop("_args")
    assert got == exp
    with pytest.raises(ValueError, match="not a config section"):
        config.parse_dotlist(["a.b=1", "a.b.c=2"])
