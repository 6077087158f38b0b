"""The evaluator's summaries against the JAX package's
(``shapy_tpu/eval/evaluator.py``): ``create_image_summaries`` (extra
viewpoints from ``degrees``, GT meshes), ``_keypoint_summaries``, the
dataset means as scalars and the per-BMI-group bars, through a recording
writer on both packages; then ``Evaluator.run`` on full images (the
summary's crops from K2's plain version) and a real
``torch.utils.tensorboard.SummaryWriter`` file read back.

The summaries are host numpy on the same inputs: image arrays must be
bit-equal. The scalars are compared on measurement errors alone (|est -
gt| of the same f32 numbers, then the same f64 host sums), which both
packages compute exactly alike: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.eval import evaluator as jev
from shapy_tpu.eval import loop as jloop
from shapy_tpu.models.body import SMPLX as JSMPLX
from shapy_tpu.models.body import make_synthetic_model_data
from shapy_tpu_torch.eval import evaluator as tev
from shapy_tpu_torch.eval import loop as tloop


class Recorder:
    """A duck-typed writer keeping what it is given."""

    def __init__(self, figures=False):
        self.images, self.scalars, self.figures = {}, {}, {}
        self.flushed = 0
        if figures:
            self.add_figure = self._add_figure

    def add_image(self, tag, image, step):
        self.images[tag] = (np.array(image), step)

    def add_scalar(self, tag, value, step):
        self.scalars[tag] = (float(value), step)

    def _add_figure(self, tag, fig, step):
        # the bars as drawn: heights, tick labels and the y range
        bars = [p.get_height() for p in fig.axes[0].patches]
        labels = [t.get_text() for t in fig.axes[0].get_xticklabels()]
        self.figures[tag] = (bars, labels, fig.axes[0].get_ylim(), step)

    def flush(self):
        self.flushed += 1


@pytest.fixture(scope="module")
def body():
    model = JSMPLX(model_data=make_synthetic_model_data("smplx",
                                                        subdivisions=1))
    return model


def _outputs(body, B=3, seed=0):
    rng = np.random.default_rng(seed)
    betas = rng.normal(size=(B, 10)).astype(np.float32)
    verts = np.asarray(body(betas=jnp.asarray(betas))["vertices"])
    K = len(body.keypoint_names)
    outputs = {
        "stage_01": {
            "vertices": verts, "faces": np.asarray(body.faces),
            "proj_joints": rng.uniform(-0.8, 0.8, (B, K, 2)).astype(
                np.float32)},
        "camera_parameters": {
            "scale": rng.uniform(0.8, 1.2, (B, 1)).astype(np.float32),
            "translation": (rng.normal(size=(B, 2)) * 0.05).astype(
                np.float32),
            "scale_first": False},
    }
    targets = {
        "gt_vertices": verts + 0.01,
        "target_keypoints2d": np.concatenate(
            [rng.uniform(-0.8, 0.8, (B, K, 2)),
             rng.uniform(size=(B, K, 1)) > 0.3], -1).astype(np.float32),
    }
    return outputs, targets


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree.copy()) if isinstance(tree, np.ndarray) else tree


def _images_equal(got: Recorder, want: Recorder):
    assert sorted(got.images) == sorted(want.images)
    for tag, (arr, step) in want.images.items():
        assert got.images[tag][1] == step
        np.testing.assert_array_equal(got.images[tag][0], arr, err_msg=tag)


@pytest.mark.parametrize("scale_first,degrees,with_camera",
                         [(False, (90, 180), True), (True, (), True),
                          (False, (45,), False)])
def test_image_summaries_match_jax(body, scale_first, degrees,
                                   with_camera):
    outputs, targets = _outputs(body)
    outputs["camera_parameters"]["scale_first"] = scale_first
    if not with_camera:
        del outputs["camera_parameters"]
    imgs = np.random.default_rng(1).normal(size=(3, 48, 48, 3)).astype(
        np.float32)
    wj, wt = Recorder(), Recorder()
    ej = jev.Evaluator(summary_writer=wj, keypoint_names=body.keypoint_names,
                       degrees=degrees)
    et = tev.Evaluator(summary_writer=wt, keypoint_names=body.keypoint_names,
                       degrees=degrees, device="cpu")
    want = ej.create_image_summaries(
        imgs, _tree(outputs, jnp.asarray), "ds/Images", 3, "stage_01",
        max_images=2, targets=_tree(targets, jnp.asarray))
    got = et.create_image_summaries(
        torch.from_numpy(imgs), _tree(outputs, torch.from_numpy),
        "ds/Images", 3, "stage_01", max_images=2,
        targets=_tree(targets, torch.from_numpy))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (48, 2 * 48 * (1 + len(degrees)), 3)
    assert sorted(wt.images) == [
        "ds/Images", "ds/Images/est_keypoints", "ds/Images/gt_keypoints",
        "ds/Images/gt_mesh"]
    _images_equal(wt, wj)
    # no keypoint names: the mesh grids alone, as the JAX package
    wj2, wt2 = Recorder(), Recorder()
    jev.Evaluator(summary_writer=wj2).create_image_summaries(
        imgs, _tree(outputs, jnp.asarray), "t", 0, "stage_01")
    tev.Evaluator(summary_writer=wt2, device="cpu").create_image_summaries(
        imgs, _tree(outputs, torch.from_numpy), "t", 0, "stage_01")
    assert sorted(wt2.images) == ["t"]
    _images_equal(wt2, wj2)


def _measurement_batches(seed=2, n=2, B=4):
    """Collate batches of GT measurements with heights and masses across
    the BMI groups, and outputs of predicted measurements."""
    rng = np.random.default_rng(seed)
    raw, outs = [], []
    for i in range(n):
        h = rng.uniform(1.5, 1.95, B).astype(np.float32)
        m = rng.uniform(40, 140, B).astype(np.float32)
        if i == 1:
            h[0] = 0.0  # no BMI
        batch = {"images": rng.normal(size=(B, 8, 8, 3)).astype(np.float32),
                 "genders": ["female", "male"] * (B // 2),
                 "gender": np.tile([1, 0], B // 2).astype(np.int64),
                 "height_gt": h, "mass_gt": m}
        meas = {}
        for k in ("chest", "waist", "hips"):
            batch[f"{k}_gt"] = rng.uniform(0.7, 1.3, B).astype(np.float32)
            meas[k] = batch[f"{k}_gt"] + rng.normal(
                scale=0.03, size=B).astype(np.float32)
        meas["height"] = h + rng.normal(scale=0.02, size=B).astype(
            np.float32)
        meas["mass"] = m + rng.normal(scale=3.0, size=B).astype(np.float32)
        raw.append(batch)
        outs.append({"stage_01": {"measurements": meas},
                     "measurements": meas})
    return raw, outs


@pytest.mark.parametrize("figures", [False, True])
def test_scalars_and_bmi_histograms_match_jax(figures):
    raw, outs = _measurement_batches()
    wj, wt = Recorder(figures), Recorder(figures)
    with jev.Evaluator(summary_writer=wj, render_summaries=False) as ej:
        it = iter(outs)
        want = ej.run(lambda im, mb: _tree(next(it), jnp.asarray),
                      {"hbw": jloop.adapt_eval_batches(raw)}, step=5,
                      last_stage="stage_01")["hbw"]
    with tev.Evaluator(summary_writer=wt, render_summaries=False,
                       device="cpu") as et:
        it = iter(outs)
        got = et.run(lambda im, mb: _tree(next(it), torch.from_numpy),
                     {"hbw": tloop.adapt_eval_batches(raw, "cpu")}, step=5,
                     last_stage="stage_01")["hbw"]
    assert got == want
    assert wt.scalars == wj.scalars and wt.flushed == wj.flushed == 1
    assert {f"hbw/{k}" for k in got} <= set(wt.scalars)
    assert all(s == 5 for _, s in wt.scalars.values())
    assert not wt.images  # render_summaries off
    if figures:
        assert wt.figures == wj.figures
        bars, labels, ylim, step = wt.figures["hbw/bmi histogram mass_error"]
        assert labels == list(tev.BMI_HIST_NAMES) and ylim == (0.0, 300.0)
        assert step == 5 and max(bars) > 0
        assert not any("bmi_histogram" in t for t in wt.scalars)
    else:
        buckets = [t for t in wt.scalars if "/bmi_histogram/" in t]
        assert len(buckets) == 5 * len(tev.BMI_HIST_NAMES)


def test_run_crops_full_images_for_the_summaries(body):
    """A batch of full images with crop affines: ``run`` crops the first
    ones once (K2's plain version here) and logs the JAX summaries of
    those crops, once, for the first batch."""
    from shapy_tpu_torch.data.crop import crop_normalize_plain
    from shapy_tpu_torch.flagship import synthetic_requests

    outputs, targets = _outputs(body, B=4, seed=3)
    full, aff = synthetic_requests(4, 40, 52, 32, 7)
    batch = {"images": torch.from_numpy(full), "targets": {},
             "model_batch": {"crop_to_image_affines": torch.from_numpy(aff),
                             "crop_size": 32}}
    wt = Recorder()
    et = tev.Evaluator(summary_writer=wt, keypoint_names=body.keypoint_names,
                       device="cpu")
    calls = []

    def model_fn(images, mb):
        calls.append(images)
        return _tree(outputs, torch.from_numpy)

    et.run(model_fn, {"ds": [batch, batch]}, step=2, last_stage="stage_01")
    assert len(calls) == 2
    crops = crop_normalize_plain(torch.from_numpy(full), torch.from_numpy(aff),
                                 32).numpy()
    wj = Recorder()
    jev.Evaluator(summary_writer=wj, keypoint_names=body.keypoint_names
                  ).create_image_summaries(
        crops, _tree(outputs, jnp.asarray), "ds/Images", 2, "stage_01")
    _images_equal(wt, wj)


def test_tensorboard_event_file(tmp_path, body):
    """A real ``SummaryWriter``: its event file, read back with
    tensorboard's ``EventAccumulator``, holds the image and scalar tags."""
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )
    from torch.utils.tensorboard import SummaryWriter

    raw, outs = _measurement_batches(seed=4, n=1)
    mesh_out, targets = _outputs(body, B=4, seed=5)
    for k in ("stage_01", "camera_parameters"):
        outs[0][k] = dict(mesh_out[k], **outs[0].get(k, {}))
    with tev.Evaluator(summary_writer=SummaryWriter(str(tmp_path)),
                       keypoint_names=body.keypoint_names,
                       device="cpu") as et:
        it = iter(outs)
        results = et.run(lambda im, mb: _tree(next(it), torch.from_numpy),
                         {"hbw": tloop.adapt_eval_batches(raw, "cpu")},
                         step=3, last_stage="stage_01")["hbw"]
    acc = EventAccumulator(str(tmp_path), size_guidance={"images": 0})
    acc.Reload()
    tags = acc.Tags()
    assert {"hbw/Images", "hbw/Images/est_keypoints"} <= set(tags["images"])
    assert {f"hbw/{k}" for k in results} <= set(tags["scalars"])
    event = acc.Scalars("hbw/mass_error")[0]
    assert event.step == 3
    assert event.value == pytest.approx(results["mass_error"], rel=1e-6)
