"""The port's datasets against the JAX package's on synthetic folders
written here (PPM images of mixed sizes, OpenPose JSONs, ``genders.yaml``,
GT meshes): every item's fields are identical (exact equality; images
decoded by the port's PPM reader against ``cv2`` on the JAX side), with
and without the eval transforms. HBW's GT measurements (K1-AoS's plain
version against the JAX ``BodyMeasurements.forward``, rel 1e-5: f32 on
both sides, the hull's sums in another order) and its
``_meas_cache_<split>.npz``, which either package reads from the other.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from shapy_tpu.data import transforms as jtransforms
from shapy_tpu.data.datasets import hbw as jhbw
from shapy_tpu.data.datasets import openpose as jopenpose_ds
from shapy_tpu.data.datasets import ssp3d as jssp3d
from shapy_tpu.data.datasets import threedpw as jthreedpw
from shapy_tpu.measure import BodyMeasurements as JBodyMeasurements
from shapy_tpu.measure import MeasurementAnchors as JAnchors
from shapy_tpu_torch.data import transforms
from shapy_tpu_torch.data.datasets import hbw, openpose, ssp3d, threedpw
from shapy_tpu_torch.measure.measurements import (
    BodyMeasurements,
    MeasurementAnchors,
)
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
from shapy_tpu_torch.models.body.model import SMPLX
from tests.test_torch_data import _equal

torch.set_num_threads(2)
SIZES = ((120, 100), (96, 130), (111, 87))


def write_ppm(path, img):
    import cv2

    os.makedirs(os.path.dirname(path), exist_ok=True)
    assert cv2.imwrite(str(path), img[..., ::-1])  # RGB on disk


def keypoints_json(path, g, H, W, people=1):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    out = []
    for _ in range(people):
        body = np.zeros((25, 3))
        body[:, 0] = g.uniform(0.15 * W, 0.85 * W, 25)
        body[:, 1] = g.uniform(0.1 * H, 0.9 * H, 25)
        body[:, 2] = g.uniform(0.3, 1.0, 25)
        out.append({"pose_keypoints_2d": body.reshape(-1).tolist()})
    with open(path, "w") as f:
        json.dump({"people": out}, f)


def write_obj(path, verts, faces):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.writelines(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n" for v in verts)
        f.writelines(f"f {t[0]} {t[1]} {t[2]}\n" for t in faces + 1)


def write_hbw_tree(root, model, g, subjects=2, images=2, sizes=SIZES,
                   multi_person=False):
    """An HBW tree under ``root`` in the JAX package's layout: subject
    ``s%03d`` with ``images`` PPMs, its OpenPose JSONs, a GT mesh of
    ``model`` from seeded betas and a gender; with ``multi_person`` one
    more image of two people (skipped by the dataset)."""
    genders = {}
    faces = model.faces
    for si in range(subjects):
        sid = f"s{si:03d}"
        genders[sid] = ("female", "male", "neutral")[si % 3]
        betas = torch.tensor(g.normal(size=(1, model.num_betas)) * 0.7,
                             dtype=torch.float32)
        with torch.no_grad():
            v = model.forward_shape(betas)["v_shaped"][0].double().numpy()
        write_obj(f"{root}/v_templates/smplx/val/{sid}.obj", v, faces)
        for ii in range(images + int(multi_person and si == 0)):
            H, W = sizes[(si * images + ii) % len(sizes)]
            img_dir = f"{root}/photos/val/{sid}_case/studio"
            kp_dir = f"{root}/keypoints/val/{sid}_case/studio"
            write_ppm(f"{img_dir}/img{ii}.ppm",
                      g.integers(0, 256, (H, W, 3), dtype=np.uint8))
            keypoints_json(f"{kp_dir}/img{ii}.json", g, H, W,
                           people=2 if ii == images else 1)
    with open(f"{root}/genders.yaml", "w") as f:
        yaml.safe_dump(genders, f)
    return genders


def write_3dpw_tree(root, g, n=3, joints=24):
    os.makedirs(f"{root}/npz_data", exist_ok=True)
    names = []
    for i in range(n):
        H, W = SIZES[i % len(SIZES)]
        names.append(f"seq0/image_{i:05d}.ppm")
        write_ppm(f"{root}/images/{names[-1]}",
                  g.integers(0, 256, (H, W, 3), dtype=np.uint8))
    np.savez(f"{root}/npz_data/test.npz",
             imgname=np.asarray(names),
             center=np.asarray([[W / 2 + 4, H / 2 - 3] for H, W in
                                (SIZES[i % 3] for i in range(n))],
                               np.float32),
             scale=g.uniform(0.35, 0.55, n).astype(np.float32),
             pose=(g.normal(size=(n, 72)) * 0.1).astype(np.float32),
             shape=(g.normal(size=(n, 10)) * 0.5).astype(np.float32),
             gender=np.asarray(["m", "f", "n"] * n)[:n],
             joints3d=g.normal(size=(n, joints, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def body():
    return SMPLX(make_synthetic_model_data("smplx", subdivisions=1, seed=0))


def _meas(model):
    v_t = model.v_template.numpy()
    return (BodyMeasurements(MeasurementAnchors.synthetic(model.faces, v_t),
                             model.faces, num_hull_directions=64),
            JBodyMeasurements(anchors=JAnchors.synthetic(model.faces, v_t),
                              num_hull_directions=64))


def _items(port_ds, jax_ds):
    assert len(port_ds) == len(jax_ds) > 0
    for i in range(len(port_ds)):
        _equal(port_ds[i], jax_ds[i], f"[{i}]")


@pytest.mark.parametrize("crop", [None, False, True])
def test_hbw_items_match_jax(body, tmp_path, crop):
    root = str(tmp_path / "hbw")
    write_hbw_tree(root, body, np.random.default_rng(1), subjects=3,
                   multi_person=True)
    kw = {}
    if crop is not None:
        kw = {"transforms": transforms.build_transforms(
            {"crop_size": 64}, return_full_imgs=crop)}
        jkw = {"transforms": jtransforms.build_transforms(
            {"crop_size": 64}, return_full_imgs=crop)}
    ds = hbw.HBWDataset(data_folder=root, **kw)
    jds = jhbw.HBWDataset(data_folder=root, **(jkw if crop is not None
                                                else {}))
    assert ds.num_skipped == jds.num_skipped == 1
    assert ds.genders == jds.genders == ["female"] * 2 + ["male"] * 2 + [
        "neutral"] * 2
    if crop:
        # the port leaves the crop to the device
        for i in range(len(ds)):
            got, want = ds[i], jds[i]
            assert "cropped_image" not in got
            want.pop("cropped_image")
            _equal(got, want, f"[{i}]")
    else:
        _items(ds, jds)


def test_hbw_gt_measurements_and_cache_across_packages(body, tmp_path):
    """Port -> cache -> JAX reads it; JAX -> cache -> port reads it; a
    cache of other subject ids is recomputed. The GT measurements agree
    with the JAX package's to rel 1e-5."""
    meas, jmeas = _meas(body)
    faces = body.faces
    root = str(tmp_path / "hbw")
    write_hbw_tree(root, body, np.random.default_rng(2), subjects=3)
    cache = f"{root}/_meas_cache_val.npz"

    jax_fresh = jhbw.HBWDataset(data_folder=root, measurements_module=jmeas,
                                body_model_faces=faces).gt_measurements
    os.remove(cache)
    port_fresh = hbw.HBWDataset(data_folder=root, measurements_module=meas,
                                body_model_faces=faces).gt_measurements
    assert set(port_fresh) == set(jax_fresh) == {"s000", "s001", "s002"}
    for sid in port_fresh:
        for k, v in port_fresh[sid].items():
            np.testing.assert_allclose(v, jax_fresh[sid][k], rtol=1e-5,
                                       err_msg=f"{sid} {k}")
    # the port's cache, read by the JAX package
    with np.load(cache) as d:
        assert list(d["subject_ids"]) == ["s000", "s001", "s002"]
    assert jhbw.HBWDataset(data_folder=root, measurements_module=jmeas,
                           body_model_faces=faces).gt_measurements == \
        port_fresh
    # the JAX package's cache, read by the port (K1 not run again)
    os.remove(cache)
    jhbw.HBWDataset(data_folder=root, measurements_module=jmeas,
                    body_model_faces=faces)

    class Refuse:
        faces = meas.faces

        def forward(self, *a, **k):
            raise AssertionError("the cache was not read")

    assert hbw.HBWDataset(data_folder=root, measurements_module=Refuse(),
                          body_model_faces=faces).gt_measurements == \
        jax_fresh
    # a cache of other subjects is recomputed, and rewritten
    np.savez(cache, subject_ids=["x"], **{k: np.zeros(1, np.float32) for k
                                          in ("height", "chest", "waist",
                                              "hips", "mass")})
    again = hbw.HBWDataset(data_folder=root, measurements_module=meas,
                           body_model_faces=faces)
    assert again.gt_measurements == port_fresh
    item = again[0]
    for k in ("height", "chest", "waist", "hips", "mass"):
        assert item[f"{k}_gt"] == port_fresh["s000"][k]


def test_threedpw_items_match_jax(tmp_path):
    root = str(tmp_path / "3dpw")
    write_3dpw_tree(root, np.random.default_rng(3))
    for split in ("test", "train"):
        if split == "train":
            os.rename(f"{root}/npz_data/test.npz", f"{root}/npz_data/train.npz")
        tf = dict(crop_size=64)
        _items(threedpw.ThreeDPWDataset(
            data_folder=root, split=split,
            transforms=transforms.build_transforms(tf)),
            jthreedpw.ThreeDPWDataset(
                data_folder=root, split=split,
                transforms=jtransforms.build_transforms(tf)))


def test_ssp3d_items_match_jax(tmp_path):
    g = np.random.default_rng(4)
    root = tmp_path / "ssp"
    n = 3
    kps = np.concatenate([g.uniform(20, 80, (n, 25, 2)),
                          g.uniform(0, 1, (n, 25, 1))], -1)
    for i in range(n):
        H, W = SIZES[i]
        write_ppm(str(root / "images" / f"f{i}.ppm"),
                  g.integers(0, 256, (H, W, 3), dtype=np.uint8))
    write_ppm(str(root / "silhouettes" / "f1.ppm"),
              np.zeros((4, 4, 3), np.uint8))
    np.savez(root / "labels.npz", fnames=[f"f{i}.ppm" for i in range(n)],
             shapes=g.normal(size=(n, 10)), poses=g.normal(size=(n, 72)),
             joints2D=kps, genders=["m", "f", "m"],
             bbox_centres=g.uniform(40, 60, (n, 2)),
             bbox_whs=g.uniform(50, 70, n), cam_trans=np.zeros((n, 3)),
             vertices=g.normal(size=(n, 42, 3)))
    for tf in (None, {"crop_size": 64}):
        kw = {} if tf is None else {
            "transforms": transforms.build_transforms(tf)}
        jkw = {} if tf is None else {
            "transforms": jtransforms.build_transforms(tf)}
        _items(ssp3d.SSP3DDataset(data_folder=str(root), **kw),
               jssp3d.SSP3DDataset(data_folder=str(root), **jkw))


def test_openpose_dataset_items_match_jax(tmp_path):
    g = np.random.default_rng(5)
    root = tmp_path / "op"
    for i, (H, W) in enumerate(SIZES):
        write_ppm(str(root / "images" / f"im{i}.ppm"),
                  g.integers(0, 256, (H, W, 3), dtype=np.uint8))
        keypoints_json(str(root / "keypoints" / f"im{i}_keypoints.json"),
                       g, H, W, people=1 + i % 2)
    (root / "images" / "bad.ppm").write_bytes(b"P6\n4 4\n255\n")  # short
    keypoints_json(str(root / "keypoints" / "bad.json"), g, 4, 4)
    for dtype in ("float32", "uint8"):
        kw = dict(data_folder=str(root), image_dtype=dtype)
        ds = openpose.OpenPoseDataset(
            transforms=transforms.build_transforms({"crop_size": 32}), **kw)
        jds = jopenpose_ds.OpenPoseDataset(
            transforms=jtransforms.build_transforms({"crop_size": 32}), **kw)
        assert len(ds) == 5
        assert ds[0] is None and jds[0] is None  # a truncated image
        for i in range(1, 5):
            _equal(ds[i], jds[i])
