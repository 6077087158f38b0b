"""The port's training data against the JAX package's, on the CPU, on the
same seeded inputs: the annotation structures (``data/structures/``,
identical arrays), the items of the ``parametric``, ``model_agencies``
and ``openpose_tracks`` datasets on small synthetic folders (identical,
with and without the training transforms), the rasterizer by its native
and its numpy route (bit-equal to the JAX one's route of the same name
on the same vertices), the synthetic archive generator (its npz fields,
and its images within a stated bound of differing pixels), the numpy
Rodrigues against ``cv2.Rodrigues``, and the channel noise of K2's plain
version against the JAX ``ChannelNoise`` and ``Normalize`` applied to the
same plain crop."""

import json
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shapy_tpu.data.rng as jrng
import shapy_tpu.io.native as jnative
import shapy_tpu_torch.data.rng as trng
from shapy_tpu.data import structures as jst
from shapy_tpu.data import transforms as jtransforms
from shapy_tpu.data.datasets.model_agencies import ModelAgencyDataset as JMA
from shapy_tpu.data.datasets.openpose_tracks import (
    OpenPoseTracksDataset as JTracks,
)
from shapy_tpu.data.datasets.parametric import EHFDataset as JEHF
from shapy_tpu.data.datasets.parametric import ParametricFitsDataset as JPF
from shapy_tpu.data.crop import jax_bilinear_crop
from shapy_tpu.data.synthetic import generate_parametric_fits as jgenerate
from shapy_tpu.render.rasterizer import rasterize_mesh as jrasterize
from shapy_tpu_torch.data import structures as st
from shapy_tpu_torch.data import transforms
from shapy_tpu_torch.data.build import build_dataset
from shapy_tpu_torch.data.crop import bilinear_crop, crop_normalize_plain
from shapy_tpu_torch.data.datasets.model_agencies import ModelAgencyDataset
from shapy_tpu_torch.data.datasets.openpose import read_img
from shapy_tpu_torch.data.datasets.openpose_tracks import (
    OpenPoseTracksDataset,
)
from shapy_tpu_torch.data.datasets.parametric import (
    EHFDataset,
    ParametricFitsDataset,
)
from shapy_tpu_torch.data.synthetic import (
    generate_parametric_fits,
    register_synthetic_datasets,
    synthetic_train_config,
    write_ppm,
)
from shapy_tpu_torch.models.body.assets import icosphere
from shapy_tpu_torch.render.rasterizer import rasterize_mesh
from tests.test_torch_data import AUGMENT, _equal

torch.set_num_threads(2)


# -- structures ---------------------------------------------------------

def test_structures_copy_is_identical():
    """Every structure's ops give the JAX package's arrays."""
    g = np.random.default_rng(0)
    kp = np.concatenate([g.uniform(0, 90, (135, 2)),
                         g.uniform(0, 1, (135, 1))], 1)
    for mod_kp in ((st.Keypoints2D(kp, (100, 90, 3)),
                    jst.Keypoints2D(kp, (100, 90, 3))),):
        a, b = mod_kp
        a.add_field("box", st.BoundingBox([3, 4, 50, 60], (100, 90)))
        b.add_field("box", jst.BoundingBox([3, 4, 50, 60], (100, 90)))
        for op, args in (("crop", ((40, 50), 0.4, 64)), ("flip", ()),
                         ("normalize", ()), ("to_dset", ("smplx",))):
            x, y = getattr(a, op)(*args), getattr(b, op)(*args)
            _equal(x.keypoints, y.keypoints)
            assert x.fields() == y.fields() == ["box"]
        _equal(a.conf, b.conf)
        assert len(a) == len(b)
    k3 = g.normal(size=(135, 3))
    a, b = st.Keypoints3D(k3, "openpose25_v1"), jst.Keypoints3D(
        k3, "openpose25_v1")
    for op, args in (("rotate", (20.0,)), ("flip", ()),
                     ("to_dset", ("smplx",))):
        _equal(getattr(a, op)(*args).keypoints,
               getattr(b, op)(*args).keypoints)
    box, jbox = (m.BoundingBox([3, 4, 50, 60], (100, 90)) for m in (st, jst))
    _equal(box.flip().bbox, jbox.flip().bbox)
    _equal(box.to_center_scale(1.2), jbox.to_center_scale(1.2))
    pose = g.normal(size=(23, 3)).astype(np.float32)
    for name, value in (("BodyPose", pose), ("BodyPose", pose[:21]),
                        ("GlobalRot", pose[0]), ("JawPose", pose[:1]),
                        ("Betas", pose[:3]), ("Expression", pose[:2]),
                        ("HandPose", pose[:15])):
        _equal(getattr(st, name)(value).flip().value,
               getattr(jst, name)(value).flip().value)
    v = g.normal(size=(30, 3))
    for kw in ({}, {"flip_index": g.permutation(30)},
               {"bc": g.dirichlet(np.ones(3), 30),
                "closest_faces": g.integers(0, 30, (30, 3))}):
        _equal(st.Vertices(v, **kw).flip().vertices,
               jst.Vertices(v, **kw).flip().vertices)
    imgs = [g.uniform(size=(h, w, 3)).astype(np.float32)
            for h, w in ((5, 7), (8, 3), (2, 2))]
    a, b = st.ImageList.from_images(imgs), jst.ImageList.from_images(imgs)
    _equal(a.tensor, b.tensor)
    assert a.sizes == b.sizes and len(a) == 3
    _equal(st.Joints(k3).joints, jst.Joints(k3).joints)
    _equal(st.Points2D(kp[:, :2], (3, 4)).points,
           jst.Points2D(kp[:, :2], (3, 4)).points)


# -- datasets -------------------------------------------------------------

def _image(g, H, W):
    return g.integers(0, 256, (H, W, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def parametric_folder(tmp_path_factory):
    """Two archives: a 24-row SPIN block with every field, and a 49-row
    one without joints3d / vertices / gender (the NaN-filled blocks);
    images as PPM, one of them missing."""
    root = tmp_path_factory.mktemp("parametric")
    g = np.random.default_rng(1)
    names = []
    for i in range(7):
        name = f"img{i}.ppm"
        if i != 5:
            write_ppm(str(root / name), _image(g, 60 + i, 50))
        names.append(name)
    a = {"imgname": np.asarray(names[:4]),
         "center": g.uniform(20, 40, (4, 2)).astype(np.float32),
         "scale": g.uniform(0.2, 0.3, 4).astype(np.float32),
         "pose": (g.normal(size=(4, 72)) * 0.2).astype(np.float32),
         "shape": g.normal(size=(4, 10)).astype(np.float32),
         "gender": np.asarray(["male", "f", "neutral", "female"]),
         "keypoints2d": np.concatenate(
             [g.uniform(0, 50, (4, 24, 2)), g.uniform(0, 1, (4, 24, 1))],
             -1).astype(np.float32),
         "joints3d": g.normal(size=(4, 24, 4)).astype(np.float32),
         "vertices": g.normal(size=(4, 30, 3)).astype(np.float32)}
    b = {"imgname": np.asarray(names[4:]),
         "center": g.uniform(20, 40, (3, 2)).astype(np.float32),
         "scale": g.uniform(0.2, 0.3, (3, 1)).astype(np.float32),
         "pose": (g.normal(size=(3, 72)) * 0.2).astype(np.float32),
         "shape": g.normal(size=(3, 10)).astype(np.float32),
         "keypoints2d": np.concatenate(
             [g.uniform(0, 50, (3, 49, 2)), g.uniform(0, 1, (3, 49, 1))],
             -1).astype(np.float32)}
    np.savez(root / "a.npz", **a)
    np.savez(root / "b.npz", **b)
    return root


def _items(port, jax_ds, train):
    """Every item equal; in training each side's augmentation draws are
    reseeded alike before it."""
    assert len(port) == len(jax_ds)
    for i in range(len(port)):
        if train:
            trng.set_augment_seed(i)
            jrng.set_augment_seed(i)
        _equal(port[i], jax_ds[i])


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind", ["spin", "spin49", "curated"])
def test_parametric_items_match_jax(parametric_folder, kind, train):
    """Every field of every item (a missing image: None on both sides),
    without transforms and with the training transforms (host crop)."""
    files = {"spin": ["a.npz"], "spin49": ["b.npz"],
             "curated": ["a.npz", "b.npz"]}[kind]
    # GT meshes only without the flip (it needs vertex correspondences).
    kw = dict(data_folder=str(parametric_folder), npz_files=files,
              return_vertices=not train, split="train")
    if kind == "curated":
        kw.update(dataset_name="curated_fits", keypoint_format="smplx")
    else:
        kw.update(dataset_name="spin")
    if kind == "curated":
        kw.pop("keypoint_format")
    if train:
        cfg = {k: v for k, v in AUGMENT.items() if k != "max_size"}
        kw["transforms"] = transforms.build_transforms(cfg, is_train=True)
        jkw = dict(kw, transforms=jtransforms.build_transforms(
            cfg, is_train=True))
    else:
        jkw = kw
    try:
        port, ref = ParametricFitsDataset(**kw), JPF(**jkw)
    except ValueError as exc:  # the 49-row archive mixed with the 24-row
        with pytest.raises(ValueError, match=str(exc)[:20]):
            ParametricFitsDataset(**kw)
        return
    assert port.keypoint_format == ref.keypoint_format
    _equal(port.present, ref.present)
    _items(port, ref, train)
    assert port.name() == ref.name() and not port.only_2d()


def test_parametric_uint8_and_ehf(parametric_folder):
    """``image_dtype='uint8'`` gives the raw bytes of the f32 image; the
    EHF subclass and the registry's names build the same datasets."""
    kw = dict(data_folder=str(parametric_folder), npz_files=["a.npz"])
    f32 = ParametricFitsDataset(**kw)[0]["image"]
    u8 = ParametricFitsDataset(image_dtype="uint8", **kw)[0]["image"]
    assert u8.dtype == np.uint8
    np.testing.assert_array_equal(u8.astype(np.float32) / 255.0, f32)
    ehf = EHFDataset(data_folder=str(parametric_folder), img_folder="",
                     npz_files=("a.npz",))
    jehf = JEHF(data_folder=str(parametric_folder), img_folder="",
                npz_files=("a.npz",))
    _equal(ehf[1], jehf[1])
    assert ehf.name() == jehf.name() == "EHF/test"
    ds = build_dataset("spin", {"spin": kw}, "train", None, "uint8")
    assert ds.keypoint_format == "spin" and ds[0]["image"].dtype == np.uint8


@pytest.fixture(scope="module")
def agency_folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("agencies")
    g = np.random.default_rng(2)
    annots, splits = {}, {"train": [], "val": []}
    for m in range(4):
        key = f"model{m}"
        images = {}
        for i in range(2):
            fname = f"{i}.ppm"
            folder = root / "agencyA" / "images" / key
            folder.mkdir(parents=True, exist_ok=True)
            write_ppm(str(folder / fname), _image(g, 80, 60))
            kp = np.concatenate([g.uniform(5, 55, (135, 1)),
                                 g.uniform(5, 75, (135, 1)),
                                 g.uniform(0, 1, (135, 1))], 1)
            images[fname] = kp.tolist()
        images["missing.ppm"] = None
        annots[key] = {"agency": "agencyA",
                       "gender": ("female", "male")[m % 2],
                       "height": 1.6 + 0.05 * m, "chest": 0.9,
                       "waist": 0.7, "hips": None, "weight": 60.0 + m,
                       "attributes": g.uniform(1, 5, 15).tolist()
                       if m != 2 else None,
                       "images": images}
        splits["train" if m < 3 else "val"].append(key)
    (root / "annotations.json").write_text(json.dumps(annots))
    (root / "splits.json").write_text(json.dumps(splits))
    (root / "betas.json").write_text(json.dumps(
        {"model0": g.normal(size=10).tolist()}))
    return root


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("attrs_only", [False, True])
def test_model_agency_items_match_jax(agency_folder, attrs_only, train):
    kw = dict(data_folder=str(agency_folder), split="train",
              only_data_with_attributes=attrs_only, betas_fname="betas.json")
    if train:
        cfg = {k: v for k, v in AUGMENT.items() if k != "max_size"}
        kw["transforms"] = transforms.build_transforms(cfg, is_train=True)
        jkw = dict(kw, transforms=jtransforms.build_transforms(
            cfg, is_train=True))
    else:
        jkw = kw
    port, ref = ModelAgencyDataset(**kw), JMA(**jkw)
    assert len(port) == (4 if attrs_only else 6)
    _items(port, ref, train)
    assert port.only_2d() and port.name() == ref.name()


def test_openpose_tracks_items_match_jax(tmp_path):
    """Track ids from ``person_id`` (a list, a number, missing, negative:
    the position in the image), each item's fields and ``tracks()``."""
    g = np.random.default_rng(3)
    (tmp_path / "images").mkdir()
    (tmp_path / "keypoints").mkdir()
    pids = {"f0": [[4], 7], "f1": [None, -1], "f2": [[], 3]}
    for frame, ids in pids.items():
        write_ppm(str(tmp_path / "images" / f"{frame}.ppm"),
                  _image(g, 70, 90))
        people = []
        for pid in ids:
            body = np.stack([g.uniform(10, 80, 25), g.uniform(10, 60, 25),
                             g.uniform(0.3, 1, 25)], -1)
            person = {"pose_keypoints_2d": body.reshape(-1).tolist()}
            if pid is not None:
                person["person_id"] = pid
            people.append(person)
        (tmp_path / "keypoints" / f"{frame}_keypoints.json").write_text(
            json.dumps({"people": people}))
    port = OpenPoseTracksDataset(data_folder=str(tmp_path))
    ref = JTracks(data_folder=str(tmp_path))
    assert port.track_ids == ref.track_ids == [4, 7, 0, 1, 0, 3]
    assert port.tracks() == ref.tracks()
    _items(port, ref, False)


# -- rasterizer -----------------------------------------------------------

@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("mode", ["smooth", "flat", "phong"])
def test_rasterizer_bit_equal_to_jax(route, mode, monkeypatch):
    """Shading, mask and depth bit-equal to the JAX rasterizer's on the
    same vertices, by the same route (the JAX one's native loader made to
    report no library for its numpy route)."""
    v, f = icosphere(3)
    v = v * np.array([0.5, 0.8, 0.4]) + np.array([0.07, -0.03, 2.2])
    kw = dict(focal_length=150.0, shading_mode=mode, return_depth=True)
    if route == "numpy":
        monkeypatch.setattr(jnative, "rasterize_fragments_native",
                            lambda *a, **k: None)
    want = jrasterize(v, f, (70, 90), **kw)
    got = rasterize_mesh(v, f, (70, 90), route=route, **kw)
    assert got[1].sum() > 500
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_rasterizer_refuses_other_routes():
    v, f = icosphere(1)
    with pytest.raises(ValueError, match="route"):
        rasterize_mesh(v + [0, 0, 3], f, (8, 8), route="cv2")


# -- synthetic archives ---------------------------------------------------

GEN = dict(image_size=56, subdivisions=1, pose_std=0.1,
           global_std=(0.05, 0.45, 0.05), betas_std=2.5, active_betas=2)


@pytest.fixture(scope="module")
def synthetic_pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    want = jgenerate(str(root / "jax"), 6, seed=4, **GEN)
    got = generate_parametric_fits(str(root / "port"), 6, seed=4,
                                   device="cpu", **GEN)
    return root, got, want


def test_synthetic_archive_fields_match_jax(synthetic_pair):
    """The npz on disk holds the JAX archive's fields: the drawn pose and
    betas, centers and scales equal; keypoints and vertices within 1e-5
    of the largest (the two LBS differ in the last f32 bits); image names
    the same but for the extension."""
    root, got, want = synthetic_pair
    disk = dict(np.load(root / "port" / "fits.npz"))
    assert set(disk) == set(want) == set(got)
    for k in ("center", "scale", "pose", "shape"):
        _equal(disk[k], want[k])
    for k in ("keypoints2d", "vertices"):
        assert disk[k].dtype == want[k].dtype == np.float32
        np.testing.assert_allclose(disk[k], want[k], rtol=0,
                                   atol=1e-5 * np.abs(want[k]).max())
    assert [os.path.splitext(n)[0] for n in disk["imgname"]] == [
        os.path.splitext(n)[0] for n in want["imgname"]]
    assert all(n.endswith(".ppm") for n in disk["imgname"])


def test_synthetic_images_within_bound(synthetic_pair):
    """Each image as the loaders read it against the JAX package's PNG:
    at most 1% of the pixels differ, at most 0.1% by more than one level
    (an edge pixel the last f32 bits of a vertex move); the numpy route
    of the rasterizer within the same bound of the native one (the native
    pass interpolates in f32, the numpy one's shading in f64)."""
    root, got, want = synthetic_pair
    again = generate_parametric_fits(str(root / "numpy"), 6, seed=4,
                                     device="cpu", raster_route="numpy",
                                     **GEN)
    for a, b in zip(got["imgname"], want["imgname"]):
        x = read_img(str(root / "port" / a), "uint8").astype(int)
        for other in (root / "jax" / b, root / "numpy" / a):
            differ = np.abs(x - read_img(str(other), "uint8")).max(-1)
            assert (differ > 0).mean() <= 0.01
            assert (differ > 1).mean() <= 0.001
    assert list(again["imgname"]) == list(got["imgname"])


def test_synthetic_config_and_registry(synthetic_pair):
    root = synthetic_pair[0]
    cfg = synthetic_train_config(str(root))
    from shapy_tpu.data.synthetic import synthetic_train_config as jcfg

    assert cfg == jcfg(str(root))
    register_synthetic_datasets(["port"])
    ds = build_dataset("port", {"port": {"data_folder": str(root / "port"),
                                         "npz_files": ["fits.npz"],
                                         "keypoint_format": "smplx"}},
                       "train", None)
    assert isinstance(ds, ParametricFitsDataset) and len(ds) == 6


# -- transforms: Rodrigues, channel noise ---------------------------------

def test_rodrigues_matches_cv2():
    """Vectors -> matrices within 1e-14, matrices -> vectors within 1e-12
    (1e-7 near an angle of pi, OpenCV's square-root branch); the Crop
    rotation of the GT pose bit-equal to the JAX package's in f32."""
    g = np.random.default_rng(5)
    vecs = [np.zeros(3), np.array([1e-20, 0, 0])]
    vecs += [g.normal(size=3) * s for s in (1e-9, 1e-3, 1.0, 3.0)
             for _ in range(10)]
    vecs += [a * np.pi for a in np.eye(3)]
    vecs += [v / np.linalg.norm(v) * (np.pi - 1e-7)
             for v in g.normal(size=(5, 3))]
    for v in vecs:
        R, _ = cv2.Rodrigues(v)
        np.testing.assert_allclose(transforms.rodrigues(v), R, atol=1e-14)
        near_pi = np.linalg.norm(v) > np.pi - 1e-3
        np.testing.assert_allclose(transforms.rodrigues(R),
                                   cv2.Rodrigues(R)[0].reshape(3),
                                   atol=1e-7 if near_pi else 1e-12)
    for _ in range(100):
        aa = g.normal(size=3).astype(np.float32)
        rot = g.normal() * 30
        c, s = np.cos(np.deg2rad(-rot)), np.sin(np.deg2rad(-rot))
        Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        want = cv2.Rodrigues(Rz.astype(np.float64) @ cv2.Rodrigues(
            aa.astype(np.float64))[0])[0].reshape(3).astype(np.float32)
        got = transforms.rodrigues(Rz.astype(np.float64) @ transforms.
                                   rodrigues(aa)).astype(np.float32)
        np.testing.assert_array_equal(got, want)


def test_channel_noise_on_the_device_crop_matches_jax():
    """K2's plain version with the drawn factors against the JAX
    ``ChannelNoise`` and ``Normalize`` applied to the same plain crop (the
    plain version's own bilinear crop, which ``jax_bilinear_crop`` meets
    within 1e-5): within 1e-6 (the JAX package multiplies by the f64
    factors and rounds once; K2 by the f32 factors); factors of 1 (no
    noise) give the crop without them, bit for bit; the sample's factors
    are the JAX transform's draw."""
    g = np.random.default_rng(6)
    images = g.integers(0, 256, (3, 70, 90, 3), dtype=np.uint8)
    affines = np.stack([np.array([[0.3, -0.1, 20.0 + i], [0.1, 0.3, 5.0],
                                  [0, 0, 1]], np.float32) for i in range(3)])
    crops = bilinear_crop(torch.from_numpy(images).float() * (1.0 / 255.0),
                          torch.from_numpy(affines), (48, 48)).numpy()
    np.testing.assert_allclose(np.asarray(jax_bilinear_crop(
        jnp.asarray(images.astype(np.float32) / 255.0),
        jnp.asarray(affines), (48, 48))), crops, rtol=0, atol=1e-5)
    port_noise = transforms.ChannelNoise(0.4)
    jnoise, jnorm = jtransforms.ChannelNoise(0.4), jtransforms.Normalize()
    factors, want = [], []
    for i in range(3):
        s = port_noise({"image": images[i], "crop_to_image": affines[i]},
                       np.random.default_rng(i))
        factors.append(s["channel_noise"])
        j = jnorm(jnoise({"cropped_image": crops[i].copy()},
                         np.random.default_rng(i)), None)
        want.append(j["cropped_image"])
    factors = np.stack(factors)
    got = crop_normalize_plain(torch.from_numpy(images),
                               torch.from_numpy(affines), 48,
                               factors=torch.from_numpy(factors))
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=0,
                               atol=1e-6)
    ones = torch.ones(3, 3)
    assert torch.equal(
        crop_normalize_plain(torch.from_numpy(images),
                             torch.from_numpy(affines), 48, factors=ones),
        crop_normalize_plain(torch.from_numpy(images),
                             torch.from_numpy(affines), 48))
