"""The port's host-side data modules against the JAX package's, on the
same seeded inputs: the numpy copies (``data/bbox.py``, ``openpose.py``,
``rng.py``, ``samplers.py``, ``transforms.py``, the collate of
``build.py``) give identical arrays (exact equality); the PPM decoder of
``data/datasets/openpose.py`` is bit-equal to ``cv2.imread``; the
full-image collate's zero padding crops as each image alone through
``crop_normalize_plain`` (bit-equal)."""

import json
import sys

import numpy as np
import pytest
import torch

from shapy_tpu.data import bbox as jbbox
from shapy_tpu.data import build as jbuild
from shapy_tpu.data import openpose as jopenpose
from shapy_tpu.data import rng as jrng
from shapy_tpu.data import samplers as jsamplers
from shapy_tpu.data import transforms as jtransforms
from shapy_tpu_torch.data import bbox, build, openpose, rng, samplers
from shapy_tpu_torch.data import transforms
from shapy_tpu_torch.data.crop import crop_normalize_plain
from shapy_tpu_torch.data.datasets.openpose import read_img, read_ppm
from shapy_tpu_torch.data.keypoints import model_keypoint_names


def _equal(a, b, path=""):
    """Deep equality of nested dicts / lists / arrays / scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and (a == b or a != a and b != b), (
            path, a, b)


def _person(g, W, H, hands=True):
    body = np.zeros((25, 3))
    body[:, 0] = g.uniform(10, W - 10, 25)
    body[:, 1] = g.uniform(10, H - 10, 25)
    body[:, 2] = g.uniform(0.05, 1.0, 25)
    person = {"pose_keypoints_2d": body.reshape(-1).tolist()}
    if hands:
        for key, n in (("hand_left_keypoints_2d", 21),
                       ("hand_right_keypoints_2d", 21),
                       ("face_keypoints_2d", 70)):
            person[key] = np.concatenate(
                [g.uniform(0, W, (n, 2)), g.uniform(0, 1, (n, 1))],
                1).reshape(-1).tolist()
    return person


def test_bbox_copy_is_identical():
    g = np.random.default_rng(0)
    for _ in range(20):
        kp = g.uniform(0, 300, size=(135, 2)).astype(np.float32)
        conf = (g.uniform(size=135) > 0.7).astype(np.float32)
        for kw in ({}, {"img_size": (200, 150, 3), "clip_to_img": True},
                   {"scale": 1.3, "min_valid_keypoints": 40}):
            a = bbox.keyps_to_bbox(kp, conf, **kw)
            b = jbbox.keyps_to_bbox(kp, conf, **kw)
            _equal(a, b)
            _equal(bbox.bbox_to_center_scale(a, 1.2),
                   jbbox.bbox_to_center_scale(b, 1.2))
    pts = g.uniform(size=(4, 30, 2))
    _equal(bbox.points_to_bbox(pts, 1.1), jbbox.points_to_bbox(pts, 1.1))
    a, b = g.uniform(0, 50, 4), g.uniform(0, 50, 4)
    a[2:] += a[:2]
    b[2:] += b[:2]
    assert bbox.bbox_iou(a, b) == jbbox.bbox_iou(a, b)
    _equal(bbox.bbox_xyxy_to_xywh(a), jbbox.bbox_xyxy_to_xywh(a))
    _equal(bbox.bbox_xywh_to_xyxy(a), jbbox.bbox_xywh_to_xyxy(a))
    assert bbox.scale_to_bbox_size(1.5) == jbbox.scale_to_bbox_size(1.5)


def test_openpose_copy_is_identical(tmp_path):
    g = np.random.default_rng(1)
    files = {
        "two.json": {"people": [_person(g, 100, 120),
                                _person(g, 100, 120, hands=False)]},
        "bad_person.json": {"people": [{"pose_keypoints_2d": [1.0] * 30},
                                       _person(g, 80, 90)]},
        "empty.json": {"people": []},
        "list.json": [1, 2],
    }
    for name, content in files.items():
        (tmp_path / name).write_text(json.dumps(content))
    (tmp_path / "broken.json").write_text("{not json")
    for name in (*files, "broken.json", "missing.json"):
        path = str(tmp_path / name)
        _equal(openpose.read_openpose_json(path),
               jopenpose.read_openpose_json(path))
    kp = openpose.read_openpose_json(str(tmp_path / "two.json"))
    for args in ((0.1, 0.2, 0.4, True), (0.3, 0.3, 0.4, False),
                 (0.0, 0.0, 0.0, True)):
        _equal(openpose.threshold_and_keep_parts(kp, "openpose25_v1", *args),
               jopenpose.threshold_and_keep_parts(kp, "openpose25_v1",
                                                  *args))


def test_rng_copy_is_identical():
    for i in (0, 5, 123):
        _equal(rng.augment_rng(i, False).uniform(size=5),
               jrng.augment_rng(i, False).uniform(size=5))
    rng.set_augment_seed(3)
    jrng.set_augment_seed(3)
    for i in (0, 5, 5, 9):
        _equal(rng.augment_rng(i).normal(size=4),
               jrng.augment_rng(i).normal(size=4))


class _Fake:
    def __init__(self, n, only2d, genders=None, weight=None):
        self.n, self._only2d = n, only2d
        self.gender = np.asarray(genders or ["m"] * n)
        self.weight = np.asarray(weight if weight is not None
                                 else np.arange(n, dtype=float))

    def __len__(self):
        return self.n

    def only_2d(self):
        return self._only2d


def test_samplers_copy_is_identical():
    a, b = _Fake(10, True), _Fake(6, False)
    for shuffle in (False, True):
        got = list(samplers.EqualSampler([a, b], 4, 0.5, shuffle, seed=2))
        want = list(jsamplers.EqualSampler([a, b], 4, 0.5, shuffle, seed=2))
        _equal(got, want)
    c = _Fake(40, True, ["m"] * 15 + ["f"] * 25,
              np.concatenate([np.full(20, 60.0), np.full(20, 90.0)]))
    for key in ("weight", "bmi"):
        got = list(samplers.ShapeSampler([c, b], 8, key, True, seed=4))
        want = list(jsamplers.ShapeSampler([c, b], 8, key, True, seed=4))
        _equal(got, want)
    vals = np.asarray([60.0] * 9 + [100.0, np.nan])
    _equal(samplers.weights_to_probabilities(vals),
           jsamplers.weights_to_probabilities(vals))
    seq = build.SequentialBatchSampler(10, 4)
    _equal(list(samplers.ShardedSampler(seq, 2, 1)),
           list(jsamplers.ShardedSampler(seq, 2, 1)))
    assert samplers.shard_sampler_by_process(seq) is seq  # no process group
    _equal(list(build.ShuffledBatchSampler(11, 3, seed=5)),
           list(jbuild.ShuffledBatchSampler(11, 3, seed=5)))


def _sample(g, H=120, W=100):
    kp = np.concatenate([g.uniform(0, W, (135, 1)), g.uniform(0, H, (135, 1)),
                         (g.uniform(size=(135, 1)) > 0.3)], 1)
    return {
        "image": g.uniform(size=(H, W, 3)).astype(np.float32),
        "keypoints2d": kp.astype(np.float32),
        "keypoint_format": "openpose25_v1",
        "center": np.asarray([W / 2 + 3.0, H / 2 - 2.0], np.float32),
        "scale": 0.45,
        "bbox_size": 90.0,
        "joints3d": g.normal(size=(25, 4)).astype(np.float32),
        "gt_pose_aa": (g.normal(size=72) * 0.2).astype(np.float32),
        "gt_v_shaped": g.normal(size=(42, 3)).astype(np.float32),
        "gender": "female",
        "gender_int": 2,
        "height_gt": 1.7,
        "mass_gt": 70.0,
        "fname": "x.png",
    }


AUGMENT = {"crop_size": 64, "flip_prob": 0.5, "scale_factor": 0.25,
           "scale_dist": "normal", "rotation_factor": 30.0,
           "noise_scale": 0.4, "center_jitter_factor": 0.05,
           "extreme_crop_prob": 0.3, "motion_blur_prob": 0.5,
           "max_size": 110, "downsample_dist": "categorical",
           "downsample_cat_factors": [1.0, 2.0]}


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_transforms_copy_is_identical(full, train, tmp_path):
    """Every field of the pipeline's output, eval and train (every
    augmentation on, the same seeded draws), with and without
    ``return_full_imgs``; there the port's samples lack only
    ``cropped_image`` (the device crops), in training they carry the
    channel noise's drawn factors for the device, and the full image
    stays the JAX package's. With full images a downsample factor above
    1 has no device version and raises, so those cases draw factor 1
    only; a draw of 2 must raise."""
    from shapy_tpu.models.body.assets import icosphere

    v, _ = icosphere(1)
    flip = tmp_path / "flip.npz"
    tf = transforms.VertexFlipper.from_template(v)
    np.savez(flip, closest_faces=tf.closest_faces, bc=tf.bc)
    cfg = dict(AUGMENT, vertex_flip_correspondences=str(flip))
    if full and train:
        with pytest.raises(ValueError, match="SimulateLowRes"):
            for i in range(8):
                transforms.build_transforms(
                    cfg, is_train=True, return_full_imgs=True)(
                        _sample(np.random.default_rng(100 + i)),
                        np.random.default_rng(i))
        cfg["downsample_cat_factors"] = [1.0]
    port = transforms.build_transforms(cfg, is_train=train,
                                       return_full_imgs=full)
    ref = jtransforms.build_transforms(cfg, is_train=train,
                                       return_full_imgs=full)
    for i in range(8):
        g = np.random.default_rng(100 + i)
        s = _sample(g)
        got = port(dict(s), np.random.default_rng(i))
        want = ref(dict(s), np.random.default_rng(i))
        if full:
            assert "cropped_image" not in got
            want.pop("cropped_image")
            assert got["image"].shape[:2] != (64, 64)
            if train:
                noise = got.pop("channel_noise")
                assert noise.dtype == np.float32 and noise.shape == (3,)
                assert np.all(np.abs(noise - 1.0) <= 0.4)
        _equal(got, want)
    _equal(transforms.VertexFlipper.from_template(v)(v),
           jtransforms.VertexFlipper.from_template(v)(v))


def _crop_samples(g, sizes, full):
    tf = transforms.build_transforms({"crop_size": 48}, is_train=False,
                                     return_full_imgs=full)
    names = model_keypoint_names("smplx")
    out = []
    for i, (H, W) in enumerate(sizes):
        s = _sample(g, H, W)
        s["image"] = g.integers(0, 256, (H, W, 3), dtype=np.uint8)
        s["joints14"] = g.normal(size=(14, 3)).astype(np.float32)
        s["gt_betas"] = g.normal(size=10).astype(np.float32)
        s["keypoint_format"] = "openpose25_v1"
        if i == 1:
            s.pop("gt_pose_aa")
        out.append(tf(s, np.random.default_rng(i)))
    return out, names


def test_collate_copy_is_identical():
    g = np.random.default_rng(6)
    samples, names = _crop_samples(g, [(120, 100), (90, 130), (64, 64)],
                                   False)
    samples.insert(1, None)  # a dropped sample
    got = build.collate_batch(samples, names)
    want = jbuild.collate_batch(samples, names)
    _equal(got, want)
    assert "crop_to_image_affines" not in got


def test_full_image_collate_pads_exactly():
    """Mixed sizes: the padded batch crops (plain version of K2) bit-equal
    to each image cropped alone, and the other fields are the crop-mode
    collate's."""
    g = np.random.default_rng(7)
    sizes = [(120, 100), (90, 130), (64, 64), (131, 77)]
    samples, names = _crop_samples(g, sizes, True)
    out = build.collate_batch(samples, names)
    assert "images" not in out
    full, aff = out["full_images"], out["crop_to_image_affines"]
    assert full.shape == (4, 131, 130, 3) and full.dtype == np.uint8
    assert aff.shape == (4, 3, 3) and aff.dtype == np.float32
    batch = crop_normalize_plain(torch.from_numpy(full),
                                 torch.from_numpy(aff), 48)
    for i, s in enumerate(samples):
        H, W = sizes[i]
        np.testing.assert_array_equal(full[i, :H, :W], s["image"])
        assert not full[i, H:].any() and not full[i, :, W:].any()
        alone = crop_normalize_plain(torch.from_numpy(s["image"][None]),
                                     torch.from_numpy(aff[i:i + 1]), 48)
        assert torch.equal(batch[i:i + 1], alone), i
    # some crop reaches past its image's right or bottom edge into the
    # batch's padding, which it must read as zeros
    corners = np.asarray([[0, 0, 1], [47, 0, 1], [0, 47, 1], [47, 47, 1]],
                         np.float32)
    reach = [(aff[i] @ corners.T)[:2].max(axis=1) for i in range(4)]
    assert any(x > W - 1 or y > H - 1 for (H, W), (x, y) in
               zip(sizes, reach))
    cropped, _ = _crop_samples(np.random.default_rng(7), sizes, False)
    ref = build.collate_batch(cropped, names)
    for key in set(ref) - {"images", "full_images"}:
        _equal(out[key], ref[key], key)
    with pytest.raises(ValueError, match="cropped_image"):
        build.collate_batch([{"image": samples[0]["image"]}], names)


def test_ppm_decoder_matches_cv2(tmp_path):
    import cv2

    g = np.random.default_rng(8)
    for H, W in ((1, 1), (7, 5), (33, 64), (121, 97), (360, 480)):
        img = g.integers(0, 256, (H, W, 3), dtype=np.uint8)
        path = str(tmp_path / f"{H}x{W}.ppm")
        assert cv2.imwrite(path, img)
        want = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR),
                            cv2.COLOR_BGR2RGB)
        got = read_ppm(path)
        assert got.dtype == np.uint8 and got.flags.writeable
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(read_img(path, "uint8"), want)
        np.testing.assert_array_equal(
            read_img(path), want.astype(np.float32) / np.float32(255.0))
    # a header with comments and other whitespace
    img = g.integers(0, 256, (3, 4, 3), dtype=np.uint8)
    path = tmp_path / "comment.ppm"
    path.write_bytes(b"P6 # made here\n4\t3\n# maxval next\n255\n"
                     + img[..., ::-1][..., ::-1].tobytes())
    np.testing.assert_array_equal(read_ppm(str(path)), img)
    np.testing.assert_array_equal(
        read_ppm(str(path)),
        cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB))
    path.write_bytes(b"P6\n4 3\n65535\n" + bytes(72))
    assert read_ppm(str(path)) is None  # 16-bit: left to cv2


def test_read_img_without_cv2_names_the_file(tmp_path, monkeypatch):
    import cv2

    png = str(tmp_path / "a.png")
    cv2.imwrite(png, np.zeros((4, 4, 3), np.uint8))
    ppm = str(tmp_path / "a.ppm")
    cv2.imwrite(ppm, np.full((4, 4, 3), 7, np.uint8))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="a.png"):
        read_img(png)
    assert read_img(ppm, "uint8").max() == 7
    with pytest.raises(FileNotFoundError):
        read_img(str(tmp_path / "missing.ppm"))


def test_registry_holds_the_ported_datasets():
    """Every dataset of the JAX package's registry is ported, under the
    same name and class name (names that other tests register for
    synthetic archives aside)."""
    build._populate_registry()
    jbuild._populate_registry()
    names = {"openpose", "hbw", "threedpw", "ssp3d", "model_agencies",
             "ehf", "curated_fits", "spin", "spinx", "human36mx",
             "openpose_tracks"}
    assert names <= set(jbuild.DATASET_REGISTRY)
    assert names <= set(build.DATASET_REGISTRY)
    for name in names:
        assert (build.DATASET_REGISTRY[name].__name__
                == jbuild.DATASET_REGISTRY[name].__name__), name
    with pytest.raises(KeyError, match="Unknown dataset"):
        build.build_dataset("nope", {}, "train", None)
