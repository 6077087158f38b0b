"""The renderer, the skeleton drawing and the PNG writer against the JAX
package's (``shapy_tpu/render/``): the same seeded numpy vertices, faces,
images and cameras go to both.

Both renderers are host code over the same native library
(``native/shapy_native.cpp``), so ``render_mesh``, ``render_mesh_overlay``
(both shading modes, supersample 1 and 2), the three renderer classes and
``_rotate_y`` must be bit-equal; the skeleton drawing is ``cv2``'s on
both sides and must be bit-equal too. The port's numpy shading route (the
native route's oracle) agrees with the native route within 1e-5 (f64
against the kernel's f32). The PNG writer's files, decoded by
``cv2.imread``, hold exactly the pixels of ``cv2.imwrite``'s files.
"""

import sys

import cv2
import numpy as np
import pytest

from shapy_tpu.render import rasterizer as jrast
from shapy_tpu.render import renderers as jrend
from shapy_tpu.render import skeleton as jskel
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
from shapy_tpu_torch.render import png
from shapy_tpu_torch.render import rasterizer as trast
from shapy_tpu_torch.render import renderers as trend
from shapy_tpu_torch.render import skeleton as tskel

H, W = 60, 80


@pytest.fixture(scope="module")
def mesh():
    data = make_synthetic_model_data("smplx", subdivisions=2, seed=3)
    rng = np.random.default_rng(0)
    v = np.asarray(data["v_template"], np.float64)
    v = v + rng.normal(scale=0.01, size=v.shape)
    return v.astype(np.float32), np.asarray(data["f"], np.int64)


def _camera_space(v, z=3.0):
    out = np.asarray(v, np.float64) - np.asarray(v, np.float64).mean(0)
    out[:, 1] *= -1.0
    out[:, 2] = z - out[:, 2]
    return out


def _equal(a, b):
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("ss", [1, 2])
def test_render_mesh_matches_jax(mesh, ss):
    v, f = mesh
    vc = np.random.default_rng(1).uniform(size=(len(v), 3))
    cam = _camera_space(v)
    for kwargs in ({}, {"vertex_colors": vc, "camera_center": (35.0, 28.0)},
                   {"focal_length": (260.0, 240.0),
                    "material": jrast.Material((0.3, 0.6, 0.2), 0.4, 0.3)}):
        tkw = dict(kwargs)
        if "material" in kwargs:
            tkw["material"] = trast.Material((0.3, 0.6, 0.2), 0.4, 0.3)
        fl = kwargs.get("focal_length", 250.0)
        want = jrast.render_mesh(cam, f, (H, W), supersample=ss,
                                 **dict(kwargs, focal_length=fl))
        got = trast.render_mesh(cam, f, (H, W), supersample=ss,
                                **dict(tkw, focal_length=fl))
        assert want[1].max() > 0.5  # the body covers pixels
        _equal(got, want)


@pytest.mark.parametrize("mode", ["smooth", "phong"])
@pytest.mark.parametrize("ss", [1, 2])
def test_render_mesh_overlay_matches_jax(mesh, mode, ss):
    v, f = mesh
    img = np.random.default_rng(2).uniform(size=(H, W, 3)).astype(np.float32)
    cam = _camera_space(v, 0.0)
    transl = np.asarray([0.05, -0.02, 3.0])
    kw = dict(transl=transl, focal_length=250.0, camera_center=(41.0, 31.0),
              color=(0.7, 0.5, 0.9), shading_mode=mode, supersample=ss)
    want = jrast.render_mesh_overlay(img, cam, f, **kw)
    got = trast.render_mesh_overlay(img, cam, f, **kw)
    assert got.dtype == np.float32 and np.abs(got - img).max() > 0.1
    _equal(got, want)


def test_shading_routes_agree(mesh):
    """The numpy shading (f64) against the native kernel (f32)."""
    v, f = mesh
    cam = _camera_space(v)
    native = trast.render_mesh(cam, f, (H, W), 250.0, route="native")
    plain = trast.render_mesh(cam, f, (H, W), 250.0, route="numpy")
    np.testing.assert_array_equal(native[1], plain[1])
    np.testing.assert_allclose(native[0], plain[0], atol=1e-5)
    with pytest.raises(ValueError, match="route"):
        trast.shade_covered(None, None, None, cam, f, None, None, None, None,
                            W, route="gpu")


def test_renderers_match_jax(mesh):
    v, f = mesh
    rng = np.random.default_rng(3)
    B = 2
    verts = np.stack([v, v * 1.05]).astype(np.float64)
    bg = rng.uniform(size=(B, 3, H, W)).astype(np.float32)
    bg4 = np.concatenate([bg, rng.uniform(size=(B, 1, H, W))], 1)
    scale = rng.uniform(0.8, 1.2, size=(B, 1))
    transl = rng.normal(scale=0.05, size=(B, 2))
    assert trend.COLORS == jrend.COLORS
    for scale_first in (False, True):
        for deg, bgs, alpha in ((0, None, False), (30, bg, True),
                                (90, bg4, True)):
            kw = dict(camera_scale=scale, camera_translation=transl,
                      bg_imgs=bgs, deg=deg, return_with_alpha=alpha,
                      scale_first=scale_first)
            want = jrend.OverlayRenderer(f, img_size=48, supersample=2)(
                verts, **kw)
            got = trend.OverlayRenderer(f, img_size=48, supersample=2)(
                verts, **kw)
            _equal(got, want)
    K = np.tile(np.asarray([[250.0, 0, 40.0], [0, 240.0, 30.0], [0, 0, 1]]),
                (B, 1, 1))
    cams = np.stack([_camera_space(x) for x in verts])
    for bgs in (None, bg):
        _equal(trend.GTRenderer(f, img_size=48)(
                   cams, intrinsics=K, bg_imgs=bgs, deg=45,
                   return_with_alpha=True),
               jrend.GTRenderer(f, img_size=48)(
                   cams, intrinsics=K, bg_imgs=bgs, deg=45,
                   return_with_alpha=True))
    hd_kw = dict(focal_length=np.full(B, 250.0),
                 camera_translation=np.asarray([[0.0, 0.0, 3.0],
                                                [0.05, 0.02, 3.2]]),
                 camera_center=np.asarray([[40.0, 30.0], [36.0, 33.0]]),
                 bg_imgs=bg, return_with_alpha=True,
                 body_color=trend.COLORS["stage_02"],
                 vertex_colors=rng.uniform(size=(B, len(v), 3)))
    _equal(trend.HDRenderer(f)(verts - verts.mean(1, keepdims=True),
                               **hd_kw),
           jrend.HDRenderer(f)(verts - verts.mean(1, keepdims=True),
                               **hd_kw))
    for deg in (0, 37.5, 180):
        _equal(trend._rotate_y(verts[0], deg), jrend._rotate_y(verts[0], deg))


def test_weak_persp_to_blender_matches_jax():
    from shapy_tpu.cli import demo as jdemo
    from shapy_tpu_torch.cli import demo as tdemo

    rng = np.random.default_rng(4)
    s, t, size = rng.uniform(0.5, 1.5, 3), rng.normal(size=(3, 2)), \
        rng.uniform(100, 300, 3)
    _equal(trast.weak_persp_to_blender(s, t, size),
           jrast.weak_persp_to_blender(s, t, size))
    centers = rng.uniform(50, 300, size=(3, 2))
    want = jdemo.weak_persp_to_blender(centers, size, s, t, 360, 480)
    got = tdemo.weak_persp_to_blender(centers, size, s, t, 360, 480)
    assert got.keys() == want.keys()
    for k in want:
        _equal(got[k], want[k])


def _skeleton_inputs():
    from shapy_tpu_torch.data.keypoints import (
        KEYPOINT_NAMES_DICT,
        connections_for_names,
    )

    rng = np.random.default_rng(5)
    names = KEYPOINT_NAMES_DICT["openpose25_v1"]
    K = len(names)
    kp = np.concatenate([rng.uniform(2, 60, size=(K, 2)),
                         (rng.uniform(size=(K, 1)) > 0.2)], 1).astype(
        np.float32)
    img = rng.uniform(size=(64, 64, 3)).astype(np.float32)
    return img, kp, names, connections_for_names(names)


def test_skeleton_matches_jax():
    img, kp, names, conn = _skeleton_inputs()
    for kw in ({}, {"marker_size": 4, "linewidth": 1, "draw_skel": False}):
        _equal(tskel.create_skel_img(img, kp[:, :2], conn, valid=kp[:, 2],
                                     names=names, **kw),
               jskel.create_skel_img(img, kp[:, :2], conn, valid=kp[:, 2],
                                     names=names, **kw))
    chw = np.transpose(img, (2, 0, 1))
    for fmt in ("openpose25_v1", "coco"):
        _equal(tskel.keyp_target_to_image(chw, kp, fmt),
               jskel.keyp_target_to_image(chw, kp, fmt))
    # The labels: some cv2 versions draw text only on 8-bit images. Either
    # both sides raise the same error or both draw the same pixels.
    results = []
    for fn in (tskel.create_skel_img, jskel.create_skel_img):
        try:
            results.append(fn(img, kp[:, :2], conn, names=names,
                              draw_text=True))
        except Exception as exc:  # noqa: BLE001 - compared below
            results.append(exc)
    if any(isinstance(r, Exception) for r in results):
        assert [type(r) for r in results] == [type(results[1])] * 2, results
        assert str(results[0]) == str(results[1])
    else:
        _equal(*results)
    _equal(tskel.create_bbox_img(img, [5.4, 6.6, 50.2, 40.0], (1, 0, 0), 3),
           jskel.create_bbox_img(img, [5.4, 6.6, 50.2, 40.0], (1, 0, 0), 3))
    _equal(tskel.blend_images(img, img[::-1], 0.3),
           jskel.blend_images(img, img[::-1], 0.3))
    _equal(tskel.undo_img_normalization(chw, (0.4, 0.5, 0.6), (0.2,) * 3),
           jskel.undo_img_normalization(chw, (0.4, 0.5, 0.6), (0.2,) * 3))


def test_skeleton_without_cv2_raises_naming_the_function(monkeypatch):
    img, kp, names, conn = _skeleton_inputs()
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 fails
    with pytest.raises(ImportError, match="create_skel_img"):
        tskel.create_skel_img(img, kp[:, :2], conn)
    with pytest.raises(ImportError, match="keyp_target_to_image"):
        tskel.keyp_target_to_image(img, kp, "openpose25_v1")
    with pytest.raises(ImportError, match="create_bbox_img"):
        tskel.create_bbox_img(img, [1, 2, 3, 4])
    # the drawing-free helpers still run
    tskel.undo_img_normalization(img, 0.0, 1.0)


@pytest.mark.parametrize("channels", [3, 4])
def test_png_writer_matches_cv2(tmp_path, channels):
    rng = np.random.default_rng(6 + channels)
    arr = rng.integers(0, 256, size=(37, 53, channels), dtype=np.uint8)
    arr[:5] = 0  # a run the compressor shortens
    ours = tmp_path / "ours.png"
    theirs = tmp_path / "cv2.png"
    png.write_png(str(ours), arr)
    code = cv2.COLOR_RGBA2BGRA if channels == 4 else cv2.COLOR_RGB2BGR
    cv2.imwrite(str(theirs), cv2.cvtColor(arr, code))
    got = cv2.imread(str(ours), cv2.IMREAD_UNCHANGED)
    want = cv2.imread(str(theirs), cv2.IMREAD_UNCHANGED)
    assert got.shape == want.shape == (37, 53, channels)
    np.testing.assert_array_equal(got, want)
    back = cv2.COLOR_BGRA2RGBA if channels == 4 else cv2.COLOR_BGR2RGB
    np.testing.assert_array_equal(cv2.cvtColor(got, back), arr)
    with pytest.raises(ValueError, match="uint8"):
        png.encode_png(arr.astype(np.float32))
