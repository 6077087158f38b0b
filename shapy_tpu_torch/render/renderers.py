"""Batch renderer classes on the host rasterizer (port of
``shapy_tpu/render/renderers.py``): ``OverlayRenderer`` (orthographic
weak-perspective camera), ``GTRenderer`` (intrinsics camera for
ground-truth meshes) and ``HDRenderer`` (perspective camera at the
original image resolution). All three return ``(B, 3[4], H, W)`` float
images in [0, 1], optionally alpha-composited over background images.

They run on :mod:`shapy_tpu_torch.render.rasterizer` (the native route):
Phong per-pixel normals, Blinn-Phong specular under the light rig,
optional vertex colors, and supersampled anti-aliasing (``HDRenderer``
defaults to 2x). Host numpy, bit-equal to the JAX package's classes."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from shapy_tpu_torch.render.rasterizer import (
    Material,
    _raster_fragments,
    render_mesh,
    shade_covered,
)

# Body colors: 'N' = neutral prediction, 'GT' = ground-truth green,
# 'stage_NN' = matplotlib's tab10 per-stage colors (hardcoded so that
# rendering needs no matplotlib).
_TAB10 = (
    (31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
    (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
    (188, 189, 34), (23, 190, 207),
)
COLORS = {
    "N": (1.0, 1.0, 0.9),
    "GT": (146 / 255.0, 189 / 255.0, 163 / 255.0),
    "pre_fusion": (81 / 255.0, 23 / 255.0, 186 / 255.0),
    "final": (0.4, 0.4, 0.8),
    "default": (1.0, 1.0, 0.9),
}
for _stage, (_r, _g, _b) in enumerate(_TAB10):
    COLORS[f"stage_{_stage:02d}"] = (_r / 255.0, _g / 255.0, _b / 255.0)


def _rotate_y(vertices: np.ndarray, deg: float) -> np.ndarray:
    """Rotate a mesh about the y axis through its centroid (the extra
    viewpoints of the summaries)."""
    if not deg:
        return vertices
    c = vertices.mean(axis=0, keepdims=True)
    a = np.radians(deg)
    rot = np.asarray([[np.cos(a), 0.0, np.sin(a)],
                      [0.0, 1.0, 0.0],
                      [-np.sin(a), 0.0, np.cos(a)]])
    return (vertices - c) @ rot.T + c


def _compose(rgb, alpha, bg, return_with_alpha):
    """(H, W, 3) + (H, W) over an optional (3[4], H, W) background ->
    (3[4], H, W): color * mask + (1 - mask) * bg."""
    rgb = np.transpose(rgb, (2, 0, 1)).astype(np.float32)
    a = alpha[None].astype(np.float32)
    if bg is None:
        out = np.concatenate([rgb * a, a], axis=0)
        return out if return_with_alpha else out[:3]
    bg = np.asarray(bg, np.float32)
    out = rgb * a + bg[:3] * (1.0 - a)
    if return_with_alpha:
        bga = bg[3:4] if bg.shape[0] >= 4 else np.ones_like(bg[:1])
        # over-composite: a fractional-coverage silhouette pixel over an
        # opaque background is opaque (a + bg_a * (1 - a))
        out_a = a + bga * (1.0 - a)
        return np.clip(np.concatenate([out, out_a], axis=0), 0, 1)
    return np.clip(out, 0, 1)


class AbstractRenderer:
    """Shared config: image size, material, supersampling."""

    def __init__(self, faces: Optional[np.ndarray] = None,
                 img_size: int = 224, supersample: int = 1,
                 material: Optional[Material] = None):
        self.faces = None if faces is None else np.asarray(faces, np.int64)
        self.img_size = int(img_size)
        self.supersample = int(supersample)
        self.material = material

    def _material(self, body_color) -> Material:
        if body_color is None and self.material is not None:
            return self.material
        color = COLORS["N"] if body_color is None else tuple(body_color)[:3]
        return Material(base_color=color)

    def _hw(self, bg_imgs, bidx) -> Tuple[int, int]:
        if bg_imgs is None:
            return self.img_size, self.img_size
        return bg_imgs[bidx].shape[-2], bg_imgs[bidx].shape[-1]


class OverlayRenderer(AbstractRenderer):
    """Orthographic weak-perspective batch overlays.

    Camera: NDC x = s * (x + tx) (or s * x + tx with ``scale_first``),
    mapped to pixels over the viewport; z only feeds the depth test."""

    def __call__(self, vertices, faces=None, camera_scale=None,
                 camera_translation=None, bg_imgs=None, deg: float = 0,
                 return_with_alpha: bool = False, body_color=None,
                 scale_first: bool = False, **kwargs) -> np.ndarray:
        vertices = np.asarray(vertices, np.float64)
        faces = self.faces if faces is None else np.asarray(faces, np.int64)
        scale = np.asarray(camera_scale, np.float64).reshape(len(vertices), -1)
        transl = np.asarray(
            camera_translation, np.float64).reshape(len(vertices), -1)
        mat = self._material(body_color)

        out = []
        for b in range(len(vertices)):
            H, W = self._hw(bg_imgs, b)
            v = _rotate_y(vertices[b], deg)
            s = float(scale[b, 0])
            tx, ty = float(transl[b, 0]), float(transl[b, 1])
            if scale_first:
                ndc_x = s * v[:, 0] + tx
                ndc_y = s * v[:, 1] + ty
            else:
                ndc_x = s * (v[:, 0] + tx)
                ndc_y = s * (v[:, 1] + ty)
            ss = max(self.supersample, 1)
            px = (ndc_x + 1.0) * 0.5 * W * ss
            py = (ndc_y + 1.0) * 0.5 * H * ss
            rgb, alpha = _ortho_shade(
                np.stack([px, py], 1), v, faces, H * ss, W * ss, mat)
            if ss > 1:
                rgb = rgb.reshape(H, ss, W, ss, 3).mean((1, 3))
                alpha = alpha.reshape(H, ss, W, ss).mean((1, 3))
            out.append(_compose(
                rgb, alpha, None if bg_imgs is None else bg_imgs[b],
                return_with_alpha))
        return np.stack(out, axis=0)


def _ortho_shade(pts, v, faces, H, W, material: Material,
                 vertex_colors: Optional[np.ndarray] = None):
    """Rasterize pre-projected screen points with orthographic shading
    (the view direction is the constant -z)."""
    z = v[:, 2] - v[:, 2].min() + 1.0  # depth test only
    pix, fid, bary, _ = _raster_fragments(pts, z, faces, H, W)
    rgb = np.zeros((H * W, 3))
    alpha = np.zeros(H * W)
    if pix.size:
        alpha[pix] = 1.0
        if vertex_colors is not None:
            vc = np.asarray(vertex_colors, np.float64).reshape(-1, 3)
            base = (bary[:, :, None] * vc[faces[fid]]).sum(1)
            base *= (1.0 - material.metallic)
        else:
            base = material.diffuse_color
        rgb[pix] = shade_covered(pix, fid, bary, v, faces, material, base,
                                 (1.0, 1.0), (0.0, 0.0), W, ortho=True)
    return rgb.reshape(H, W, 3), alpha.reshape(H, W)


class GTRenderer(AbstractRenderer):
    """Intrinsics-camera renderer for ground-truth meshes: per-sample
    K = [[fx, 0, cx], [0, fy, cy]], a GT-green body."""

    def __call__(self, vertices, faces=None, intrinsics=None, bg_imgs=None,
                 deg: float = 0, return_with_alpha: bool = False,
                 **kwargs) -> np.ndarray:
        vertices = np.asarray(vertices, np.float64)
        faces = self.faces if faces is None else np.asarray(faces, np.int64)
        K = np.asarray(intrinsics, np.float64).reshape(len(vertices), 3, 3)
        mat = self._material(COLORS["GT"])

        out = []
        for b in range(len(vertices)):
            H, W = self._hw(bg_imgs, b)
            v = _rotate_y(vertices[b], deg)
            rgb, alpha, _ = render_mesh(
                v, faces, (H, W),
                focal_length=(float(K[b, 0, 0]), float(K[b, 1, 1])),
                camera_center=(float(K[b, 0, 2]), float(K[b, 1, 2])),
                material=mat, supersample=max(self.supersample, 1))
            out.append(_compose(
                rgb, alpha, None if bg_imgs is None else bg_imgs[b],
                return_with_alpha))
        return np.stack(out, axis=0)


class HDRenderer(OverlayRenderer):
    """Full-resolution perspective overlays: per-sample focal length, the
    camera translation from ``weak_persp_to_blender``, and the SUBJECT's
    bbox center as the principal point. Anti-aliased by default
    (supersample=2)."""

    def __init__(self, faces: Optional[np.ndarray] = None,
                 img_size: int = 224, supersample: int = 2,
                 material: Optional[Material] = None):
        super().__init__(faces=faces, img_size=img_size,
                         supersample=supersample, material=material)

    def __call__(self, vertices, faces=None, focal_length=None,
                 camera_translation=None, camera_center=None, bg_imgs=None,
                 deg: float = 0, return_with_alpha: bool = False,
                 body_color=None, vertex_colors=None,
                 **kwargs) -> np.ndarray:
        vertices = np.asarray(vertices, np.float64)
        faces = self.faces if faces is None else np.asarray(faces, np.int64)
        B = len(vertices)
        fl = np.asarray(focal_length, np.float64).reshape(B, -1)
        transl = np.asarray(camera_translation, np.float64).reshape(B, 3)
        center = np.asarray(camera_center, np.float64).reshape(B, 2)
        mat = self._material(body_color)

        out = []
        for b in range(B):
            H, W = self._hw(bg_imgs, b)
            v = _rotate_y(vertices[b], deg) + transl[b][None]
            vc = None if vertex_colors is None else vertex_colors[b]
            rgb, alpha, _ = render_mesh(
                v, faces, (H, W), focal_length=float(fl[b, 0]),
                camera_center=center[b], material=mat,
                vertex_colors=vc, supersample=max(self.supersample, 1))
            out.append(_compose(
                rgb, alpha, None if bg_imgs is None else bg_imgs[b],
                return_with_alpha))
        return np.stack(out, axis=0)
