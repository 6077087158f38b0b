"""Software mesh rasterizer, host-side numpy (port of
``shapy_tpu/render/rasterizer.py``): the light rig and material, vertex
normals, the geometry pass, ``rasterize_mesh``'s three shading modes, the
lit RGB render (``render_mesh``, Phong normals and Blinn-Phong specular,
supersampled), the overlay (``render_mesh_overlay``) and the
weak-perspective camera's translation (``weak_persp_to_blender``).

The geometry pass and the fragment shading run in the shared host C++
(``native/shapy_native.cpp``: ``rasterize_fragments``,
``shade_fragments``) through the port's own loader,
:mod:`shapy_tpu_torch.io.native`, or, asked for by name, in numpy: for
the geometry, candidate pixels generated ragged per face bbox,
barycentrics in one shot and the z-buffer resolved by one lexsort; for
the shading, :func:`_blinn_phong`. Both routes keep the JAX package's
arithmetic, so each is bit-equal to the JAX package's route of the same
name. A native build that fails raises; the numpy route is never taken in
its place. Rendering is host work, off the card, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from shapy_tpu_torch.io import native

DEFAULT_FOCAL_LENGTH = 5000.0


def weak_persp_to_blender(
    scale: np.ndarray,
    translation: np.ndarray,
    bbox_size: np.ndarray,
    focal_length: float = DEFAULT_FOCAL_LENGTH,
):
    """Weak-perspective (scale, transl) -> perspective camera translation
    (N, 3): z = 2 * focal / (scale * bbox_size)."""
    scale = np.asarray(scale).reshape(-1)
    translation = np.asarray(translation).reshape(-1, 2)
    bbox_size = np.asarray(bbox_size).reshape(-1)
    z = 2.0 * focal_length / (scale * bbox_size + 1e-9)
    return np.concatenate([translation, z[:, None]], axis=1)


# Pyrender-like rig: an ambient floor plus three directional lights
# (key / fill / back), matching the reference's raymond rig
# (plot_utils.py:391-419: three unit lights at theta=30deg,
# phi=0/120/240, mounted in the camera frame so the subject is
# front-lit). Directions are the light's direction of travel in OUR
# camera convention (camera at origin looking down +z, image y down):
# positive z = shining from the viewer side onto camera-facing surfaces.
_LIGHT_RIG = (
    ((0.4, 0.3, 0.8), 0.55),
    ((-0.5, 0.2, 0.6), 0.25),
    ((0.0, -0.6, 0.4), 0.20),
)
_AMBIENT = 0.30


class Material:
    """Metallic-roughness-style material (the pyrender
    MetallicRoughnessMaterial subset the reference instantiates:
    metallicFactor + baseColorFactor, plot_utils.py:440-443).

    Shading model: Lambert diffuse + Blinn-Phong specular with the
    standard dielectric F0=0.04 / metal F0=base_color split and a
    roughness->shininess mapping (2/r^4 - 2)."""

    def __init__(self, base_color=(0.65, 0.75, 0.95), metallic: float = 0.0,
                 roughness: float = 0.6):
        self.base_color = np.asarray(base_color, np.float64).reshape(3)
        self.metallic = float(metallic)
        self.roughness = float(np.clip(roughness, 0.08, 1.0))

    @property
    def shininess(self) -> float:
        return max(2.0 / self.roughness ** 4 - 2.0, 1.0)

    @property
    def diffuse_color(self) -> np.ndarray:
        return self.base_color * (1.0 - self.metallic)

    @property
    def specular_color(self) -> np.ndarray:
        f0 = np.full(3, 0.04)
        return f0 * (1.0 - self.metallic) + self.base_color * self.metallic


DEFAULT_MATERIAL = Material()


def _vertex_normals(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals."""
    tri = v[f]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    vn = np.zeros_like(v)
    for k in range(3):
        np.add.at(vn, f[:, k], fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)
    return vn


def _shade_normals(n: np.ndarray) -> np.ndarray:
    """Ambient + multi-directional Lambertian shading of unit normals."""
    s = np.full(n.shape[:-1], _AMBIENT)
    for direction, intensity in _LIGHT_RIG:
        d = np.asarray(direction, np.float64)
        d /= np.linalg.norm(d)
        s = s + intensity * np.clip(-(n @ d), 0.0, 1.0)
    return np.clip(s, 0.0, 1.0)


def _raster_fragments(pts: np.ndarray, z: np.ndarray, f: np.ndarray,
                      H: int, W: int, route: str = "native",
                      chunk_budget: int = 4_000_000):
    """Vectorized geometry pass.

    pts: (V, 2) screen coords, z: (V,) camera depths, f: (F, 3).
    Returns the nearest fragment per covered pixel:
    (pix flat indices (N,), face ids (N,), barycentrics (N, 3), z (N,)).

    Candidate pixels are generated RAGGED (exactly each face's clipped
    bbox, via the repeat/cumsum trick) rather than padded to a common
    grid, so the work is sum(bbox areas) with no aspect-ratio padding
    blowup; ``chunk_budget`` only bounds peak memory by slicing the flat
    candidate array.

    ``route`` 'native' runs the whole pass in the threaded C++ kernel
    (native/shapy_native.cpp:rasterize_fragments, same fragment
    semantics), built on first use, and raises if it cannot be built;
    'numpy' runs this numpy body, the oracle of the native route.
    """
    if route not in ("native", "numpy"):
        raise ValueError(f"rasterizer route must be native|numpy: {route}")
    if route == "native":
        fid_buf, bary_buf, depth_buf = native.rasterize_fragments(
            pts.astype(np.float32), z.astype(np.float32), f, H, W)
        pix = np.nonzero(fid_buf >= 0)[0]
        return (pix, fid_buf[pix].astype(np.int64),
                bary_buf[pix].astype(np.float64),
                depth_buf[pix].astype(np.float64))
    tri = pts[f]  # (F, 3, 2)
    xmin = np.clip(np.floor(tri[:, :, 0].min(1)).astype(np.int64), 0, W)
    xmax = np.clip(np.ceil(tri[:, :, 0].max(1)).astype(np.int64) + 1, 0, W)
    ymin = np.clip(np.floor(tri[:, :, 1].min(1)).astype(np.int64), 0, H)
    ymax = np.clip(np.ceil(tri[:, :, 1].max(1)).astype(np.int64) + 1, 0, H)
    bw = np.maximum(xmax - xmin, 0)
    bh = np.maximum(ymax - ymin, 0)
    # signed double-area of the screen triangle (degenerate -> skip)
    d = ((tri[:, 1, 1] - tri[:, 2, 1]) * (tri[:, 0, 0] - tri[:, 2, 0])
         + (tri[:, 2, 0] - tri[:, 1, 0]) * (tri[:, 0, 1] - tri[:, 2, 1]))
    live = (bw > 0) & (bh > 0) & (np.abs(d) > 1e-12)
    face_ids = np.nonzero(live)[0]
    if face_ids.size == 0:
        e = np.zeros(0, np.int64)
        return e, e, np.zeros((0, 3)), np.zeros(0)

    xmin, ymin = xmin[face_ids], ymin[face_ids]
    bw, bh = bw[face_ids], bh[face_ids]
    tri32 = tri[face_ids].astype(np.float32)
    d32 = d[face_ids].astype(np.float32)
    z32 = z.astype(np.float32)
    counts = bw * bh
    offsets = np.zeros(face_ids.size + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    total = int(offsets[-1])

    pix_all, fid_all, bary_all, z_all = [], [], [], []
    i = 0
    n_live = face_ids.size
    while i < n_live:
        # largest face range whose candidate count fits the budget
        # (a single face may exceed it and is then processed alone)
        j = int(np.searchsorted(offsets, offsets[i] + chunk_budget,
                                side="right")) - 1
        j = min(max(j, i + 1), n_live)
        cnt = counts[i:j]
        n = int(offsets[j] - offsets[i])
        # flat candidate id -> (local face, dy, dx), no padding
        fl = np.repeat(np.arange(j - i, dtype=np.int32), cnt)
        k = np.arange(n, dtype=np.int64) - (offsets[i:j] - offsets[i])[fl]
        bwf = bw[i:j][fl]
        cx = (xmin[i:j][fl] + k % bwf).astype(np.float32)
        cy = (ymin[i:j][fl] + k // bwf).astype(np.float32)
        t = tri32[i:j][fl]  # (N, 3, 2)
        dd = d32[i:j][fl]
        ex = cx - t[:, 2, 0]
        ey = cy - t[:, 2, 1]
        w0 = ((t[:, 1, 1] - t[:, 2, 1]) * ex
              + (t[:, 2, 0] - t[:, 1, 0]) * ey) / dd
        w1 = ((t[:, 2, 1] - t[:, 0, 1]) * ex
              + (t[:, 0, 0] - t[:, 2, 0]) * ey) / dd
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        i0 = i
        i = j
        if not inside.any():
            continue
        sel = np.nonzero(inside)[0]
        w0, w1, w2 = w0[sel], w1[sel], w2[sel]
        ids = face_ids[i0 + fl[sel].astype(np.int64)]
        zf = w0 * z32[f[ids, 0]] + w1 * z32[f[ids, 1]] + w2 * z32[f[ids, 2]]
        pix_all.append(cy[sel].astype(np.int64) * W
                       + cx[sel].astype(np.int64))
        fid_all.append(ids)
        bary_all.append(np.stack([w0, w1, w2], axis=1).astype(np.float64))
        z_all.append(zf.astype(np.float64))

    if not pix_all:
        e = np.zeros(0, np.int64)
        return e, e, np.zeros((0, 3)), np.zeros(0)
    pix = np.concatenate(pix_all)
    fid = np.concatenate(fid_all)
    bary = np.concatenate(bary_all)
    zc = np.concatenate(z_all)

    # z-buffer resolve: nearest fragment per pixel in one lexsort
    order = np.lexsort((zc, pix))
    pix_sorted = pix[order]
    first = np.ones(pix_sorted.size, bool)
    first[1:] = pix_sorted[1:] != pix_sorted[:-1]
    keep = order[first]
    return pix[keep], fid[keep], bary[keep], zc[keep]


def _rig_lights() -> np.ndarray:
    """The light rig as (L, 4) f32 rows: unit direction, intensity."""
    lights = []
    for d, inten in _LIGHT_RIG:
        d = np.asarray(d, np.float64)
        lights.append(list(d / np.linalg.norm(d)) + [inten])
    return np.asarray(lights, np.float32)


def shade_covered(pix, fid, bary, v, f, material, base, fxy, cc, W,
                  ortho=False, route: str = "native"):
    """Shade covered fragments: interpolated per-pixel normals +
    two-sided Blinn-Phong. ``base`` is (3,) or (N, 3) diffuse color.
    ``route`` 'native' runs the threaded C++ kernel
    (native/shapy_native.cpp:shade_fragments, f32) and raises if it
    cannot be built; 'numpy' runs :func:`_blinn_phong` in f64."""
    if route not in ("native", "numpy"):
        raise ValueError(f"rasterizer route must be native|numpy: {route}")
    vn = _vertex_normals(v, f)
    if route == "native":
        return native.shade_fragments(
            pix, fid, bary, vn, f, base, _rig_lights(),
            material.specular_color, material.shininess, _AMBIENT, fxy[0],
            fxy[1], cc[0], cc[1], W, ortho=ortho)
    n = (bary[:, :, None] * vn[f[fid]]).sum(1)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    if ortho:
        view = np.zeros((pix.size, 3))
        view[:, 2] = -1.0
    else:
        gy, gx = pix // W, pix % W
        view = -np.stack([(gx - cc[0]) / fxy[0], (gy - cc[1]) / fxy[1],
                          np.ones(pix.size)], axis=1)
        view /= np.linalg.norm(view, axis=1, keepdims=True)
    diff, spec = _blinn_phong(n, view, material)
    base = np.broadcast_to(np.asarray(base, np.float64), (pix.size, 3))
    return np.clip(base * diff[:, None] + spec, 0.0, 1.0)


def _blinn_phong(n: np.ndarray, view: np.ndarray,
                 material: Material) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pixel diffuse intensity and specular RGB under the light rig.

    n: (N, 3) unit normals, view: (N, 3) unit directions pixel->camera
    (i.e. -ray). Returns (diffuse (N,), specular (N, 3)).

    Two-sided: normals are flipped toward the viewer first, the
    rasterizer equivalent of the SKIP_CULL_FACES flag every reference
    render call sets (plot_utils.py:595-596) — shading is then
    independent of the mesh's face winding."""
    n = np.where(((n * view).sum(1) < 0)[:, None], -n, n)
    diff = np.full(n.shape[0], _AMBIENT)
    spec = np.zeros((n.shape[0], 3))
    shininess = material.shininess
    spec_color = material.specular_color
    for direction, intensity in _LIGHT_RIG:
        d = np.asarray(direction, np.float64)
        d /= np.linalg.norm(d)
        l = -d  # direction surface -> light
        ndotl = np.clip(n @ l, 0.0, 1.0)
        diff += intensity * ndotl
        h = l[None, :] + view
        h /= np.maximum(np.linalg.norm(h, axis=1, keepdims=True), 1e-12)
        ndoth = np.clip((n * h).sum(1), 0.0, 1.0)
        # mask the specular lobe to lit pixels
        s = intensity * np.power(ndoth, shininess) * (ndotl > 0)
        spec += s[:, None] * spec_color[None, :]
    return np.clip(diff, 0.0, 1.0), spec


def rasterize_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    image_size: Tuple[int, int],
    focal_length: float = DEFAULT_FOCAL_LENGTH,
    camera_center: Optional[np.ndarray] = None,
    light_dir: Tuple[float, float, float] = (0.3, 0.3, -1.0),
    shading_mode: str = "smooth",
    return_depth: bool = False,
    route: str = "native",
) -> Tuple[np.ndarray, ...]:
    """Perspective-project and z-buffer rasterise one mesh.

    vertices: (V, 3) in camera coordinates (+z away from camera);
    returns (shading (H, W) float, mask (H, W) bool), plus the raw
    z-buffer (H, W; +inf outside the mask) when ``return_depth``.
    shading_mode: 'smooth' interpolates per-vertex normals
    (Gouraud, pyrender-overlay look); 'flat' shades per face;
    'phong' interpolates normals per pixel (luminance of the lit
    default material). ``route``: the geometry pass's, 'native' (the C++
    kernel) or 'numpy' (see :func:`_raster_fragments`).
    """
    H, W = image_size
    if camera_center is None:
        camera_center = np.asarray([W / 2.0, H / 2.0])
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)

    z = np.maximum(v[:, 2], 1e-6)
    px = focal_length * v[:, 0] / z + camera_center[0]
    py = focal_length * v[:, 1] / z + camera_center[1]
    pts = np.stack([px, py], axis=1)

    pix, fid, bary, zsel = _raster_fragments(pts, z, f, H, W, route)

    color = np.zeros(H * W)
    depth = np.full(H * W, np.inf)
    depth[pix] = zsel

    if pix.size:
        if shading_mode == "flat":
            tri = v[f]
            n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
            n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
            light = np.asarray(light_dir, np.float64)
            light /= np.linalg.norm(light)
            shade = np.clip(-n @ light, 0.15, 1.0)
            color[pix] = shade[fid]
        elif shading_mode == "phong":
            vn = _vertex_normals(v, f)
            n = (bary[:, :, None] * vn[f[fid]]).sum(1)
            n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
            gy, gx = pix // W, pix % W
            view = -np.stack([(gx - camera_center[0]) / focal_length,
                              (gy - camera_center[1]) / focal_length,
                              np.ones(pix.size)], axis=1)
            view /= np.linalg.norm(view, axis=1, keepdims=True)
            diff, spec = _blinn_phong(n, view, DEFAULT_MATERIAL)
            # luminance of the lit grey material, spec folded in
            color[pix] = np.clip(diff + spec.mean(1), 0.0, 1.0)
        else:
            # two-sided like SKIP_CULL_FACES: orient normals toward the
            # camera (-z) so shading is independent of face winding
            vn = _vertex_normals(v, f)
            vn = np.where(vn[:, 2:3] > 0, -vn, vn)
            vert_shade = _shade_normals(vn)
            color[pix] = np.clip((bary * vert_shade[f[fid]]).sum(1), 0.0, 1.0)

    color = color.reshape(H, W)
    depth = depth.reshape(H, W)
    mask = np.isfinite(depth)
    if return_depth:
        return color, mask, depth
    return color, mask


def render_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    image_size: Tuple[int, int],
    focal_length: float = DEFAULT_FOCAL_LENGTH,
    camera_center: Optional[np.ndarray] = None,
    material: Optional[Material] = None,
    vertex_colors: Optional[np.ndarray] = None,
    supersample: int = 1,
    route: str = "native",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lit RGB render: per-pixel Phong normals + Blinn-Phong specular.

    Returns (rgb (H, W, 3) in [0, 1], alpha (H, W) in [0, 1],
    depth (H, W), +inf where empty). ``supersample`` > 1 renders at
    N x resolution and box-filters down (anti-aliased edges; alpha becomes
    fractional coverage). ``vertex_colors`` (V, 3) overrides the material
    base color per vertex. ``focal_length`` may be a scalar or an (fx, fy)
    pair (the intrinsics camera of ``GTRenderer``). ``route``: the
    geometry pass's and the shading's, 'native' or 'numpy'."""
    H, W = image_size
    ss = max(int(supersample), 1)
    if camera_center is None:
        camera_center = np.asarray([W / 2.0, H / 2.0])
    camera_center = np.asarray(camera_center, np.float64).reshape(2)
    material = material or DEFAULT_MATERIAL

    Hs, Ws = H * ss, W * ss
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    z = np.maximum(v[:, 2], 1e-6)
    fxy = np.broadcast_to(
        np.asarray(focal_length, np.float64).reshape(-1), (2,)).copy()
    fl = fxy * ss
    cc = camera_center * ss
    px = fl[0] * v[:, 0] / z + cc[0]
    py = fl[1] * v[:, 1] / z + cc[1]
    pts = np.stack([px, py], axis=1)

    pix, fid, bary, zsel = _raster_fragments(pts, z, f, Hs, Ws, route)

    rgb = np.zeros((Hs * Ws, 3))
    depth = np.full(Hs * Ws, np.inf)
    alpha = np.zeros(Hs * Ws)
    if pix.size:
        depth[pix] = zsel
        alpha[pix] = 1.0
        if vertex_colors is not None:
            vc = np.asarray(vertex_colors, np.float64).reshape(-1, 3)
            base = (bary[:, :, None] * vc[f[fid]]).sum(1)
            base *= (1.0 - material.metallic)
        else:
            base = material.diffuse_color
        rgb[pix] = shade_covered(pix, fid, bary, v, f, material, base,
                                 fl, cc, Ws, route=route)

    rgb = rgb.reshape(Hs, Ws, 3)
    alpha = alpha.reshape(Hs, Ws)
    depth = depth.reshape(Hs, Ws)
    if ss > 1:
        rgb = rgb.reshape(H, ss, W, ss, 3).mean((1, 3))
        alpha = alpha.reshape(H, ss, W, ss).mean((1, 3))
        # representative depth: min over the subpixel block (surface depth
        # where covered, +inf where the whole block is empty)
        depth = depth.reshape(H, ss, W, ss).min((1, 3))
    return rgb, alpha, depth


def render_mesh_overlay(
    image: np.ndarray,
    vertices: np.ndarray,
    faces: np.ndarray,
    transl: Optional[np.ndarray] = None,
    focal_length: float = DEFAULT_FOCAL_LENGTH,
    camera_center: Optional[np.ndarray] = None,
    color: Tuple[float, float, float] = (0.65, 0.75, 0.95),
    alpha: float = 0.9,
    shading_mode: str = "smooth",
    supersample: int = 1,
    material: Optional[Material] = None,
) -> np.ndarray:
    """Blend a shaded mesh over an RGB image (H, W, 3) -> f32 (H, W, 3).
    The camera's principal point is ``camera_center`` (cx, cy) in pixels,
    the subject's bbox centre where the caller has one, else the image
    centre. ``shading_mode='phong'`` (or a ``material``, or
    ``supersample`` > 1) takes the lit specular path of
    :func:`render_mesh`; otherwise :func:`rasterize_mesh`'s shading tints
    ``color``."""
    img = np.asarray(image, np.float32)
    H, W = img.shape[:2]
    v = np.asarray(vertices, np.float64)
    if transl is not None:
        v = v + np.asarray(transl).reshape(1, 3)
    cc = (None if camera_center is None
          else np.asarray(camera_center).reshape(2))
    out = img.copy()
    if shading_mode == "phong" or material is not None or supersample > 1:
        mat = material or Material(base_color=color)
        rgb, cov, _ = render_mesh(
            v, faces, (H, W), focal_length, camera_center=cc,
            material=mat, supersample=supersample)
        w = (alpha * cov)[..., None].astype(np.float32)
        return (1 - w) * out + w * rgb.astype(np.float32)
    shading, mask = rasterize_mesh(
        v, faces, (H, W), focal_length, camera_center=cc,
        shading_mode=shading_mode)
    tint = np.asarray(color, np.float32)[None, None] * shading[..., None]
    out[mask] = (1 - alpha) * out[mask] + alpha * tint[mask]
    return out
