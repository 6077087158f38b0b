"""Software mesh rasterizer, host-side numpy (port of what
``rasterize_mesh`` needs of ``shapy_tpu/render/rasterizer.py``): the
light rig and material, vertex normals, the geometry pass and
``rasterize_mesh``'s three shading modes.

The geometry pass runs in the shared host C++
(``native/shapy_native.cpp:rasterize_fragments``) through the port's own
loader, :mod:`shapy_tpu_torch.io.native`, or, asked for by name, in numpy:
candidate pixels generated ragged per face bbox, barycentrics in one
shot, and the z-buffer resolved by one lexsort. Both routes keep the JAX
package's arithmetic, so each is bit-equal to the JAX package's route of
the same name. A native build that fails raises; the numpy route is never
taken in its place.

Not ported yet: ``render_mesh``, ``shade_covered`` and
``render_mesh_overlay`` (the lit RGB render and the overlay), with the
renderers and the skeleton drawing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from shapy_tpu_torch.io import native

DEFAULT_FOCAL_LENGTH = 5000.0


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
