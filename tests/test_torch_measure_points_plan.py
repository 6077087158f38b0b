"""K1-AoS's slice points (``measure_points``) and their backward
(``measure_points_backward``, ``csrc/measure.cu``) on the CPU: their plan
and their replays in plain PyTorch, against the plain slices and the JAX
package's.

``points_plan`` must cover every point float and mask byte once, with 16-
byte vectors where they are aligned, for any B and F (odd F and F % 8 !=
0 start rows off 16 bytes). ``measure_points_replay`` builds the output
tile by tile as the kernel does, from the plain saves
(``saved_points_plain``), and must be bit-equal to the plain slices'
layout (``plane_slice_reference`` / ``plane_slice_triangles``) at the same
plane heights, also with small tiles (many tiles a row, rows that end
inside a tile's vector), and agree with the JAX functions at the
``test_torch_measure_aos.py`` tolerance (1e-6 m: the same f32
operations). ``measure_points_backward_replay`` must match autograd
through the plain slice in f64 and ``jax.vjp`` of the JAX slice within
1e-5 of the largest gradient (f32 per-face sums of a few terms; the
plane heights' cotangent, a sum over every face, within 1e-5 of its
largest), and give nothing through a plane that walks no faces.

Bodies: the synthetic SMPL-X at subdivisions 1-2 (80 and 320 faces),
batch 2, seeded betas; hand-made triangles around three heights with F =
37 (odd) and 42 (F % 8 = 2); a body flattened onto one height (no plane
cuts it).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.ops import plane_slice as jslice
from shapy_tpu_torch.measure import MeasurementAnchors
from shapy_tpu_torch.measure import measurements as M
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
from shapy_tpu_torch.ops.plane_slice import (
    plane_slice_reference,
    plane_slice_triangles,
)

torch.set_num_threads(2)
MODES = ("reference", "exact")
SOURCE = Path(M.__file__).resolve().parents[1] / "csrc" / "measure.cu"


def _body(subdivisions: int, flat: bool = False):
    """Triangles (2, F, 3, 3) of seeded shaped bodies and their (2, 3)
    chest, waist and hips plane heights (the anchors' y)."""
    data = make_synthetic_model_data("smplx", subdivisions=subdivisions,
                                     seed=0)
    v_t = data["v_template"].astype(np.float32)
    dirs = data["shapedirs"][:, :, :10].astype(np.float32)
    betas = np.random.default_rng(subdivisions).normal(size=(2, 10)) * 1.5
    verts = (v_t[None] + np.einsum("bl,vkl->bvk", betas, dirs)).astype(
        np.float32)
    if flat:
        verts[1, :, 1] = verts[1, 0, 1]
    tri = torch.from_numpy(verts[:, data["f"]])
    anchors = MeasurementAnchors.synthetic(data["f"], v_t)
    heights = torch.stack([M._anchor_point(tri, getattr(anchors, n))[..., 1]
                           for n in M.PLANES], -1)
    return tri, heights


def _hand_made(F: int):
    """Seeded triangles (2, F, 3, 3) in [-0.8, 0.8]^2 around the heights
    0.0, 0.1, 0.2, with a vertex and an edge on the first plane."""
    rng = np.random.default_rng(F)
    tris = rng.uniform(-0.8, 0.8, size=(2, F, 3, 3)).astype(np.float32)
    tris[..., 1] = rng.uniform(-0.2, 0.4, size=(2, F, 3))
    tris[:, 1, 0, 1] = 0.0
    tris[:, 2, :2, 1] = 0.0
    heights = np.tile(np.float32([0.0, 0.1, 0.2]), (2, 1))
    return torch.from_numpy(tris), torch.from_numpy(heights)


CASES = {
    "smplx-1": lambda: _body(1),
    "smplx-2": lambda: _body(2),
    "odd-F": lambda: _hand_made(37),
    "F%8=2": lambda: _hand_made(42),
    "no-hit": lambda: _body(2, flat=True),
}


def _plain(tri, h, mode):
    fn = plane_slice_reference if mode == "reference" else \
        plane_slice_triangles
    return fn(tri, h)


# -- the plan ----------------------------------------------------------------


def test_plan_sizes_are_the_kernel_sources():
    """``points_plan``'s tiles are ``measure.cu``'s ``kPointsTile`` and
    ``kFaceTile`` (= ``kThreads``)."""
    text = SOURCE.read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = (\w+);", text).group(1)

    assert int(const("kPointsTile")) == M._POINTS_TILE
    assert const("kFaceTile") == "kThreads"
    assert int(const("kThreads")) == M._FACE_TILE
    plan = M.points_plan(32, 20908, "reference")
    assert plan.tiles == 21 and plan.grid == (21, 96)
    assert plan.face_grid == (82, 32) and plan.mask_row == 41816
    assert M.points_plan(32, 20908, "exact").mask_row == 20908


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B,F,tile", [
    (1, 1, 2048), (2, 7, 2048), (3, 1279, 2048), (2, 1278, 2048),
    (2, 20907, 2048), (1, 20908, 2048), (3, 37, 16), (2, 42, 6)])
def test_points_plan_covers_every_byte_once(B, F, tile, mode):
    """Every float of the (B, 3, 6F) points and every byte of the masks
    is in exactly one block's span, its vectors 16-byte aligned (4 floats,
    16 bytes) and its scalar head and tail shorter than a vector; every
    float of the (B, 3F, 3) triangles (and their gradient) in exactly one
    block of the backward."""
    plan = M.points_plan(B, F, mode, tile)
    assert plan.grid == (plan.tiles, 3 * B) and plan.tiles * tile >= 2 * F
    seen = {"points": np.zeros(B * 3 * 6 * F, np.int32),
            "masks": np.zeros(B * 3 * plan.mask_row, np.int32)}
    vec = {"points": 4, "masks": 16}
    for row in range(3 * B):
        for t in range(plan.tiles):
            for kind, (lo, A, E, hi) in M.points_spans(plan, F, row,
                                                       t).items():
                v = vec[kind]
                assert lo <= A <= E <= hi and A - lo < v and hi - E < v
                assert A == E or (A % v == 0 and E % v == 0)
                seen[kind][lo:hi] += 1
    for kind, counts in seen.items():
        assert (counts == 1).all(), kind
    faces = np.zeros(B * F * 9, np.int32)
    assert plan.face_grid == (-(-F // plan.face_tile), B)
    for b in range(B):
        for t in range(plan.face_grid[0]):
            lo, A, E, hi = M.face_spans(plan, F, b, t)
            assert A - lo < 4 and hi - E < 4
            assert A == E or (A % 4 == 0 and E % 4 == 0)
            faces[lo:hi] += 1
    assert (faces == 1).all()


# -- the forward's replay ----------------------------------------------------


@pytest.mark.parametrize("tile", [None, 16], ids=["kernel-tile", "tile-16"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", MODES)
def test_points_replay_matches_plain_and_jax(mode, case, tile):
    """``measure_points_replay`` on the plain saves: every walked row
    bit-equal to the plain slice at the same plane height (points and
    masks), the JAX slice within 1e-6 m with equal masks; a plane that
    walks no faces (the third, in a second call) keeps the fill and no
    mask."""
    tri, h = CASES[case]()
    B, F = tri.shape[:2]
    plan = None if tile is None else M.points_plan(B, F, mode, tile)
    for counts in ((F, F, F), (F, F, 0)):
        saved = M.saved_points_plain(tri, h, counts, mode)
        points, valid = M.measure_points_replay(saved, mode, plan)
        assert points.shape == (B, 3, 6 * F)
        for p in range(3):
            if counts[p] == 0:
                fill = torch.zeros((B, 2 * F, 3))
                if mode == "reference":
                    fill[..., 1] = h[:, p, None]
                assert torch.equal(points[:, p].view(B, 2 * F, 3), fill)
                assert not valid[:, p].any()
                continue
            want, want_mask = _plain(tri, h[:, p], mode)
            assert torch.equal(points[:, p].view(want.shape), want)
            assert torch.equal(valid[:, p], want_mask)
            jfn = (jslice.plane_slice_reference if mode == "reference"
                   else jslice.plane_slice_triangles)
            jpts, jmask = jfn(jnp.asarray(tri.numpy()),
                              jnp.asarray(h[:, p].numpy()))
            np.testing.assert_array_equal(valid[:, p].numpy(),
                                          np.asarray(jmask))
            np.testing.assert_allclose(points[:, p].view(want.shape).numpy(),
                                       np.asarray(jpts), atol=1e-6, rtol=0)
    hit_rows = valid.reshape(B, 3, -1).any(-1)[:, :2]
    assert bool(hit_rows.all()) == (case != "no-hit")


# -- the backward's replay ---------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", MODES)
def test_points_backward_replay_matches_autograd_and_jax(mode, case):
    """``measure_points_backward_replay`` of a seeded cotangent of all
    three planes' points (masked slots included): the triangles' gradient
    and the plane heights' cotangent against autograd through the plain
    slice in f64 (the plane heights as inputs) and ``jax.vjp`` of the JAX
    slice, within 1e-5 of the largest; with the second plane unwalked, its
    cotangent is ignored and its height gets none."""
    tri, h = CASES[case]()
    B, F = tri.shape[:2]
    g_points = torch.from_numpy(np.random.default_rng(3).normal(
        size=(B, 3, 6 * F)).astype(np.float32))
    saved = M.saved_points_plain(tri, h, (F, F, F), mode)
    grad, g_h = M.measure_points_backward_replay(saved, g_points, (F, F, F),
                                                 mode)
    grad = grad.view(B, F, 3, 3)
    x = tri.double().requires_grad_()
    hh = h.double().requires_grad_()
    loss = sum((_plain(x, hh[:, p], mode)[0].reshape(B, -1)
                * g_points[:, p].double()).sum() for p in range(3))
    want, want_h = torch.autograd.grad(loss, (x, hh))
    scale = float(want.abs().max())
    assert scale > 0
    torch.testing.assert_close(grad.double(), want, rtol=0,
                               atol=1e-5 * scale)
    torch.testing.assert_close(g_h.double(), want_h, rtol=0, atol=1e-5 * max(
        1.0, float(want_h.abs().max())))
    jfn = (jslice.plane_slice_reference if mode == "reference"
           else jslice.plane_slice_triangles)
    jt = jnp.asarray(tri.numpy())
    for p in range(3):
        _, vjp = jax.vjp(lambda t, hp: jfn(t, hp)[0], jt,
                         jnp.asarray(h[:, p].numpy()))
        jg, jh = vjp(jnp.asarray(
            g_points[:, p].numpy().reshape(_plain(tri, h[:, p], mode)[0]
                                           .shape)))
        jt_grad = jg if p == 0 else jt_grad + jg
        np.testing.assert_allclose(g_h[:, p].numpy(), np.asarray(jh),
                                   atol=1e-5 * max(1.0, float(
                                       np.abs(np.asarray(jh)).max())),
                                   rtol=0)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jt_grad),
                               atol=1e-5 * scale, rtol=0)
    counts = (F, 0, F)
    unwalked = M.saved_points_plain(tri, h, counts, mode)
    grad_u, g_h_u = M.measure_points_backward_replay(unwalked, g_points,
                                                     counts, mode)
    assert not g_h_u[:, 1].any()
    g_other = g_points.clone()
    g_other[:, 1] = 0
    assert torch.equal(grad_u, M.measure_points_backward_replay(
        unwalked, g_other, counts, mode)[0])
    torch.testing.assert_close(g_h_u[:, [0, 2]], g_h[:, [0, 2]], rtol=0,
                               atol=0)
