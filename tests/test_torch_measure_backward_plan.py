"""The plan, lists and sum order of K1's and K1-exact's backward
(``csrc/measure.cu``: ``measure_backward_planes`` then
``measure_backward_vertices``), on the CPU.

``measure_backward_plan`` and ``vertex_corner_lists(..., others=True)``
are what the wrapper passes to the kernels. Here, from the shape alone:
the plan's CTAs a (body, plane), their words of the hit map and the
warps' groups of 32 hits cover every walk position and every hit slot
exactly once at B = 1, 32 and 48, on all faces, on the candidate subsets
and on K1-AoS's triangle view (V = 3F); the planes pass's shared memory
fits an H100 block (the kernel's ``constexpr`` constants read from the
source); the corner lists hold every (vertex, face, corner) once, in face
order, with the face's other two vertices. The hit map is built as the
kernel builds it (each CTA its words, 2 bits a position) and read as the
vertices pass reads it (the word's first hit plus the bits below): every
hit is found once, at its position.

``measure_backward_replay`` repeats the kernels' operations in their order
(each hit's chain, the warps' trees, the groups in order, the vertices'
entries in order) in PyTorch; on the card ``chip_smoke.py`` holds the
kernels to its bits. Here, on the forward's saves rebuilt from the plain
slice (``saved_forward_plain``), it is held against autograd through
``measure_plain`` with the same centroids and against ``jax.vjp`` of the
JAX package's ``forward_from_vertices``, in both slice modes, on all faces
and on the subsets, and with a centroid moved off the hits (the clamp and
the centroid's share at work) against autograd: 1e-5 of the largest
gradient (f32 on both sides, sums in another order). Shaped bodies from seeded betas (~1.5 sigma) on the
synthetic SMPL-X at ``subdivisions=3``, K = 128, and a body flattened to
one height, which leaves every plane without a hit.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapy_tpu.measure import measurements as jmeas
from shapy_tpu_torch.measure import measurements as meas
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data

torch.set_num_threads(2)
K = 128
KEYS = ("mass", "height") + meas.PLANES
CSRC = Path(__file__).resolve().parents[1] / "shapy_tpu_torch" / "csrc"
# An H100 block's shared memory at most, and the SMPL-X face count.
BLOCK_SMEM = 232448
F_SMPLX = 20908


def _constants() -> dict:
    """The file-scope ``constexpr int k...`` constants of ``measure.cu``
    that are integer expressions of those before them."""
    consts = {}
    text = (CSRC / "measure.cu").read_text()
    for decl in re.findall(r"^constexpr int (k\w+ *=[^;]+);", text, re.M):
        name, expr = (t.strip() for t in decl.split("=", 1))
        try:
            consts[name] = int(eval(expr.replace("/", "//"), {},
                                    dict(consts)))
        except (NameError, SyntaxError):
            pass
    return consts


CU = _constants()


def _backward_smem(words: int, blocks: int, half_k: int) -> int:
    """``backward_smem``: BwdShared (red[32]; dir, coef float4 and part_mx,
    part_mn, part_kx, part_kn of kMaxHalfK; pts of kChunk float2), the
    gather of the cluster's extremes (4 words a (rank, pair)) and a CTA's
    words (a mask and a first-hit index)."""
    shared = 4 * 32 + (2 * 16 + 4 * 4) * CU["kMaxHalfK"] + 8 * CU["kChunk"]
    return shared + blocks * half_k * 16 + -(-words // blocks) * 8


def test_kernel_constants_match_the_plan():
    assert CU["kGroup"] == meas._K1B_GROUP == 32
    assert CU["kWarps"] * 32 == CU["kPlaneThreads"] == meas._K1B_THREADS
    assert CU["kRecord"] == 9
    assert CU["kWordSpan"] == meas._K1B_WORD_SPAN == 16  # 2 bits each


# (counts, what): the fit's and training's walk (all faces), the served
# subsets (measure_plan's test sizes), K1-AoS with one and three planes.
WALKS = [((F_SMPLX,) * 3, "all faces"), ((960, 896, 768), "subsets"),
         ((F_SMPLX, 0, 0), "K1-AoS, one plane"),
         ((F_SMPLX,) * 3, "K1-AoS")]


@pytest.mark.parametrize("B", [1, 32, 48])
@pytest.mark.parametrize("counts,what", WALKS, ids=[w for _, w in WALKS])
def test_plan_covers_every_position_and_slot_once(B, counts, what):
    plan = meas.measure_backward_plan(counts, B)
    assert 1 <= plan.blocks <= meas._K1B_MAX_BLOCKS
    # rows leave SMs idle before a row takes a second CTA
    assert plan.blocks == 1 or 3 * B * plan.blocks <= meas._K1B_SMS
    cap = 2 * max(max(counts), 1)
    assert plan.records == min(cap, meas._K1B_RECORDS)
    warps = plan.blocks * CU["kWarps"]
    span = CU["kWordSpan"]
    for n_walk in counts:
        W = -(-n_walk // span)
        assert W <= plan.words
        wpb = -(-plan.words // plan.blocks)
        owned = np.zeros(W, int)
        for g in range(plan.blocks):  # the CTAs' word ranges
            w0 = min(W, g * wpb)
            owned[w0:min(W, w0 + wpb)] += 1
        np.testing.assert_array_equal(owned, 1)
        # every walk position in one word, 2 bits each
        pos = np.arange(n_walk)
        np.testing.assert_array_equal(
            np.bincount(pos // span, minlength=W),
            np.minimum(span, n_walk - span * np.arange(W)))
        # the most hits a row can hold (2 a face) in the groups, each
        # group taken by one warp of the row's CTAs, each slot once
        groups = -(-2 * n_walk // 32)
        assert groups <= plan.groups
        taken = np.zeros(groups, int)
        for g in range(plan.blocks):
            for w in range(CU["kWarps"]):
                taken[g * CU["kWarps"] + w::warps] += 1
        np.testing.assert_array_equal(taken, 1)
        slots = (np.arange(groups)[:, None] * 32 + np.arange(32)).ravel()
        assert (slots[:2 * n_walk] == np.arange(2 * n_walk)).all()
    # the cluster within the portable 8; shared memory at the most pairs
    assert plan.blocks <= 8
    assert _backward_smem(plan.words, plan.blocks,
                          CU["kMaxHalfK"]) <= BLOCK_SMEM


def test_plan_scratch_is_smaller_than_the_parents_at_the_train_batch():
    """The records, hit map, group sums and the fallback's pairs against
    the parent design's point cotangents (B, 3, 2F, 2) and slot map (B, 3,
    F) at batch 48 on all faces."""
    B, counts = 48, (F_SMPLX,) * 3
    plan = meas.measure_backward_plan(counts, B)
    rows = 3 * B
    now = rows * 4 * (plan.records * 9 + plan.words * 2 + plan.groups
                      + 8 * K + 4)
    parent = rows * 4 * (2 * F_SMPLX * 2 + F_SMPLX)
    assert now < parent / 2


@pytest.fixture(scope="module")
def body():
    data = make_synthetic_model_data("smplx", subdivisions=3, seed=0)
    v_t = data["v_template"].astype(np.float32)
    dirs = data["shapedirs"][:, :, :10].astype(np.float32)
    faces = data["f"]
    anchors = meas.MeasurementAnchors.synthetic(faces, v_t)
    janchors = jmeas.MeasurementAnchors.synthetic(faces, v_t)
    subsets = meas.candidate_faces(v_t, dirs, faces, anchors, pad_to=64)
    rng = np.random.default_rng(1)
    betas = rng.normal(size=(3, 10)).astype(np.float32) * 1.5
    verts = (v_t[None] + np.einsum("bl,vkl->bvk", betas, dirs)).astype(
        np.float32)
    verts[2, :, 1] = verts[2, 0, 1]  # flat: no plane has a hit
    g_vals = rng.normal(size=(3, 5)).astype(np.float32)
    g_heights = rng.normal(size=(3, 3)).astype(np.float32)
    return faces, anchors, janchors, subsets, verts, g_vals, g_heights


def _corner_lists_ok(faces, V):
    ptr, idx = meas.vertex_corner_lists(faces, V, others=True)
    assert idx.shape == (3 * len(faces), 4) and ptr[-1] == 3 * len(faces)
    seen = np.zeros((len(faces), 3), int)
    for v in range(V):
        ent = idx[ptr[v]:ptr[v + 1]]
        pos, c = ent[:, 0] >> 2, ent[:, 0] & 3
        assert (np.diff(pos) >= 0).all()  # face order
        np.testing.assert_array_equal(faces[pos, c], v)
        np.testing.assert_array_equal(ent[:, 1], faces[pos, (c + 1) % 3])
        np.testing.assert_array_equal(ent[:, 2], faces[pos, (c + 2) % 3])
        np.testing.assert_array_equal(ent[:, 3], 0)
        seen[pos, c] += 1
    np.testing.assert_array_equal(seen, 1)
    plain_ptr, plain_idx = meas.vertex_corner_lists(faces, V)
    np.testing.assert_array_equal(plain_ptr, ptr)
    np.testing.assert_array_equal(plain_idx, idx[:, 0])


def test_corner_lists_cover_every_corner_once(body):
    faces, anchors, _, subsets, *_ = body
    V = int(faces.max()) + 1
    _corner_lists_ok(faces, V)
    for sub in subsets.values():  # a plane's list: walk positions
        _corner_lists_ok(faces[sub], V)
    F = 40  # K1-AoS: the triangles as (3F, 3) vertices
    _corner_lists_ok(np.arange(3 * F).reshape(F, 3), 3 * F)


@pytest.mark.parametrize("slice_mode", ["reference", "exact"])
def test_hit_map_finds_every_hit_once(body, slice_mode):
    """The planes pass's words (each CTA ORs the bits of the hits at its
    words' positions, 16 a word: 01 the first at a position, 11 with a
    second, and takes the least hit index), read as the vertices pass
    reads them."""
    faces, anchors, _, _, verts, *_ = body
    tm = meas.BodyMeasurements(anchors, faces, K, slice_mode=slice_mode)
    _, codes, stats, _ = meas.saved_forward_plain(
        tm, torch.from_numpy(verts), False)
    F, span = faces.shape[0], CU["kWordSpan"]
    for blocks in (1, 3):
        words = -(-F // span)
        wpb = -(-words // blocks)
        for b in range(verts.shape[0]):
            for p in range(3):
                n = int(stats[b, p, 0])
                pos = (codes[b, p, :n] >> 4).numpy()
                mask = np.zeros(words, np.uint32)
                first = np.full(words, 2 ** 31 - 1)
                for g in range(blocks):
                    w0, w1 = min(words, g * wpb), min(words, g * wpb + wpb)
                    for j in range(n):
                        w = pos[j] // span
                        if w0 <= w < w1:
                            second = j > 0 and pos[j - 1] == pos[j]
                            mask[w] |= np.uint32(1) << np.uint32(
                                2 * (pos[j] % span) + second)
                            first[w] = min(first[w], j)
                found = []
                for f in range(F):
                    m, shift = int(mask[f // span]), 2 * (f % span)
                    there = bin((m >> shift) & 3).count("1")
                    j = first[f // span] + bin(m & ((1 << shift) - 1)).count(
                        "1")
                    found += [(f, j + t) for t in range(there)]
                assert found == [(pos[j], j) for j in range(n)]


def _jax_vjp(body, slice_mode, use_subsets, verts, g_vals, g_heights):
    faces, _, janchors, subsets, *_ = body
    jm = jmeas.BodyMeasurements(anchors=janchors, num_hull_directions=K,
                                slice_mode=slice_mode, face_subsets=subsets)

    def f(v):
        m = jm.forward_from_vertices(v, faces,
                                     use_face_subsets=use_subsets)
        m = m["measurements"]
        return (jnp.stack([m[k]["tensor"] for k in KEYS], axis=-1),
                jnp.stack([m[k]["plane_height"] for k in meas.PLANES],
                          axis=-1))

    _, vjp = jax.vjp(f, jnp.asarray(verts))
    return np.asarray(vjp((jnp.asarray(g_vals), jnp.asarray(g_heights)))[0])


@pytest.mark.parametrize("slice_mode,use_subsets", [
    ("reference", False), ("reference", True), ("exact", False),
    ("exact", True)], ids=["reference-all-faces", "reference-subsets",
                           "exact-all-faces", "exact-subsets"])
def test_replay_matches_autograd_and_jax_vjp(body, slice_mode, use_subsets):
    """The two shaped bodies (the flat one's height, |y(head) - y(heel)|
    at 0, has no gradient to compare)."""
    faces, anchors, _, subsets, verts, g_vals, g_heights = body
    verts, g_vals, g_heights = verts[:2], g_vals[:2], g_heights[:2]
    tm = meas.BodyMeasurements(anchors, faces, K, slice_mode=slice_mode,
                               face_subsets=subsets)
    v = torch.from_numpy(verts)
    cot = (torch.from_numpy(g_vals), torch.from_numpy(g_heights))
    saved = meas.saved_forward_plain(tm, v, use_subsets)
    assert int(saved[2][:, :3, 0].min()) >= 2
    got = meas.measure_backward_replay(tm, v, saved, cot, use_subsets)
    x = v.clone().requires_grad_()
    plane_faces = ([getattr(tm, f"subset_{n}") for n in meas.PLANES]
                   if use_subsets else None)
    want = torch.autograd.grad(meas.measure_plain(
        x, tm.faces, plane_faces, tm.anchors, K, tm.density, slice_mode,
        saved[2][:, :3, 1:3]), x, cot)[0]
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * scale)
    jax_grad = _jax_vjp(body, slice_mode, use_subsets, verts, g_vals,
                        g_heights)
    np.testing.assert_allclose(got.numpy(), jax_grad, rtol=0,
                               atol=1e-5 * float(np.abs(jax_grad).max()))


@pytest.mark.parametrize("slice_mode", ["reference", "exact"])
def test_replay_matches_autograd_off_centre(body, slice_mode):
    """Saves whose chest centroid is 1 m off the hits: the clamp max(h, 0)
    holds on about half the direction pairs and the centroid's share is
    large (for the hits' own centroid it is 0 but for rounding); the
    replay against autograd given the same centroids, 1e-5 of the
    largest gradient."""
    faces, anchors, _, _, verts, g_vals, g_heights = body
    tm = meas.BodyMeasurements(anchors, faces, K, slice_mode=slice_mode)
    v = torch.from_numpy(verts[:2])
    cot = (torch.from_numpy(g_vals[:2]), torch.from_numpy(g_heights[:2]))
    hits, codes, stats, plane_h = meas.saved_forward_plain(tm, v, False)
    stats[:, 0, 1] += 1.0
    got = meas.measure_backward_replay(tm, v, (hits, codes, stats, plane_h),
                                       cot, False)
    x = v.clone().requires_grad_()
    want = torch.autograd.grad(meas.measure_plain(
        x, tm.faces, None, tm.anchors, K, tm.density, slice_mode,
        stats[:, :3, 1:3]), x, cot)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("slice_mode", ["reference", "exact"])
def test_replay_gives_no_gradient_through_empty_planes(body, slice_mode):
    """The flat body has no hit: a cotangent on its circumferences alone
    gives it no gradient, as the plain version's."""
    faces, anchors, _, _, verts, g_vals, _ = body
    tm = meas.BodyMeasurements(anchors, faces, K, slice_mode=slice_mode)
    v = torch.from_numpy(verts)
    g = torch.from_numpy(g_vals) * torch.tensor([0.0, 0.0, 1.0, 1.0, 1.0])
    cot = (g, torch.zeros(3, 3))
    got = meas.measure_backward_replay(
        tm, v, meas.saved_forward_plain(tm, v, False), cot, False)
    np.testing.assert_array_equal(
        meas.saved_forward_plain(tm, v, False)[2][2, :3, 0].numpy(), 0)
    assert float(got[2].abs().max()) == 0.0
    assert float(got[:2].abs().max()) > 0.0
