"""Synthetic body-model assets (numpy; copy of the generator in
``shapy_tpu/models/body/assets.py``).

Copied rather than imported: importing ``shapy_tpu.models.body`` pulls in
jax, which the port never imports. ``tests/test_torch_core.py`` asserts
that these functions give arrays identical to the JAX package's.

The template is a body-proportioned ellipsoid, the skeleton a binary
tree of joints, and every basis a small smooth random field, all drawn
from ``seed``. ``exact_counts=True`` refines the mesh to the real
template's vertex and face counts (SMPL-X 10475 / 20908).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

NUM_JOINTS = {"smpl": 24, "smplh": 52, "smplx": 55}
SHAPE_SPACE_DIM = 300
EXPRESSION_SPACE_DIM = 100


def icosphere(subdivisions: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """Unit icosphere (vertices, faces) with consistent outward winding."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(subdivisions):
        # Vectorised midpoint subdivision: unique undirected edges get one
        # new vertex each; each face splits into four.
        e = np.concatenate(
            [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0
        )
        e_sorted = np.sort(e, axis=1)
        uniq, inverse = np.unique(e_sorted, axis=0, return_inverse=True)
        mids = verts[uniq[:, 0]] + verts[uniq[:, 1]]
        mids /= np.linalg.norm(mids, axis=1, keepdims=True)
        mid_idx = inverse.reshape(3, -1).T + len(verts)  # (F, 3): ab bc ca
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        ab, bc, ca = mid_idx[:, 0], mid_idx[:, 1], mid_idx[:, 2]
        faces = np.concatenate(
            [
                np.stack([a, ab, ca], axis=1),
                np.stack([b, bc, ab], axis=1),
                np.stack([c, ca, bc], axis=1),
                np.stack([ab, bc, ca], axis=1),
            ],
            axis=0,
        ).astype(np.int64)
        verts = np.concatenate([verts, mids], axis=0)
    return verts, faces


# The real template mesh sizes (reference body_models.py: SMPL 6890 verts /
# 13776 faces; SMPL-X 10475 / 20908 — SMPL-X is non-closed, 2V-4 != F).
REAL_MESH_COUNTS = {
    "smpl": (6890, 13776),
    "smplh": (6890, 13776),
    "smplx": (10475, 20908),
}


def refine_to_counts(
    verts: np.ndarray, faces: np.ndarray, target_v: int, target_f: int
) -> tuple[np.ndarray, np.ndarray]:
    """Refine a closed triangle mesh to EXACT (V, F) counts.

    Uniform subdivision quadruples face counts, so the real template
    sizes (e.g. SMPL-X 10475/20908) are unreachable by ``icosphere``
    alone. Splitting one edge adds 1 vertex and 2 faces; dropping a face
    afterwards adjusts F alone (legitimate: the real SMPL-X template is
    likewise non-closed). Splits run in rounds of pairwise-independent
    edges (no shared adjacent faces) so each round's midpoints are
    computed against a consistent topology. Deterministic.
    """
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    n_drop_final = faces.shape[0] + 2 * (target_v - verts.shape[0]) - target_f
    if target_v < verts.shape[0] or n_drop_final < 0:
        raise ValueError(
            f"cannot reach (V={target_v}, F={target_f}) from "
            f"({verts.shape[0]}, {faces.shape[0]}) by edge splits"
        )

    # Faces created by splitting (protected from the drop step below);
    # sized for the drop-only case where the while loop never runs.
    touched_new = np.zeros(faces.shape[0], dtype=bool)
    while verts.shape[0] < target_v:
        need = target_v - verts.shape[0]
        # Undirected edge -> (face, face) adjacency.
        e = np.concatenate(
            [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0
        )
        order = np.argsort(
            np.sort(e, axis=1)[:, 0] * (verts.shape[0] + 1)
            + np.sort(e, axis=1)[:, 1], kind="stable"
        )
        face_of = order % faces.shape[0]
        used = np.zeros(faces.shape[0], dtype=bool)
        chosen: list[tuple[int, int, int, int]] = []  # (a, b, f1, f2)
        for i in range(0, len(order) - 1, 2):
            if len(chosen) == need:
                break
            f1, f2 = int(face_of[i]), int(face_of[i + 1])
            if used[f1] or used[f2] or f1 == f2:
                continue
            a, b = (int(v) for v in np.sort(e[order[i]]))
            used[f1] = used[f2] = True
            chosen.append((a, b, f1, f2))
        if not chosen:
            raise ValueError("no independent edges left to split")

        new_faces = []
        drop = np.zeros(faces.shape[0], dtype=bool)
        mids = []
        for k, (a, b, f1, f2) in enumerate(chosen):
            m = verts.shape[0] + k
            mids.append(0.5 * (verts[a] + verts[b]))
            for fi in (f1, f2):
                tri = faces[fi]
                # Winding-preserving split: the edge appears as a cyclic
                # pair (p, q); emit (p, m, r) and (m, q, r).
                for j in range(3):
                    p, q = int(tri[j]), int(tri[(j + 1) % 3])
                    if {p, q} == {a, b}:
                        r = int(tri[(j + 2) % 3])
                        new_faces.append([p, m, r])
                        new_faces.append([m, q, r])
                        break
                drop[fi] = True
        verts = np.concatenate([verts, np.asarray(mids)], axis=0)
        faces = np.concatenate(
            [faces[~drop], np.asarray(new_faces, np.int64)], axis=0
        )
        # Carry protection across rounds: earlier rounds' split-created
        # faces stay protected, so a later drop step can never orphan a
        # previously inserted midpoint vertex.
        touched_new = np.concatenate(
            [touched_new[~drop], np.ones(len(new_faces), dtype=bool)]
        )

    n_drop = faces.shape[0] - target_f
    if n_drop:
        # Drop untouched faces in a band at ~87% height: between the
        # chest plane (0.72) and the head-top anchor (0.999) of
        # MeasurementAnchors.synthetic, so slices and anchors see an
        # intact surface.
        y = verts[faces].mean(axis=1)[:, 1]
        band = y.min() + 0.87 * (y.max() - y.min())
        score = np.abs(y - band) + np.where(touched_new, 1e9, 0.0)
        keep = np.ones(faces.shape[0], dtype=bool)
        keep[np.argsort(score, kind="stable")[:n_drop]] = False
        faces = faces[keep]
    assert verts.shape[0] == target_v and faces.shape[0] == target_f
    return verts, faces


def make_synthetic_model_data(
    model_type: str = "smplx",
    subdivisions: int = 2,
    seed: int = 0,
    num_shape_dirs: Optional[int] = None,
    exact_counts: bool = False,
) -> Dict[str, np.ndarray]:
    """Build a schema-compatible synthetic body model.

    The template is an ellipsoid (a closed, body-proportioned mesh so that
    volume / height / plane-slice measurements are well-defined), the
    skeleton is a star of chains hanging off a root, and all bases are
    small-magnitude smooth random fields so LBS outputs stay non-degenerate.

    ``exact_counts=True`` refines the mesh to the REAL template's exact
    vertex/face counts (:data:`REAL_MESH_COUNTS`, e.g. SMPL-X
    10475/20908) via :func:`refine_to_counts`, so benchmark shapes match
    the licensed assets exactly; ``subdivisions`` then sets the base
    mesh, which must not exceed the target (SMPL-X: 5, SMPL: 4).
    """
    rng = np.random.default_rng(seed)
    J = NUM_JOINTS[model_type]
    verts, faces = icosphere(subdivisions)
    if exact_counts:
        target_v, target_f = REAL_MESH_COUNTS[model_type]
        verts, faces = refine_to_counts(verts, faces, target_v, target_f)
    # Body-like proportions: ~0.35 m wide, ~1.7 m tall, ~0.25 m deep.
    verts = verts * np.array([0.35, 0.85, 0.25])
    V = verts.shape[0]

    shape_dim = SHAPE_SPACE_DIM
    if model_type == "smplx":
        shape_dim = SHAPE_SPACE_DIM + EXPRESSION_SPACE_DIM
    if num_shape_dirs is not None:
        shape_dim = num_shape_dirs
    # Smooth shape basis: low-frequency functions of the template coords.
    freqs = rng.normal(size=(3, shape_dim)) * 2.0
    phase = rng.uniform(0, 2 * np.pi, size=(shape_dim,))
    field = np.sin(verts @ freqs + phase)  # (V, S)
    dirs = rng.normal(size=(3, shape_dim)) * 0.01
    shapedirs = field[:, None, :] * dirs[None, :, :]  # (V, 3, S)

    P = 9 * (J - 1)
    posedirs = rng.normal(size=(V, 3, P)) * 1e-4

    # Chain skeleton: root at pelvis height, children along y.
    parents = np.zeros(J, dtype=np.int64)
    parents[0] = -1
    for j in range(1, J):
        parents[j] = (j - 1) // 2  # binary tree: depth ~ log2(J)

    # Joint regressor: each joint is a normalised weighting of nearby verts.
    joint_pos = rng.uniform(-0.5, 0.5, size=(J, 3)) * np.array([0.3, 0.8, 0.2])
    joint_pos[0] = 0.0
    d2 = ((verts[None, :, :] - joint_pos[:, None, :]) ** 2).sum(-1)
    J_regressor = np.exp(-d2 / 0.02)
    J_regressor /= J_regressor.sum(axis=1, keepdims=True)

    w = np.exp(-d2.T / 0.05)  # (V, J)
    weights = w / w.sum(axis=1, keepdims=True)

    kintree_table = np.stack(
        [parents, np.arange(J, dtype=np.int64)], axis=0
    )
    kintree_table[0, 0] = 2**32 - 1  # reference files use uint32 -1 at root

    data: Dict[str, Any] = {
        "v_template": verts.astype(np.float64),
        "shapedirs": shapedirs.astype(np.float64),
        "posedirs": posedirs.astype(np.float64),
        "J_regressor": J_regressor.astype(np.float64),
        "kintree_table": kintree_table,
        "weights": weights.astype(np.float64),
        "f": faces,
    }

    if model_type in ("smplh", "smplx"):
        ncomps = 45
        comps = rng.normal(size=(ncomps, ncomps)) * 0.1
        data["hands_componentsl"] = comps
        data["hands_componentsr"] = comps[::-1].copy()
        data["hands_meanl"] = rng.normal(size=(ncomps,)) * 0.05
        data["hands_meanr"] = rng.normal(size=(ncomps,)) * 0.05
    if model_type == "smplx":
        L = 51
        data["lmk_faces_idx"] = rng.integers(0, faces.shape[0], size=(L,))
        b = rng.uniform(size=(L, 3))
        data["lmk_bary_coords"] = b / b.sum(axis=1, keepdims=True)
        data["dynamic_lmk_faces_idx"] = rng.integers(
            0, faces.shape[0], size=(79, 17)
        )
        b = rng.uniform(size=(79, 17, 3))
        data["dynamic_lmk_bary_coords"] = b / b.sum(axis=-1, keepdims=True)
    return data
