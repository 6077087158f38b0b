"""Keypoint format registry and cross-format remapping (a numpy copy of
``shapy_tpu/data/keypoints.py``, which the port may not import; a test
holds its name lists and index maps equal to the JAX package's).

Keypoint names are the lingua franca: every dataset annotates in some
source format, and ``keypoint_mapping(src, dst)`` produces index arrays
that remap (with zero-fill for missing targets) — used both to feed
network keypoint losses and to compare against model-native joints.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np

# --------------------------------------------------------------------------
# Name-block generators

FINGERS = ("thumb", "index", "middle", "ring", "pinky")


def _hand_joint_names(side: str) -> List[str]:
    """The 15 articulated hand joints in SMPL-H order (alphabetical by
    finger, 3 joints each: index, middle, pinky, ring, thumb)."""
    out = []
    for finger in ("index", "middle", "pinky", "ring", "thumb"):
        out += [f"{side}_{finger}{i}" for i in (1, 2, 3)]
    return out


def _openpose_hand_names(side: str) -> List[str]:
    """21 OpenPose hand keypoints: wrist + (3 joints + tip) per finger."""
    out = [f"{side}_wrist"]
    for finger in FINGERS:
        out += [f"{side}_{finger}{i}" for i in (1, 2, 3)]
        out += [f"{side}_{finger}"]
    return out


def _face_contour_names() -> List[str]:
    return (
        [f"right_contour_{i}" for i in range(1, 9)]
        + ["contour_middle"]
        + [f"left_contour_{i}" for i in range(8, 0, -1)]
    )


def _facial_landmark_names() -> List[str]:
    """The 51 inner facial landmarks in the 68-landmark ordering."""
    brows = (
        [f"right_eye_brow{i}" for i in range(1, 6)]
        + [f"left_eye_brow{i}" for i in range(5, 0, -1)]
    )
    nose = (
        [f"nose{i}" for i in range(1, 5)]
        + ["right_nose_2", "right_nose_1", "nose_middle", "left_nose_1",
           "left_nose_2"]
    )
    eyes = (
        [f"right_eye{i}" for i in range(1, 7)]
        + ["left_eye4", "left_eye3", "left_eye2", "left_eye1", "left_eye6",
           "left_eye5"]
    )
    mouth = [
        "right_mouth_1", "right_mouth_2", "right_mouth_3", "mouth_top",
        "left_mouth_3", "left_mouth_2", "left_mouth_1", "left_mouth_5",
        "left_mouth_4", "mouth_bottom", "right_mouth_4", "right_mouth_5",
    ]
    lips = [
        "right_lip_1", "right_lip_2", "lip_top", "left_lip_2", "left_lip_1",
        "left_lip_3", "lip_bottom", "right_lip_3",
    ]
    return brows + nose + eyes + mouth + lips


FACIAL_LANDMARKS = _facial_landmark_names() + _face_contour_names()

# --------------------------------------------------------------------------
# Model formats

SMPL_NAMES = [
    "pelvis", "left_hip", "right_hip", "spine1", "left_knee", "right_knee",
    "spine2", "left_ankle", "right_ankle", "spine3", "left_foot",
    "right_foot", "neck", "left_collar", "right_collar", "head",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hand", "right_hand",
]

SMPLH_NAMES = (
    SMPL_NAMES[:-2] + _hand_joint_names("left") + _hand_joint_names("right")
)

SMPLX_NAMES = (
    SMPL_NAMES[:-2]
    + ["jaw", "left_eye_smplx", "right_eye_smplx"]
    + _hand_joint_names("left")
    + _hand_joint_names("right")
    + FACIAL_LANDMARKS
)

# --------------------------------------------------------------------------
# OpenPose formats

FEET_NAMES = [
    "left_big_toe", "left_small_toe", "left_heel",
    "right_big_toe", "right_small_toe", "right_heel",
]

_OPENPOSE_BODY19 = [
    "nose", "neck",
    "right_shoulder", "right_elbow", "right_wrist",
    "left_shoulder", "left_elbow", "left_wrist",
    "pelvis",
    "right_hip", "right_knee", "right_ankle",
    "left_hip", "left_knee", "left_ankle",
    "right_eye", "left_eye", "right_ear", "left_ear",
]

_OPENPOSE_TAIL = (
    _openpose_hand_names("left")
    + _openpose_hand_names("right")
    + _face_contour_names()
    + _facial_landmark_names()
)

OPENPOSE19_NAMES = _OPENPOSE_BODY19 + _OPENPOSE_TAIL
OPENPOSE25_NAMES = _OPENPOSE_BODY19 + FEET_NAMES + _OPENPOSE_TAIL

COCO_NAMES = [
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip", "left_knee",
    "right_knee", "left_ankle", "right_ankle",
]

LSP_NAMES = [
    "right_ankle", "right_knee", "right_hip", "left_hip", "left_knee",
    "left_ankle", "right_wrist", "right_elbow", "right_shoulder",
    "left_shoulder", "left_elbow", "left_wrist", "neck", "head_top",
]

THREEDPW_NAMES = [
    "nose", "neck", "right_shoulder", "right_elbow", "right_wrist",
    "left_shoulder", "left_elbow", "left_wrist", "right_hip", "right_knee",
    "right_ankle", "left_hip", "left_knee", "left_ankle", "right_eye",
    "left_eye", "right_ear", "left_ear",
]

# The 24 "ground-truth" joints of the SPIN convention (reference
# SPIN_KEYPOINT_NAMES, keypoint_names.py): 14 LSP joints + MPII extras +
# H36M extras + face points.
SPIN_NAMES = [
    "right_ankle", "right_knee", "right_hip", "left_hip", "left_knee",
    "left_ankle", "right_wrist", "right_elbow", "right_shoulder",
    "left_shoulder", "left_elbow", "left_wrist", "neck", "head_top",
    "pelvis", "thorax", "spine", "h36m_jaw", "h36m_head", "nose",
    "left_eye", "right_eye", "left_ear", "right_ear",
]

# H36M's 24-joint evaluation convention: the SPIN list with the
# source-disambiguated names (reference H36M_NAMES).
H36M_NAMES = (
    SPIN_NAMES[:14]
    + ["pelvis_(mpii)", "thorax_(mpii)", "spine_(h36m)", "jaw_(h36m)",
       "head"]
    + SPIN_NAMES[19:]
)

# H36M's raw 17-joint skeleton (reference RAW_H36M_NAMES).
RAW_H36M_NAMES = [
    "pelvis", "left_hip", "left_knee", "left_ankle", "right_hip",
    "right_knee", "right_ankle", "spine", "neck", "neck/nose", "head",
    "left_shoulder", "left_elbow", "left_wrist", "right_shoulder",
    "right_elbow", "right_wrist",
]

_MPII_BODY = [
    "right_ankle", "right_knee", "right_hip", "left_hip", "left_knee",
    "left_ankle", "pelvis", "thorax", "upper_neck", "head_top",
    "right_wrist", "right_elbow", "right_shoulder", "left_shoulder",
    "left_elbow", "left_wrist",
]

_OPENPOSE_HANDS = (
    _openpose_hand_names("left") + _openpose_hand_names("right")
)

# MPII as shipped with hand annotations (reference MPII_KEYPOINT_NAMES).
MPII_NAMES = _MPII_BODY + _OPENPOSE_HANDS

# SPIN-X: SPIN body + OpenPose hands + contour-first face.
SPINX_NAMES = (
    SPIN_NAMES + _OPENPOSE_HANDS
    + _face_contour_names() + _facial_landmark_names()
)

# COCO whole-body (reference COCO_WHOLE_BODY_KEYPOINTS).
COCO_WHOLE_BODY_NAMES = (
    COCO_NAMES + FEET_NAMES + _OPENPOSE_HANDS
    + _face_contour_names() + _facial_landmark_names()
)

# CMU Panoptic (reference PANOPTIC_KEYPOINT_NAMES).
PANOPTIC_NAMES = (
    [
        "neck", "nose", "pelvis",
        "left_shoulder", "left_elbow", "left_wrist",
        "left_hip", "left_knee", "left_ankle",
        "right_shoulder", "right_elbow", "right_wrist",
        "right_hip", "right_knee", "right_ankle",
        "left_eye", "left_ear", "right_eye", "right_ear",
    ]
    + _OPENPOSE_HANDS
    + _facial_landmark_names() + _face_contour_names()
)

POSETRACK_NAMES = [
    "nose", "neck", "head_top", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle", "pelvis",
]

AICH_NAMES = [
    "right_shoulder", "right_elbow", "right_wrist",
    "left_shoulder", "left_elbow", "left_wrist",
    "right_hip", "right_knee", "right_ankle",
    "left_hip", "left_knee", "left_ankle",
    "head_top", "neck", "pelvis",
]

# OpenPose BODY_18 (no mid-hip/pelvis, reference OPENPOSE18_..._v1).
OPENPOSE18_NAMES = [n for n in _OPENPOSE_BODY19 if n != "pelvis"]


def _mano_names(side: str = "") -> List[str]:
    """MANO's 16 joints: wrist + 3 per finger, fingers alphabetical. With
    a side, the SMPL-H per-side block plus the wrist."""
    p = f"{side}_" if side else ""
    return [f"{p}wrist"] + [
        f"{p}{finger}{i}"
        for finger in ("index", "middle", "pinky", "ring", "thumb")
        for i in (1, 2, 3)
    ]


def _finger_tips(side: str = "") -> List[str]:
    p = f"{side}_" if side else ""
    return [f"{p}{finger}" for finger in FINGERS]


MANO_NAMES = _mano_names()
HO3D_NAMES = MANO_NAMES + _finger_tips()


def _youtube3d_hand_names(side: str) -> List[str]:
    return _mano_names(side) + _finger_tips(side)


def _interhand_names(side: str) -> List[str]:
    out = []
    for finger in FINGERS:
        out += [f"{side}_{finger}"] + [
            f"{side}_{finger}{i}" for i in (3, 2, 1)
        ]
    return out + [f"{side}_wrist"]


# FLAME's 5 joints + 68 landmarks, inner-face first (reference
# FLAME_KEYPOINT_NAMES; FFHQ annotates the same set).
FLAME_NAMES = (
    ["global", "neck", "jaw", "left_eye", "right_eye"]
    + _facial_landmark_names() + _face_contour_names()
)

# 68-landmark face-only sets, contour first (reference VGGFACE2_NAMES).
VGGFACE2_NAMES = _face_contour_names() + _facial_landmark_names()


def _smplx_extra_names() -> List[str]:
    """The OpenPose-style landmark tail appended to the 55 SMPL-X joints
    in the model's 144-keypoint output (reference EHF_KEYPOINTS[55:])."""
    return (
        ["nose", "right_eye", "left_eye", "right_ear", "left_ear"]
        + FEET_NAMES
        + _finger_tips("left") + _finger_tips("right")
    )


EHF_NAMES = SMPLX_NAMES[:55] + _smplx_extra_names() + FACIAL_LANDMARKS

# AGORA's SMPL-X fits: same layout, SMPL-H/F eye names, no contour
# (reference AGORA_NAMES).
AGORA_NAMES = (
    SMPLX_NAMES[:23]
    + ["left_eye_smplhf", "right_eye_smplhf"]
    + SMPLX_NAMES[25:55]
    + _smplx_extra_names()
    + _facial_landmark_names()
)

KEYPOINT_NAMES_DICT: Dict[str, List[str]] = {
    "smpl": SMPL_NAMES,
    "smplh": SMPLH_NAMES,
    "smplx": SMPLX_NAMES,
    "mano": MANO_NAMES,
    "mano-from-smplx": SMPLX_NAMES,
    "flame-from-smplx": SMPLX_NAMES,
    "flame": FLAME_NAMES,
    "openpose18_v1": OPENPOSE18_NAMES,
    "openpose19_v1": OPENPOSE19_NAMES,
    "openpose25_v1": OPENPOSE25_NAMES,
    "mpii": MPII_NAMES,
    "ffhq": FLAME_NAMES,
    "ehf": EHF_NAMES,
    "coco": COCO_NAMES,
    "whole-coco": COCO_WHOLE_BODY_NAMES,
    "3dpw": THREEDPW_NAMES,
    "posetrack": POSETRACK_NAMES,
    "aich": AICH_NAMES,
    "spin": SPIN_NAMES,
    "spinx": SPINX_NAMES,
    "panoptic": PANOPTIC_NAMES,
    "freihand-left": _openpose_hand_names("left"),
    "freihand-right": _openpose_hand_names("right"),
    "lsp": LSP_NAMES,
    "raw_h36m": RAW_H36M_NAMES,
    "h36m": H36M_NAMES,
    "mtc-right": _openpose_hand_names("right"),
    "mtc-left": _openpose_hand_names("left"),
    "ho3d": HO3D_NAMES,
    "vggface2": VGGFACE2_NAMES,
    "ethnicity": VGGFACE2_NAMES,
    "youtube3d-hand-right": _youtube3d_hand_names("right"),
    "youtube3d-hand-left": _youtube3d_hand_names("left"),
    "interhand26m-right": _interhand_names("right"),
    "interhand26m-left": _interhand_names("left"),
    "agora": AGORA_NAMES,
    # Our extension: the 49-joint layout SPIN npz archives store
    # (25 OpenPose body joints + the 24 GT joints). Not in the reference
    # registry, which only names the GT block ('spin').
    "spin49": _OPENPOSE_BODY19[:19] + FEET_NAMES + SPIN_NAMES,
}


def model_keypoint_names(name: str, use_face_contour: bool = True
                         ) -> List[str]:
    names = list(KEYPOINT_NAMES_DICT[name])
    if not use_face_contour:
        names = [n for n in names if "contour" not in n]
    return names


# --------------------------------------------------------------------------
# Part assignment (reference KEYPOINT_PARTS, keypoint_names.py:22-167),
# expressed as rules + exceptions.

PART_NAMES = ("body", "left_hand", "right_hand", "face", "head", "upper",
              "torso")

_HEADISH = {"nose", "right_eye", "left_eye", "right_ear", "left_ear",
            "jaw", "left_eye_smplx", "right_eye_smplx"}
_TORSO_UPPER = {
    "spine2", "spine3", "left_collar", "right_collar", "left_shoulder",
    "right_shoulder", "left_elbow", "right_elbow",
}


# Names the reference's KEYPOINT_PARTS table simply does not list (they
# belong to no part): H36M/MPII bookkeeping joints, SMPL fingertip stubs,
# FLAME's root, AGORA's eye naming, and the side-less MANO joints.
_UNASSIGNED = {
    "left_hand", "right_hand", "thorax", "spine", "h36m_jaw", "h36m_head",
    "upper_neck", "neck/nose", "global", "left_eye_smplhf",
    "right_eye_smplhf", "pelvis_(mpii)", "thorax_(mpii)", "spine_(h36m)",
    "jaw_(h36m)",
}


def keypoint_parts(name: str) -> Tuple[str, ...]:
    """Parts a keypoint belongs to."""
    if name in _UNASSIGNED:
        return ()
    if name in ("pelvis", "left_hip", "right_hip", "spine1"):
        return ("body", "torso")
    if name == "neck":
        return ("body", "head", "face", "torso", "upper")
    if name in ("head", "head_top"):
        return ("body", "head", "torso", "upper")
    if name in _HEADISH:
        return ("body", "torso", "upper", "head")
    if name in _TORSO_UPPER:
        return ("body", "torso", "upper")
    if name in ("left_wrist", "right_wrist"):
        return ("body", "hand")
    if "contour" in name or any(
        p in name for p in ("brow", "nose", "eye", "mouth", "lip")
    ):
        return ("face", "torso", "upper", "head")
    if any(
        name.startswith(f"{side}_{f}")
        for side in ("left", "right") for f in FINGERS
    ):
        return ("hand",)
    # knees, ankles, feet, toes, heels
    if any(
        name.endswith(s)
        for s in ("_knee", "_ankle", "_big_toe", "_small_toe", "_heel",
                  "_foot")
    ):
        return ("body",)
    # Everything else (side-less MANO joints, dataset bookkeeping joints)
    # is part-less, matching the reference table's omissions.
    return ()


@lru_cache(maxsize=None)
def get_part_idxs(fmt: str) -> Dict[str, np.ndarray]:
    """Part name -> indices into the format's keypoint list. 'left_hand' /
    'right_hand' split the generic 'hand' part by side; wrists belong to
    both hands and the body (reference get_part_idxs semantics)."""
    names = KEYPOINT_NAMES_DICT[fmt]
    out: Dict[str, List[int]] = {p: [] for p in PART_NAMES}
    for i, n in enumerate(names):
        parts = keypoint_parts(n)
        for p in parts:
            if p == "hand":
                side = "left" if n.startswith("left") else "right"
                out[f"{side}_hand"].append(i)
            elif p in out:
                out[p].append(i)
    return {k: np.asarray(v, dtype=np.int64) for k, v in out.items()}


# --------------------------------------------------------------------------
# Connections (skeleton edges) — generated blocks + explicit body edges
# (reference KEYPOINT_CONNECTIONS, keypoint_names.py:179-354).


def _connections() -> List[Tuple[str, str]]:
    edges = [
        ("pelvis", "spine1"), ("spine1", "spine2"), ("spine2", "spine3"),
        ("spine3", "left_collar"), ("spine3", "right_collar"),
        ("left_collar", "left_shoulder"), ("right_collar", "right_shoulder"),
        ("spine3", "neck"), ("neck", "head"), ("head", "head_top"),
        ("left_eye", "nose"), ("right_eye", "nose"),
        ("right_eye", "right_ear"), ("left_eye", "left_ear"),
        ("left_shoulder", "left_elbow"), ("left_elbow", "left_wrist"),
        ("right_shoulder", "right_elbow"), ("right_elbow", "right_wrist"),
        ("left_wrist", "left_hand"), ("right_wrist", "right_hand"),
        ("pelvis", "left_hip"), ("pelvis", "right_hip"),
        ("neck", "left_shoulder"), ("neck", "right_shoulder"),
        ("neck", "nose"),
    ]
    for side in ("left", "right"):
        edges += [
            (f"{side}_hip", f"{side}_knee"),
            (f"{side}_knee", f"{side}_ankle"),
            (f"{side}_ankle", f"{side}_heel"),
            (f"{side}_ankle", f"{side}_big_toe"),
            (f"{side}_ankle", f"{side}_small_toe"),
        ]
        for finger in FINGERS:
            chain = [f"{side}_wrist"] + [
                f"{side}_{finger}{i}" for i in (1, 2, 3)
            ] + [f"{side}_{finger}"]
            edges += list(zip(chain[:-1], chain[1:]))
    return edges


KEYPOINT_CONNECTIONS = _connections()


def connections_for_names(
    names: Sequence[str],
) -> Tuple[Tuple[int, int], ...]:
    """Skeleton edges as index pairs for an ARBITRARY name list (e.g. a
    model head's target keypoint order) — the generic form of
    :func:`kp_connections`."""
    index = {n: i for i, n in enumerate(names)}
    return tuple(
        (index[a], index[b])
        for a, b in KEYPOINT_CONNECTIONS
        if a in index and b in index
    )


@lru_cache(maxsize=None)
def kp_connections(fmt: str, part: str = "") -> Tuple[Tuple[int, int], ...]:
    names = KEYPOINT_NAMES_DICT[fmt]
    index = {n: i for i, n in enumerate(names)}
    part_idx = None
    if part:
        part_idx = set(get_part_idxs(fmt)[part].tolist())
    out = []
    for a, b in KEYPOINT_CONNECTIONS:
        if a in index and b in index:
            ia, ib = index[a], index[b]
            if part_idx is not None and (
                ia not in part_idx or ib not in part_idx
            ):
                continue
            out.append((ia, ib))
    return tuple(out)


# --------------------------------------------------------------------------
# Flip pairs (horizontal mirroring)


@lru_cache(maxsize=None)
def flip_pairs(fmt: str) -> Tuple[Tuple[int, int], ...]:
    """Positional left/right pairs. Formats may repeat a name (OpenPose
    lists the wrists in both the body and hand blocks), so the k-th
    occurrence of ``left_x`` pairs with the k-th occurrence of
    ``right_x``."""
    names = KEYPOINT_NAMES_DICT[fmt]
    occurrences: Dict[str, List[int]] = {}
    for i, n in enumerate(names):
        occurrences.setdefault(n, []).append(i)
    pairs = []
    for n, left_positions in occurrences.items():
        if not n.startswith("left"):
            continue
        mirrored = "right" + n[len("left"):]
        right_positions = occurrences.get(mirrored, [])
        for li, ri in zip(left_positions, right_positions):
            pairs.append((li, ri))
    return tuple(sorted(pairs))


def flip_permutation(fmt: str) -> np.ndarray:
    names = KEYPOINT_NAMES_DICT[fmt]
    perm = np.arange(len(names))
    for i, j in flip_pairs(fmt):
        perm[i], perm[j] = j, i
    return perm


# --------------------------------------------------------------------------
# Cross-format remapping (reference map_keypoints, utils/keypoints.py:123+)


def mapping_between(src_names: Sequence[str], dst_names: Sequence[str]
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Index arrays (src_idx, dst_idx) between two explicit name lists."""
    src_index: Dict[str, int] = {}
    for i, n in enumerate(src_names):
        src_index.setdefault(n, i)
    src_idx, dst_idx = [], []
    for j, n in enumerate(dst_names):
        if n in src_index:
            src_idx.append(src_index[n])
            dst_idx.append(j)
    return np.asarray(src_idx, np.int64), np.asarray(dst_idx, np.int64)


@lru_cache(maxsize=None)
def keypoint_mapping(src: str, dst: str) -> Tuple[np.ndarray, np.ndarray]:
    """Index arrays (src_idx, dst_idx): dst[dst_idx] = src[src_idx] for
    every name present in both formats (first occurrence wins)."""
    src_names = KEYPOINT_NAMES_DICT[src]
    dst_names = KEYPOINT_NAMES_DICT[dst]
    src_index: Dict[str, int] = {}
    for i, n in enumerate(src_names):
        src_index.setdefault(n, i)
    src_idx, dst_idx = [], []
    for j, n in enumerate(dst_names):
        if n in src_index:
            src_idx.append(src_index[n])
            dst_idx.append(j)
    return np.asarray(src_idx, np.int64), np.asarray(dst_idx, np.int64)


def map_keypoints(
    keypoints: np.ndarray,
    src: str,
    dst: str,
    conf: "np.ndarray | None" = None,
):
    """Remap (..., N_src, D) keypoints to (..., N_dst, D), zero-filling
    missing targets. Returns (mapped, mapped_conf_or_None)."""
    src_idx, dst_idx = keypoint_mapping(src, dst)
    n_dst = len(KEYPOINT_NAMES_DICT[dst])
    out = np.zeros(keypoints.shape[:-2] + (n_dst, keypoints.shape[-1]),
                   dtype=keypoints.dtype)
    out[..., dst_idx, :] = keypoints[..., src_idx, :]
    out_conf = None
    if conf is not None:
        out_conf = np.zeros(conf.shape[:-1] + (n_dst,), dtype=conf.dtype)
        out_conf[..., dst_idx] = conf[..., src_idx]
    return out, out_conf


def pose_flip_permutation(num_joints: int) -> np.ndarray:
    """Left<->right joint permutation for SMPL-family AXIS-ANGLE poses.

    Mirroring a body pose = permute each joint's rotation to its
    bilateral partner and negate the y/z axis-angle components (the
    standard SMPL flip; reference datasets flip poses through their
    structure objects). Accepts the three model joint counts (and 22 =
    SMPL-X body-only slice).
    """
    base = {24: "smpl", 52: "smplh", 55: "smplx", 22: "smplx"}
    if num_joints not in base:
        raise ValueError(
            f"no pose flip table for {num_joints} joints "
            "(expected 22/24/52/55)")
    names = list(KEYPOINT_NAMES_DICT[base[num_joints]][:num_joints])

    def swap(n: str) -> str:
        if n.startswith("left_"):
            return "right_" + n[5:]
        if n.startswith("right_"):
            return "left_" + n[6:]
        return n

    return np.asarray([names.index(swap(n)) for n in names])


def flip_pose_aa(pose: np.ndarray) -> np.ndarray:
    """Mirror a (J, 3) / (J*3,) axis-angle pose left<->right."""
    flat = np.asarray(pose, np.float32)
    shape = flat.shape
    aa = flat.reshape(-1, 3)
    perm = pose_flip_permutation(aa.shape[0])
    aa = aa[perm].copy()
    aa[:, 1:] *= -1.0
    return aa.reshape(shape)
