"""Joint trees for the kinematic chain's tests (parents, -1 at the root).

The published SMPL, SMPL-H and SMPL-X kinematic trees (the order of the
models' ``kintree_table``), the synthetic SMPL-X tree that every run
without the licensed files uses (``models/body/assets.py``: a binary
tree), and the 64-joint extremes that K3-chain takes (a path of 64
levels, a star of one level).
"""

# pelvis; hips, spine1; knees, spine2; ankles, spine3; feet, neck,
# collars; head, shoulders; elbows; wrists
_BODY = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
         18, 19]
# five fingers of three joints under each wrist
_HANDS_FROM = lambda first, wrists: [  # noqa: E731
    p for w, start in zip(wrists, (first, first + 15))
    for f in range(5) for p in (w, start + 3 * f, start + 3 * f + 1)]

SMPL = _BODY + [20, 21]  # the hands: one joint under each wrist
SMPLH = _BODY + _HANDS_FROM(22, (20, 21))
# jaw and eyes under the head, then the hands: 11 levels, 5 children a wrist
SMPLX = _BODY + [15, 15, 15] + _HANDS_FROM(25, (20, 21))
SYNTHETIC_SMPLX = [-1] + [(j - 1) // 2 for j in range(1, 55)]
PATH64 = [-1] + list(range(63))
STAR64 = [-1] + [0] * 63

TREES = {"smpl": SMPL, "smplh": SMPLH, "smplx": SMPLX,
         "synthetic_smplx": SYNTHETIC_SMPLX, "path64": PATH64,
         "star64": STAR64}
