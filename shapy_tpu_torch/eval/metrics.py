"""Evaluation metrics and alignments (port of ``shapy_tpu/eval/metrics.py``).

Plain functions on tensors with the JAX package's layouts: ``(B, P, 3)``
point sets, ``(P, K)`` padded regressor rows. Three kernels carry the
metrics on the card:

  * K8b (``csrc/align_error.cu``) — :func:`aligned_point_error`, any of
    the alignments below followed by :func:`point_error`, behind
    :class:`PointError`;
  * K8a (``csrc/point_regress.cu``) — :func:`point_regress_error`, the
    P2P-20k error of :class:`SparsePointRegressor`;
  * K9 (``csrc/nn_dists.cu``) — :func:`_nn_dists`, each point's distance
    to its nearest neighbour in the other cloud, twice per
    :func:`point_fscore`.

Each wrapper runs its plain version (``*_plain``) for CPU tensors and
launches its kernel, or raises, for CUDA tensors. The alignment functions
themselves are plain PyTorch on every device (``procrustes_align`` uses
``torch.linalg.svd`` like the JAX code).
"""

from __future__ import annotations

import copy
import functools
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from shapy_tpu_torch.utils.cuda_kernels import (
    CudaKernel,
    check_cuda_input,
    check_no_grad,
)
from shapy_tpu_torch.utils.device import get_device
from shapy_tpu_torch.utils.vec3 import dot3

ALIGN_KERNEL = CudaKernel("align_error.cu",
                          {"align_error_forward": "pppp iiii p"})
REGRESS_KERNEL = CudaKernel("point_regress.cu",
                            {"point_regress_forward": "pppppppp iiiiiii p"})
_REGRESS_TILE = 256  # points per block of csrc/point_regress.cu
NN_KERNEL = CudaKernel("nn_dists.cu", {"nn_dists_forward": "ppppp iii p"})
_NN_THREADS = 256  # query points per block of csrc/nn_dists.cu
_NN_BLOCKS_PER_SM = 8  # blocks to aim for, per SM of the card
_NN_MIN_SPAN = 512  # fewest points of b per range


@functools.lru_cache(maxsize=None)
def _nn_target_blocks(index: int) -> int:
    """K9's blocks to aim for on CUDA device ``index``."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return _NN_BLOCKS_PER_SM * sms


# -- point errors -----------------------------------------------------------


def point_error(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-point Euclidean error, (..., P, 3) -> (..., P)."""
    return torch.sqrt(torch.sum((pred - gt) ** 2, dim=-1))


def nn_dists_plain(a: torch.Tensor, b: torch.Tensor, chunk: int = 2048
                   ) -> torch.Tensor:
    """Plain version of K9: for each point of a (N, 3), the distance to its
    nearest neighbour in b (M, 3). The neighbour is the argmin (first index
    on ties) of the f32 expansion |a|^2 - 2 a.b + |b|^2 over (chunk, M)
    tiles; the expansion cancels near zero, so the chosen neighbour's
    distance is then recomputed from the coordinate difference. The JAX
    package takes a.b as a matmul; here every dot is summed x, then y,
    then z, the kernel's order, so that the two pick the same neighbour
    where two candidates' expansions tie within f32 rounding (a
    matmul's FMAs round those differently)."""
    b_sq = dot3(b, b)
    out = []
    for s in range(0, a.shape[0], chunk):
        ac = a[s:s + chunk]
        ab = dot3(ac[:, None, :], b[None])
        d2 = dot3(ac, ac)[:, None] - 2.0 * ab + b_sq[None]
        diff = ac - b[torch.argmin(d2, dim=-1)]
        out.append(dot3(diff, diff))
    d2 = torch.cat(out) if out else a.new_zeros((0,))
    return torch.sqrt(torch.clamp(d2, min=0.0))


def _nn_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour distances (N,) from a (N, 3) to b (M, 3): the
    plain version for CPU tensors, kernel K9 for CUDA tensors (forward
    only; contiguous f32)."""
    if b.shape[0] == 0:
        raise ValueError("nearest neighbours in an empty point cloud")
    if a.device.type == "cpu":
        return nn_dists_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"_nn_dists: unsupported device {a.device}")
    N, M = a.shape[0], b.shape[0]
    dev = a.device
    check_cuda_input(a, "a", torch.float32, (N, 3), dev)
    check_cuda_input(b, "b", torch.float32, (M, 3), dev)
    check_no_grad(a, "a")
    check_no_grad(b, "b")
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    # Split b into S ranges so that the search fills the card.
    blocks = -(-N // _NN_THREADS)
    S = max(1, min(-(-M // _NN_MIN_SPAN),
                   -(-_nn_target_blocks(dev.index) // blocks)))
    span = -(-M // S)
    S = -(-M // span)
    best_d = torch.empty((S, N), dtype=torch.float32, device=dev)
    best_i = torch.empty((S, N), dtype=torch.int32, device=dev)
    NN_KERNEL.launch("nn_dists_forward", [a, b, best_d, best_i, out, N, M,
                                          span])
    return out


def fscore_from_dists(pred_to_gt: torch.Tensor, gt_to_pred: torch.Tensor,
                      thresh: float) -> Dict[str, torch.Tensor]:
    """F-score, precision and recall from the two directions' distances,
    with the reference's naming: 'recall' from pred -> gt, 'precision'
    from gt -> pred (swapped against the textbook convention)."""
    def mean(hits):  # the count times f32(1 / N), as jnp.mean rounds it
        return torch.sum(hits.to(torch.float32)) * (1.0 / hits.shape[0])

    recall = mean(pred_to_gt < thresh)
    precision = mean(gt_to_pred < thresh)
    denom = recall + precision
    fscore = torch.where(denom > 0.0, 2 * recall * precision
                         / torch.where(denom > 0.0, denom, 1.0), 0.0)
    return {"fscore": fscore, "precision": precision, "recall": recall}


def point_fscore(pred, gt, thresh: float,
                 device: str | torch.device | None = None
                 ) -> Dict[str, torch.Tensor]:
    """F-score between two point clouds (N, 3) and (M, 3) at a distance
    threshold (reference metrics.py:306-330): 0-dim f32 tensors
    ``fscore``, ``precision``, ``recall``. Kernel K9 twice on the card.

    Each cloud is a tensor or an array. Tensors must lie on one device,
    ``device`` if it is given: nothing is moved off the card, or onto
    it, behind the caller's back. Arrays go to that device, and to the
    card when no tensor and no ``device`` name one."""
    tensors = [t for t in (pred, gt) if isinstance(t, torch.Tensor)]
    if device is None:
        device = tensors[0].device if tensors else "cuda"
    device = get_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    for t in tensors:
        if t.device != device:
            raise ValueError(f"point_fscore: a cloud on {t.device}, "
                             f"expected {device}")
    pred, gt = (torch.as_tensor(x, dtype=torch.float32,
                                device=device).contiguous()
                for x in (pred, gt))
    return fscore_from_dists(_nn_dists(pred, gt), _nn_dists(gt, pred),
                             thresh)


# -- alignments -------------------------------------------------------------


def no_alignment(est, gt):
    return est, gt


def root_align(est: torch.Tensor, gt: torch.Tensor, root=(0,)):
    """Subtract the mean of the root joints from each set."""
    idx = torch.as_tensor(tuple(root), dtype=torch.long, device=est.device)
    return (est - est[..., idx, :].mean(dim=-2, keepdim=True),
            gt - gt[..., idx, :].mean(dim=-2, keepdim=True))


def translation_align(est: torch.Tensor, gt: torch.Tensor):
    """Mean-centre both point sets."""
    return (est - est.mean(dim=-2, keepdim=True),
            gt - gt.mean(dim=-2, keepdim=True))


def scale_align(est: torch.Tensor, gt: torch.Tensor):
    """Scale + translation: est is scaled by sqrt(var(gt) / var(est)) about
    its mean, then translated onto gt's mean."""
    mu1 = est.mean(dim=-2, keepdim=True)
    mu2 = gt.mean(dim=-2, keepdim=True)
    x1 = est - mu1
    x2 = gt - mu2
    var1 = torch.sum(x1 * x1, dim=(-1, -2))
    var2 = torch.sum(x2 * x2, dim=(-1, -2))
    scale = torch.sqrt(var2 / torch.clamp(var1, min=1e-12))
    return scale[..., None, None] * x1 + mu2, gt


def procrustes_align(est: torch.Tensor, gt: torch.Tensor):
    """Similarity (sR, t) alignment of est onto gt, batched over leading
    dims, with the reflection fix Z = diag(1, 1, sign(det(U V^T)))."""
    mu1 = est.mean(dim=-2, keepdim=True)
    mu2 = gt.mean(dim=-2, keepdim=True)
    x1 = est - mu1
    x2 = gt - mu2
    var1 = torch.sum(x1 * x1, dim=(-1, -2))
    K = torch.einsum("...pi,...pj->...ij", x1, x2)
    U, _, Vt = torch.linalg.svd(K)
    det = torch.linalg.det(U @ Vt)
    Z = torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape).clone()
    Z[..., 2, 2] = Z[..., 2, 2] * torch.sign(det)
    # R aligns x1 onto x2: R = V Z U^T
    R = torch.einsum("...ji,...jk,...lk->...il", Vt, Z, U)
    scale = torch.einsum("...ij,...ji->...", R, K) / torch.clamp(var1,
                                                                 min=1e-12)
    est_hat = scale[..., None, None] * torch.einsum(
        "...ij,...pj->...pi", R, x1) + mu2
    return est_hat, gt


ALIGNMENTS: Dict[str, Callable] = {
    "none": no_alignment,
    "no": no_alignment,
    "root": root_align,
    "translation": translation_align,
    "scale": scale_align,
    "procrustes": procrustes_align,
}
# K8b's mode for each alignment name.
_ALIGN_MODES = {"none": 0, "no": 0, "root": 1, "translation": 2, "scale": 3,
                "procrustes": 4}


def build_alignment(name: str, root=None) -> Callable:
    """Alignment function by name; ``root`` joint ids for "root"."""
    if name == "root":
        root = tuple(root or (0,))
        return lambda est, gt: root_align(est, gt, root)
    if name not in ALIGNMENTS:
        raise ValueError(f"Unknown alignment type: {name}")
    return ALIGNMENTS[name]


def aligned_point_error_plain(est: torch.Tensor, gt: torch.Tensor,
                              alignment: str = "none",
                              root: Sequence[int] = (0,)) -> torch.Tensor:
    """Plain version of K8b: ``point_error(*align(est, gt))``, (B, P)."""
    return point_error(*build_alignment(alignment, root)(est, gt))


def aligned_point_error(est: torch.Tensor, gt: torch.Tensor,
                        alignment: str = "none",
                        root: Sequence[int] = (0,)) -> torch.Tensor:
    """Per-point error (B, P) of est (B, P, 3) aligned onto gt (B, P, 3):
    the plain version for CPU tensors, kernel K8b for CUDA tensors
    (forward only; contiguous f32)."""
    if est.device.type == "cpu":
        return aligned_point_error_plain(est, gt, alignment, root)
    if est.device.type != "cuda":
        raise ValueError(f"aligned_point_error: unsupported device "
                         f"{est.device}")
    if alignment not in _ALIGN_MODES:
        raise ValueError(f"Unknown alignment type: {alignment}")
    B, P = est.shape[:2]
    dev = est.device
    check_cuda_input(est, "est", torch.float32, (B, P, 3), dev)
    check_cuda_input(gt, "gt", torch.float32, (B, P, 3), dev)
    check_no_grad(est, "est")
    check_no_grad(gt, "gt")
    out = torch.empty((B, P), dtype=torch.float32, device=dev)
    if B == 0 or P == 0:
        return out
    root = tuple(int(r) for r in (root or (0,)))
    if alignment == "root":
        # The kernel reads these ids unchecked.
        if min(root) < 0 or max(root) >= P:
            raise ValueError(f"root joints {root} outside [0, {P})")
        root_ids = torch.tensor(root, dtype=torch.int32, device=dev)
    else:
        root_ids = out  # not read
    ALIGN_KERNEL.launch("align_error_forward", [
        est, gt, root_ids, out, B, P, len(root), _ALIGN_MODES[alignment]])
    return out


class PointError:
    """Alignment + per-point error; K8b on the card."""

    def __init__(self, alignment: str = "none", root=None, name: str = ""):
        if alignment not in ALIGNMENTS:
            raise ValueError(f"Unknown alignment type: {alignment}")
        self.alignment_name = alignment
        self.root = tuple(root or (0,))
        self.align = build_alignment(alignment, self.root)
        self.name = name or alignment

    def set_root(self, root) -> None:
        if self.alignment_name == "root":
            self.root = tuple(root)
            self.align = build_alignment("root", self.root)

    def __call__(self, est: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        return aligned_point_error(est.contiguous(), gt.contiguous(),
                                   self.alignment_name, self.root)

    def plain(self, est: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        """The plain version on any device (the kernel's reference)."""
        return point_error(*self.align(est, gt))


# -- sparse HD point regressor (P2P-20k) ------------------------------------


def regress_points(vertices: torch.Tensor, indices: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """(B, V, 3) vertices, (P, K) indices and weights -> (B, P, 3)."""
    gathered = vertices[:, indices.long()]  # (B, P, K, 3)
    return torch.sum(gathered * weights[None, ..., None], dim=-2)


def point_regress_error_plain(input_vertices, target_vertices, indices,
                              weights, target_indices, target_weights,
                              align: bool = True) -> torch.Tensor:
    """Plain version of K8a: regress both meshes, translate the first set
    onto the second's mean (``align``), per-point distance (B, P)."""
    p1 = regress_points(input_vertices, indices, weights)
    p2 = regress_points(target_vertices, target_indices, target_weights)
    if align:
        p1 = p1 + (p2.mean(dim=1, keepdim=True)
                   - p1.mean(dim=1, keepdim=True))
    return point_error(p1, p2)


def point_regress_error(input_vertices: torch.Tensor,
                        target_vertices: torch.Tensor,
                        indices: torch.Tensor, weights: torch.Tensor,
                        target_indices: torch.Tensor,
                        target_weights: torch.Tensor, align: bool = True
                        ) -> torch.Tensor:
    """P2P error (B, P) between input_vertices (B, V1, 3) regressed with
    (indices, weights) (P, K1) and target_vertices (B, V2, 3) regressed
    with (target_indices, target_weights) (P, K2): the plain version for
    CPU tensors, kernel K8a for CUDA tensors (forward only; contiguous
    f32 vertices and weights, int32 indices, which the caller keeps
    inside [0, V))."""
    if input_vertices.device.type == "cpu":
        return point_regress_error_plain(input_vertices, target_vertices,
                                         indices, weights, target_indices,
                                         target_weights, align)
    if input_vertices.device.type != "cuda":
        raise ValueError(f"point_regress_error: unsupported device "
                         f"{input_vertices.device}")
    B, V1 = input_vertices.shape[:2]
    V2 = target_vertices.shape[1]
    P, K1 = indices.shape
    K2 = target_indices.shape[1]
    dev = input_vertices.device
    check_cuda_input(input_vertices, "input_vertices", torch.float32,
                     (B, V1, 3), dev)
    check_cuda_input(target_vertices, "target_vertices", torch.float32,
                     (B, V2, 3), dev)
    check_cuda_input(indices, "indices", torch.int32, (P, K1), dev)
    check_cuda_input(weights, "weights", torch.float32, (P, K1), dev)
    check_cuda_input(target_indices, "target_indices", torch.int32, (P, K2),
                     dev)
    check_cuda_input(target_weights, "target_weights", torch.float32,
                     (P, K2), dev)
    for t, name in ((input_vertices, "input_vertices"),
                    (target_vertices, "target_vertices")):
        check_no_grad(t, name)
    out = torch.empty((B, P), dtype=torch.float32, device=dev)
    if B == 0 or P == 0:
        return out
    tiles = -(-P // _REGRESS_TILE)
    partials = torch.empty((B, tiles, 6), dtype=torch.float64, device=dev)
    REGRESS_KERNEL.launch("point_regress_forward", [
        input_vertices, target_vertices, indices, weights, target_indices,
        target_weights, partials, out, B, V1, V2, P, K1, K2, int(align)])
    return out


class SparsePointRegressor:
    """Cross-topology point metric (P2P-20k): regress ~20k surface points
    from each mesh's vertices with a sparse matrix, translation-align, mean
    distance. Rows are stored padded, (P, K) int32 vertex indices + f32
    weights (padding: index 0, weight 0), on ``device``."""

    def __init__(self, indices: np.ndarray, weights: np.ndarray,
                 align: bool = True, device: str | torch.device = "cuda"):
        device = get_device(device)
        indices = np.asarray(indices)
        if indices.size and indices.min() < 0:
            raise ValueError("negative vertex index in the point regressor")
        # The kernel gathers unchecked: remember the bound to test against.
        self.num_vertices = int(indices.max()) + 1 if indices.size else 0
        self.indices = torch.as_tensor(
            np.ascontiguousarray(indices, np.int32), device=device)
        self.weights = torch.as_tensor(
            np.ascontiguousarray(weights, np.float32), device=device)
        self.align = align

    @classmethod
    def from_scipy(cls, matrix, align: bool = True,
                   device: str | torch.device = "cuda"
                   ) -> "SparsePointRegressor":
        m = matrix.tocsr()
        P = m.shape[0]
        counts = np.diff(m.indptr)
        K = int(max(1, counts.max()))
        idx = np.zeros((P, K), np.int64)
        w = np.zeros((P, K), np.float64)
        for i in range(P):
            s, e = m.indptr[i], m.indptr[i + 1]
            idx[i, : e - s] = m.indices[s:e]
            w[i, : e - s] = m.data[s:e]
        return cls(idx, w, align=align, device=device)

    @classmethod
    def from_pickle(cls, path: str, align: bool = True,
                    device: str | torch.device = "cuda"
                    ) -> "SparsePointRegressor":
        import pickle

        with open(path, "rb") as f:
            matrix = pickle.load(f, encoding="latin1")
        return cls.from_scipy(matrix, align=align, device=device)

    @property
    def device(self) -> torch.device:
        return self.indices.device

    def to(self, device: str | torch.device) -> "SparsePointRegressor":
        """This regressor with its rows on ``device`` (self if they are
        there already)."""
        device = torch.device(device)
        if device == self.device:
            return self
        out = copy.copy(self)
        out.indices = self.indices.to(device)
        out.weights = self.weights.to(device)
        return out

    def regress(self, vertices: torch.Tensor) -> torch.Tensor:
        """(B, V, 3) -> (B, P, 3), plain PyTorch on every device."""
        return regress_points(vertices, self.indices, self.weights)

    def check_mesh(self, vertices: torch.Tensor) -> None:
        """Raise unless every index of this regressor lies inside the
        (B, V, 3) mesh (kernel K8a gathers unchecked)."""
        if self.num_vertices > vertices.shape[1]:
            raise ValueError(f"point regressor indexes {self.num_vertices} "
                             f"vertices, mesh has {vertices.shape[1]}")

    def _args(self, input_vertices, target_vertices, target_regressor):
        tr = target_regressor or self
        self.check_mesh(input_vertices)
        tr.check_mesh(target_vertices)
        return (input_vertices.contiguous(), target_vertices.contiguous(),
                self.indices, self.weights, tr.indices, tr.weights,
                self.align)

    def __call__(self, input_vertices: torch.Tensor,
                 target_vertices: torch.Tensor,
                 target_regressor: Optional["SparsePointRegressor"] = None
                 ) -> torch.Tensor:
        """Per-point distances (B, P) between the regressed point sets;
        K8a on the card."""
        return point_regress_error(*self._args(
            input_vertices, target_vertices, target_regressor))

    def plain(self, input_vertices, target_vertices, target_regressor=None
              ) -> torch.Tensor:
        """The plain version on any device (the kernel's reference)."""
        return point_regress_error_plain(*self._args(
            input_vertices, target_vertices, target_regressor))


def mpjpe(pred_joints: torch.Tensor, gt_joints: torch.Tensor,
          alignment: str = "root", root=(0,)) -> torch.Tensor:
    """Mean per-joint position error under an alignment."""
    est, gt = build_alignment(alignment, root)(pred_joints, gt_joints)
    return point_error(est, gt).mean(dim=-1)
