"""Evaluation metrics and alignments (port of ``shapy_tpu/eval/metrics.py``).

Plain functions on tensors with the JAX package's layouts: ``(B, P, 3)``
point sets, ``(P, K)`` padded regressor rows. Three kernels carry the
metrics on the card:

  * K8b (``csrc/align_error.cu``) — :func:`aligned_point_errors`, any of
    the alignments below followed by :func:`point_error`, for a group of
    point-set pairs in one launch (the evaluator's nine metrics a batch);
    :func:`aligned_point_error` and :class:`PointError` are a group of one;
  * K8a (``csrc/point_regress.cu``) — :func:`point_regress_error`, the
    P2P-20k error of :class:`SparsePointRegressor`;
  * K9 (``csrc/nn_dists.cu``) — :func:`nn_dists_both` and :func:`_nn_dists`,
    each point's distance to its nearest neighbour in the other cloud,
    both directions of :func:`point_fscore` in one launch.

Each wrapper runs its plain version (``*_plain``) for CPU tensors and
launches its kernel, or raises, for CUDA tensors. The alignment functions
themselves are plain PyTorch on every device (``procrustes_align`` uses
``torch.linalg.svd`` like the JAX code).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from shapy_tpu_torch.utils.cuda_kernels import (
    CARD_SMS,
    CudaKernel,
    check_cuda_input,
    check_no_grad,
)
from shapy_tpu_torch.utils.device import get_device
from shapy_tpu_torch.utils.vec3 import dot3

ALIGN_KERNEL = CudaKernel("align_error.cu",
                          {"align_error_forward": "p iiiii p"})
REGRESS_KERNEL = CudaKernel("point_regress.cu",
                            {"point_regress_forward": "ppppppppp iiiiiiiii p"})
# The K8 kernels' split of a body's points (align_plan, regress_plan): CTAs
# of ~this many points, at most the portable cluster of 8 a body and ~512
# CTAs a pair over the batch, and never more points a CTA than its shared
# memory holds (24 bytes a point).
_ALIGN_CTA_POINTS = 2620
_REGRESS_CTA_POINTS = 2048
_K8_MAX_CLUSTER = 8
_K8_PAIR_CTAS = 512
_K8_MAX_SPAN = 9000
_ALIGN_THREADS, _REGRESS_THREADS = 256, 512  # threads a CTA
# K8b's table: pairs a launch, root ids a pair, int64 fields a pair
# (csrc/align_error.cu).
_ALIGN_MAX_PAIRS = 8
_ALIGN_MAX_ROOT = 16
_ALIGN_FIELDS = 14 + _ALIGN_MAX_ROOT
# A (body, pair)'s double totals in K8b: est and gt coordinate sums, var1,
# var2, K row-major, the root ids' coordinate sums.
_ALIGN_SUMS = 23
NN_KERNEL = CudaKernel("nn_dists.cu",
                       {"nn_dists_forward": "pppppp iiiiiiii p"})
# csrc/nn_dists.cu: threads a search block, query points a thread, points
# of b a run and a staged tile.
_NN_THREADS, _NN_R, _NN_RUN, _NN_TILE = 256, 4, 16, 2048
# Search blocks to aim for: one an SM. The search takes the same time at 1-4
# an SM; more ranges only lengthen the merge.
_NN_TARGET_CTAS = CARD_SMS
_NN_MIN_SPAN = 64  # fewest points of b a range


class ClusterPlan(NamedTuple):
    """A K8 kernel's split of one body's P points (from the shape alone):
    ``cluster`` CTAs a body (1: one CTA), CTA r the contiguous run
    ``[r span, min(P, (r + 1) span))``."""

    cluster: int
    span: int


def _cluster_plan(P: int, B: int, cta_points: int) -> ClusterPlan:
    want = min(-(-P // cta_points), max(1, _K8_PAIR_CTAS // max(B, 1)))
    cluster = min(_K8_MAX_CLUSTER, max(1, want, -(-P // _K8_MAX_SPAN)))
    return ClusterPlan(cluster, -(-P // cluster))


def align_plan(P: int, B: int) -> ClusterPlan:
    """K8b's split of a point-set pair of B bodies of P points: ~2620
    points a CTA (63 KB of staged points; three CTAs an SM), at most 8
    CTAs a body and ~512 a pair over the batch (at the evaluator's P =
    10475, B = 32: 4 CTAs of 2619 points, and the group's 320 CTAs in one
    wave; ``tools/perf_k8_sweep.py``)."""
    return _cluster_plan(P, B, _ALIGN_CTA_POINTS)


def regress_plan(P: int, B: int) -> ClusterPlan:
    """K8a's split of B bodies' P regressed points: ~2048 points a CTA, at
    most 8 CTAs a body and ~512 over the batch (P2P-20k at B = 32: 8 CTAs
    of 2500 points, 60 KB of regressed points each: all 256 CTAs in one
    wave, ``tools/perf_k8_sweep.py``)."""
    return _cluster_plan(P, B, _REGRESS_CTA_POINTS)


def kernel_order_sum(terms: torch.Tensor, plan: ClusterPlan,
                     threads: int) -> torch.Tensor:
    """(B, P, N) per-point terms -> (B, N), summed in the order of the K8
    kernels' reductions under ``plan`` with ``threads`` a CTA: CTA r takes
    points [r span, (r + 1) span); its thread t adds its points t, t +
    threads, ... in order, from 0; a warp's 32 threads by a shuffle-down
    tree (lane l adds lane l + o for o = 16, 8, 4, 2, 1); the warps in
    order, from 0; then the ranks in order, from 0. In the terms' dtype
    (the kernels: double)."""
    B, P, N = terms.shape
    C, span = plan
    iters = max(1, -(-span // threads))
    x = terms.new_zeros((B, C, iters * threads, N))
    for r in range(C):
        lo, hi = min(P, r * span), min(P, (r + 1) * span)
        x[:, r, : hi - lo] = terms[:, lo:hi]
    x = x.view(B, C, iters, threads, N)
    s = terms.new_zeros((B, C, threads, N))
    for k in range(iters):
        s = s + x[:, :, k]
    s = s.view(B, C, threads // 32, 32, N)
    for o in (16, 8, 4, 2, 1):
        s = s[..., :o, :] + s[..., o:2 * o, :]
    acc = terms.new_zeros((B, C, N))
    for w in range(threads // 32):
        acc = acc + s[:, :, w, 0]
    total = terms.new_zeros((B, N))
    for r in range(C):
        total = total + acc[:, r]
    return total


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


class NNPlan(NamedTuple):
    """K9's split of one direction (N query points in M points of b), from
    the shapes alone: ``blocks`` query blocks of 1024 points (256 threads
    of 4), b cut into ``ranges`` contiguous ranges of ``span`` points."""

    blocks: int
    ranges: int
    span: int


def nn_plan(N: int, M: int, both: bool = False) -> Tuple[NNPlan, ...]:
    """K9's plan for a (N, 3) in b (M, 3), and with ``both`` also b in a:
    a pure function of the shapes. Both directions share one launch, so
    each cuts b into as many ranges as give ~132 search blocks in all (one
    an SM of an H100), each range of at least 64 points. At N = M = 10475
    both ways: 11 query blocks a direction, 6 ranges of 1746 points."""
    per = _NN_THREADS * _NN_R
    dirs = ((N, M), (M, N)) if both else ((N, M),)
    blocks = [-(-n // per) for n, _ in dirs]
    plans = []
    for (_, m), nb in zip(dirs, blocks):
        ranges = max(1, min(-(-m // _NN_MIN_SPAN),
                            -(-_NN_TARGET_CTAS // sum(blocks))))
        span = -(-m // ranges)
        plans.append(NNPlan(nb, -(-m // span), span))
    return tuple(plans)


def nn_search_replay(a: torch.Tensor, b: torch.Tensor, plan: NNPlan
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9's search for a (N, 3) in b (M, 3) under ``plan``, replayed in
    plain PyTorch on any device: (distances (N,), neighbour indices (N,)).

    Each range of b is cut into tiles of 2048 points and each tile into
    runs of 16 (the last one padded with points that are never a
    minimum); the expansion is taken with -2 folded into a, as the kernel
    takes it; a range's minimum is the least run minimum, its neighbour
    the first point of the first run that reaches it (the kernel's last
    run that lowered the minimum strictly); the ranges are merged in
    order, strictly smaller only. Bit-equal to :func:`nn_dists_plain`
    (for finite clouds whose coordinate products stay above 2^-126)."""
    q = -2.0 * a  # exact
    aa, bb = dot3(a, a), dot3(b, b)
    N, M = a.shape[0], b.shape[0]
    best = a.new_full((N,), float("inf"))
    idx = torch.zeros((N,), dtype=torch.long, device=a.device)
    for r in range(plan.ranges):
        lo, hi = r * plan.span, min(M, (r + 1) * plan.span)
        d = (q[:, None, 0] * b[None, lo:hi, 0]
             + q[:, None, 1] * b[None, lo:hi, 1]
             + q[:, None, 2] * b[None, lo:hi, 2])
        d = (aa[:, None] + d) + bb[None, lo:hi]
        runs, starts = [], []
        for t in range(0, hi - lo, _NN_TILE):
            tile = d[:, t:t + _NN_TILE]
            pad = -tile.shape[1] % _NN_RUN
            tile = torch.nn.functional.pad(tile, (0, pad),
                                           value=float("inf"))
            runs.append(tile.reshape(N, -1, _NN_RUN).amin(dim=-1))
            starts += range(t, t + tile.shape[1], _NN_RUN)
        runs = torch.cat(runs, dim=1)
        least = runs.amin(dim=1)
        first_run = torch.argmax((runs == least[:, None]).to(torch.uint8),
                                 dim=1)
        j0 = torch.as_tensor(starts, device=a.device)[first_run]
        cols = (j0[:, None] + torch.arange(_NN_RUN, device=a.device)
                ).clamp(max=hi - lo - 1)
        in_run = torch.gather(d, 1, cols) == least[:, None]
        j = lo + j0 + torch.argmax(in_run.to(torch.uint8), dim=1)
        j = torch.where(least < float("inf"), j, lo)
        better = least < best
        best = torch.where(better, least, best)
        idx = torch.where(better, j, idx)
    diff = a - b[idx]
    return torch.sqrt(torch.clamp(dot3(diff, diff), min=0.0)), idx


def _nn_search_cuda(a: torch.Tensor, b: torch.Tensor, both: bool,
                    plans: Optional[Tuple[NNPlan, ...]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K9, one launch of the search and one of the merge: a in b
    (and with ``both`` b in a), under ``plans`` (default :func:`nn_plan`).
    Returns the distances (N (+ M),) and the neighbours' indices, int32,
    direction a -> b first."""
    if b.shape[0] == 0 or (both and a.shape[0] == 0):
        raise ValueError("nearest neighbours in an empty point cloud")
    if a.device.type != "cuda":
        raise ValueError(f"K9: unsupported device {a.device}")
    N, M = a.shape[0], b.shape[0]
    dev = a.device
    check_cuda_input(a, "a", torch.float32, (N, 3), dev)
    check_cuda_input(b, "b", torch.float32, (M, 3), dev)
    check_no_grad(a, "a")
    check_no_grad(b, "b")
    n_out = N + M if both else N
    out = torch.empty((n_out,), dtype=torch.float32, device=dev)
    idx = torch.empty((n_out,), dtype=torch.int32, device=dev)
    if N == 0:
        return out, idx
    plans = plans or nn_plan(N, M, both)
    p0 = plans[0]
    p1 = plans[1] if both else NNPlan(0, 0, 0)
    scratch = p0.ranges * N + p1.ranges * M
    best_d = torch.empty((scratch,), dtype=torch.float32, device=dev)
    best_i = torch.empty((scratch,), dtype=torch.int32, device=dev)
    NN_KERNEL.launch("nn_dists_forward", [
        a, b, best_d, best_i, out, idx, N, M, *p0, *p1])
    return out, idx


def _nn_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour distances (N,) from a (N, 3) to b (M, 3): the
    plain version for CPU tensors, kernel K9 for CUDA tensors (forward
    only; contiguous f32). :func:`point_fscore` takes both directions in
    one launch (:func:`nn_dists_both`); this one-direction entry, and its
    branch of the kernel, serve the tests and ``chip_smoke.py``."""
    if b.shape[0] == 0:
        raise ValueError("nearest neighbours in an empty point cloud")
    if a.device.type == "cpu":
        return nn_dists_plain(a, b)
    return _nn_search_cuda(a, b, both=False)[0]


def nn_dists_both(a: torch.Tensor, b: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both directions of :func:`point_fscore`: (a -> b (N,), b -> a
    (M,)), each as :func:`_nn_dists` gives it. The plain version twice for
    CPU tensors; one K9 launch for CUDA tensors."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        raise ValueError("nearest neighbours in an empty point cloud")
    if a.device.type == "cpu":
        return nn_dists_plain(a, b), nn_dists_plain(b, a)
    out = _nn_search_cuda(a, b, both=True)[0]
    return out[:a.shape[0]], out[a.shape[0]:]


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
    ``fscore``, ``precision``, ``recall``. One K9 launch on the card, both
    directions (:func:`nn_dists_both`).

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
    return fscore_from_dists(*nn_dists_both(pred, gt), thresh)


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


PairSpec = Tuple[torch.Tensor, torch.Tensor, Sequence[str],
                 Optional[Sequence[int]]]


def _pair(spec: PairSpec):
    est, gt, names, root = spec
    names = tuple(names)
    for name in names:
        if name not in _ALIGN_MODES:
            raise ValueError(f"Unknown alignment type: {name}")
    return est, gt, names, tuple(int(r) for r in (root or (0,)))


def aligned_point_errors(pairs: Sequence[PairSpec], plain: bool = False
                         ) -> List[Dict[str, torch.Tensor]]:
    """Per-point errors of a group of point-set pairs of one batch of B
    bodies, in one launch of kernel K8b on the card.

    ``pairs``: ``(est, gt, alignments, root)``, est and gt (B, P, 3) (P
    may differ between pairs), the alignment names asked of the pair and
    the root joint ids of its "root" alignment (None: joint 0); on the
    card est and gt contiguous f32. Returns,
    for each pair, ``{alignment: (B, P) errors}``, what
    :class:`PointError` returns. CPU tensors and ``plain=True`` go through
    the plain version (:func:`aligned_point_error_plain` per alignment),
    CUDA tensors through the kernel (forward only; f32; at most 8 pairs
    and 16 root ids a pair)."""
    pairs = [_pair(p) for p in pairs]
    if not pairs:
        return []
    device = pairs[0][0].device
    if plain or device.type == "cpu":
        return [{name: aligned_point_error_plain(est, gt, name, root)
                 for name in names} for est, gt, names, root in pairs]
    if device.type != "cuda":
        raise ValueError(f"aligned_point_errors: unsupported device "
                         f"{device}")
    return _aligned_point_errors_cuda(pairs)[0]


def _aligned_point_errors_cuda(pairs):
    """Kernel K8b on checked pairs (``_pair``): the errors and, for each
    launched pair, its (B, 23) double totals (``aligned_sums_replay``'s
    layout; None for a pair of no point)."""
    dev = pairs[0][0].device
    B = pairs[0][0].shape[0]
    if len(pairs) > _ALIGN_MAX_PAIRS:
        raise ValueError(f"{len(pairs)} point-set pairs in one K8b launch, "
                         f"at most {_ALIGN_MAX_PAIRS}")
    outs, rows = [], []
    for i, (est, gt, names, root) in enumerate(pairs):
        P = est.shape[1]
        check_cuda_input(est, f"est[{i}]", torch.float32, (B, P, 3), dev)
        check_cuda_input(gt, f"gt[{i}]", torch.float32, (B, P, 3), dev)
        check_no_grad(est, f"est[{i}]")
        check_no_grad(gt, f"gt[{i}]")
        modes = sorted({_ALIGN_MODES[name] for name in names})
        buf = torch.empty((len(modes), B, P), dtype=torch.float32,
                          device=dev)
        by_mode = dict(zip(modes, buf))
        outs.append({name: by_mode[_ALIGN_MODES[name]] for name in names})
        if B == 0 or P == 0:
            continue
        if _ALIGN_MODES["root"] in by_mode:
            # The kernel reads these ids unchecked.
            if min(root) < 0 or max(root) >= P:
                raise ValueError(f"root joints {root} outside [0, {P})")
            if len(root) > _ALIGN_MAX_ROOT:
                raise ValueError(f"{len(root)} root joints, at most "
                                 f"{_ALIGN_MAX_ROOT}")
        rows.append((i, est, gt, by_mode, root, align_plan(P, B)))
    sums = [None] * len(pairs)
    if not rows:
        return outs, sums
    for _, _, _, _, _, plan in rows:
        if plan.span > _K8_MAX_SPAN:
            raise ValueError(f"{plan.span} points a CTA: a pair of more "
                             f"than {_K8_MAX_CLUSTER * _K8_MAX_SPAN} points")
    cluster = max(plan.cluster for *_, plan in rows)
    totals = torch.empty((len(rows), B, _ALIGN_SUMS), dtype=torch.float64,
                         device=dev)
    table, cta0, span_max = [], 0, 1
    for r, (i, est, gt, by_mode, root, plan) in enumerate(rows):
        P = est.shape[1]
        clustered = plan.cluster > 1
        span = plan.span if clustered else P
        root_ids = root if _ALIGN_MODES["root"] in by_mode else ()
        table += [est.data_ptr(), gt.data_ptr(),
                  *(by_mode[m].data_ptr() if m in by_mode else 0
                    for m in range(5)),
                  totals[r].data_ptr(), P, span, plan.cluster, cta0,
                  sum(1 << m for m in by_mode), len(root_ids), *root_ids,
                  *(0,) * (_ALIGN_MAX_ROOT - len(root_ids))]
        sums[i] = totals[r]
        span_max = max(span_max, span)
        # A cluster a body, or one CTA a body packed by clusters.
        cta0 += B * cluster if clustered else -(-B // cluster) * cluster
    ALIGN_KERNEL.launch("align_error_forward", [
        torch.tensor(table, dtype=torch.int64), len(rows), B, cluster, cta0,
        span_max])
    return outs, sums


def aligned_sums_replay(est: torch.Tensor, gt: torch.Tensor,
                        names: Sequence[str], root: Sequence[int] = (0,)
                        ) -> torch.Tensor:
    """The (B, 23) double totals K8b keeps for a pair (B, P, 3) asked
    ``names``, replayed in the kernel's order (:func:`kernel_order_sum`
    under :func:`align_plan`, the f32-centred points, the root ids by one
    warp's shuffle tree), on any device: est and gt coordinate sums, var1,
    var2, K row-major, root coordinate sums; 0 where not computed."""
    B, P, _ = est.shape
    modes = {_ALIGN_MODES[n] for n in names}
    plan = align_plan(P, B)
    out = est.new_zeros((B, _ALIGN_SUMS), dtype=torch.float64)
    scale, procrustes = 3 in modes, 4 in modes
    if modes & {2, 3, 4}:
        out[:, :6] = kernel_order_sum(
            torch.cat([est, gt], dim=-1).double(), plan, _ALIGN_THREADS)
    if scale or procrustes:
        m = (out[:, :6] / P).float()
        x1 = (est - m[:, None, :3]).double()
        x2 = (gt - m[:, None, 3:]).double()
        terms = est.new_zeros((B, P, 11), dtype=torch.float64)
        terms[..., 0] = (x1[..., 0] * x1[..., 0] + x1[..., 1] * x1[..., 1]
                         + x1[..., 2] * x1[..., 2])
        if scale:
            terms[..., 1] = (x2[..., 0] * x2[..., 0] + x2[..., 1] * x2[..., 1]
                             + x2[..., 2] * x2[..., 2])
        if procrustes:
            terms[..., 2:] = (x1[..., :, None] * x2[..., None, :]).reshape(
                B, P, 9)
        out[:, 6:17] = kernel_order_sum(terms, plan, _ALIGN_THREADS)
    if 1 in modes:
        root = tuple(int(r) for r in root)
        lanes = est.new_zeros((B, 32, 6), dtype=torch.float64)
        for r, p in enumerate(root):
            lanes[:, r % 32] = lanes[:, r % 32] + torch.cat(
                [est[:, p], gt[:, p]], dim=-1).double()
        for o in (16, 8, 4, 2, 1):
            lanes = lanes[:, :o] + lanes[:, o:2 * o]
        out[:, 17:] = lanes[:, 0]
    return out


def aligned_point_error(est: torch.Tensor, gt: torch.Tensor,
                        alignment: str = "none",
                        root: Sequence[int] = (0,)) -> torch.Tensor:
    """Per-point error (B, P) of est (B, P, 3) aligned onto gt (B, P, 3):
    :func:`aligned_point_errors` for a group of one (the plain version for
    CPU tensors, kernel K8b for CUDA tensors)."""
    return aligned_point_errors([(est, gt, (alignment,), root)])[0][
        alignment]


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
                              align: bool = True,
                              order: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain version of K8a: regress both meshes, translate the first set
    onto the second's mean (``align``), per-point distance (B, P). With
    ``order``, the rows are given in slot order (row ``order[j]`` at slot
    j, as :func:`point_regress_error` takes them) and are put back in row
    order first."""
    if order is not None:
        order = order.long()
        indices, weights, target_indices, target_weights = (
            torch.empty_like(t).index_copy_(0, order, t)
            for t in (indices, weights, target_indices, target_weights))
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
                        target_weights: torch.Tensor, align: bool = True,
                        order: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """P2P error (B, P) between input_vertices (B, V1, 3) regressed with
    (indices, weights) (P, K1) and target_vertices (B, V2, 3) regressed
    with (target_indices, target_weights) (P, K2): the plain version for
    CPU tensors, kernel K8a for CUDA tensors (forward only; contiguous
    f32 vertices and weights, int32 indices, which the caller keeps
    inside [0, V); at most 72000 points). ``order`` (P,) int32, if given:
    the rows are in slot order, slot j holding row ``order[j]``, whose
    error it writes (:class:`SparsePointRegressor` sorts its rows so that
    neighbouring slots gather neighbouring vertices)."""
    if input_vertices.device.type == "cpu":
        return point_regress_error_plain(input_vertices, target_vertices,
                                         indices, weights, target_indices,
                                         target_weights, align, order)
    if input_vertices.device.type != "cuda":
        raise ValueError(f"point_regress_error: unsupported device "
                         f"{input_vertices.device}")
    return _point_regress_cuda(input_vertices, target_vertices, indices,
                               weights, target_indices, target_weights,
                               align, order)[0]


def _point_regress_cuda(input_vertices, target_vertices, indices, weights,
                        target_indices, target_weights, align, order):
    """Kernel K8a: the errors (B, P) and each body's six double totals of
    the translation (B, 6) (0 without ``align``)."""
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
    if order is not None:
        check_cuda_input(order, "order", torch.int32, (P,), dev)
    for t, name in ((input_vertices, "input_vertices"),
                    (target_vertices, "target_vertices")):
        check_no_grad(t, name)
    out = torch.empty((B, P), dtype=torch.float32, device=dev)
    sums = torch.empty((B, 6), dtype=torch.float64, device=dev)
    if B == 0 or P == 0:
        return out, sums.zero_()
    plan = regress_plan(P, B)
    if plan.span > _K8_MAX_SPAN:
        raise ValueError(f"{P} regressed points: at most "
                         f"{_K8_MAX_CLUSTER * _K8_MAX_SPAN}")
    REGRESS_KERNEL.launch("point_regress_forward", [
        input_vertices, target_vertices, indices, weights, target_indices,
        target_weights, order, sums, out, B, V1, V2, P, K1, K2,
        plan.cluster, plan.span, int(align)])
    return out, sums


def regress_sums_replay(input_vertices, target_vertices, indices, weights,
                        target_indices, target_weights) -> torch.Tensor:
    """The (B, 6) double totals K8a keeps for the translation (the
    coordinate sums of both regressed sets), replayed in the kernel's
    order on any device: each point regressed in f32 as ``x = 0; x += w_k
    v_k`` over the rows as given (slot order), then
    :func:`kernel_order_sum` under :func:`regress_plan`."""
    def regress(v, idx, w):
        x = v.new_zeros((v.shape[0], idx.shape[0], 3))
        for k in range(idx.shape[1]):
            x = x + w[None, :, k, None] * v[:, idx[:, k].long()]
        return x

    p1 = regress(input_vertices, indices, weights)
    p2 = regress(target_vertices, target_indices, target_weights)
    B, P = p1.shape[:2]
    return kernel_order_sum(torch.cat([p1, p2], dim=-1).double(),
                            regress_plan(P, B), _REGRESS_THREADS)


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
        # K8a's rows: sorted once by their first vertex, so that the
        # kernel's neighbouring slots gather neighbouring vertices; slot j
        # holds row order[j].
        order = (np.argsort(indices[:, 0], kind="stable") if indices.size
                 else np.arange(indices.shape[0]))
        self.order = torch.as_tensor(order.astype(np.int32), device=device)
        self._slots = {}  # regressor -> its rows in this one's slot order

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
        out.order = self.order.to(device)
        out._slots = {}
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

    def _slot_rows(self, reg: "SparsePointRegressor") -> tuple:
        if reg not in self._slots:
            idx = self.order.long()
            self._slots[reg] = (reg.indices[idx].contiguous(),
                                reg.weights[idx].contiguous())
        return self._slots[reg]

    def kernel_rows(self, target_regressor=None) -> tuple:
        """(indices, weights, target indices, target weights, order): the
        rows of this regressor and of the target regressor (default this
        one) in this one's slot order, as :func:`point_regress_error`
        takes them; gathered once and kept."""
        return (*self._slot_rows(self),
                *self._slot_rows(target_regressor or self), self.order)

    def __call__(self, input_vertices: torch.Tensor,
                 target_vertices: torch.Tensor,
                 target_regressor: Optional["SparsePointRegressor"] = None
                 ) -> torch.Tensor:
        """Per-point distances (B, P) between the regressed point sets;
        K8a on the card, on the sorted rows (:meth:`kernel_rows`)."""
        v_in, v_tgt = self._args(input_vertices, target_vertices,
                                 target_regressor)[:2]
        idx1, w1, idx2, w2, order = self.kernel_rows(target_regressor)
        return point_regress_error(v_in, v_tgt, idx1, w1, idx2, w2,
                                   self.align, order)

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
