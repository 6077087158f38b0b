"""Evaluation orchestrator (port of ``shapy_tpu/eval/evaluator.py``).

Per batch, :meth:`Evaluator.compute_batch_metrics` computes on the
outputs' device: v2v / v2v_t under their alignments and mpjpe / mpjpe14
(kernel K8b), p2p_t through the P2P-20k regressor (kernel K8a) and the
measurement errors. :meth:`Evaluator.run` streams the values into
per-metric (sum, count) accumulators with gender / BMI-bucket group means
and per-BMI-group histogram sums on the host.

Not ported yet: the image summaries (``create_image_summaries``, which need
the renderer) and the summary writer's scalars and BMI histogram figures;
``summary_writer`` is not taken.
"""

from __future__ import annotations

import logging
import os
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from shapy_tpu_torch.eval.metrics import (
    _ALIGN_MODES,
    PointError,
    SparsePointRegressor,
    aligned_point_errors,
)
from shapy_tpu_torch.utils.device import full_f32_matmul, get_device

logger = logging.getLogger(__name__)

# BMI buckets of the per-gender/BMI group means.
BMI_BUCKETS = ((0, 18.5), (18.5, 25.0), (25.0, 30.0), (30.0, 100.0))
BMI_BUCKET_NAMES = ("underweight", "normal", "overweight", "obese")

# BMI histogram bins: np.digitize over [20, 25, 30, 35, 40] -> 6 groups.
BMI_HIST_BINS = (20.0, 25.0, 30.0, 35.0, 40.0)
BMI_HIST_NAMES = ("<20", "20-25", "25-30", "30-35", "35-40", ">40")

MEASUREMENT_KEYS = ("height", "chest", "waist", "hips", "mass")


class MetricAccumulator:
    """Streaming mean with optional per-group breakdowns: (sum, count) per
    group, so the footprint does not grow with the dataset."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0
        self.group_sums: Dict[str, float] = defaultdict(float)
        self.group_counts: Dict[str, int] = defaultdict(int)

    def update(self, values: np.ndarray,
               group_keys: Optional[List[str]] = None) -> None:
        """NaN entries mark invalid samples and are skipped."""
        values = np.asarray(values, np.float64).reshape(-1)
        finite = np.isfinite(values)
        self.sum += float(values[finite].sum())
        self.count += int(finite.sum())
        if group_keys is not None:
            for v, g, ok in zip(values, group_keys, finite):
                if not ok:
                    continue
                self.group_sums[g] += float(v)
                self.group_counts[g] += 1

    @property
    def mean(self) -> float:
        # No valid samples is NaN, not 0.0: an all-invalid metric must not
        # read as a perfect score.
        if self.count == 0:
            return float("nan")
        return self.sum / self.count

    def group_means(self) -> Dict[str, float]:
        return {g: self.group_sums[g] / c
                for g, c in self.group_counts.items() if c > 0}


def bmi_bucket(height_m: float, mass_kg: float) -> str:
    if height_m <= 0:
        return "unknown"
    bmi = mass_kg / (height_m ** 2)
    for (lo, hi), name in zip(BMI_BUCKETS, BMI_BUCKET_NAMES):
        if lo <= bmi < hi:
            return name
    return "unknown"


def bmi_hist_group(height_m: np.ndarray, mass_kg: np.ndarray) -> np.ndarray:
    """np.digitize(bmi, [20, 25, 30, 35, 40]): int groups in [0, 5]; -1
    where the height is non-positive (no BMI)."""
    height_m = np.asarray(height_m, np.float64).reshape(-1)
    mass_kg = np.asarray(mass_kg, np.float64).reshape(-1)
    valid = height_m > 0
    bmi = np.where(valid, mass_kg / np.maximum(height_m, 1e-6) ** 2, 0.0)
    groups = np.digitize(bmi, np.asarray(BMI_HIST_BINS))
    return np.where(valid, groups, -1).astype(np.int64)


def _default(alignments, *names_roots):
    return alignments or {n: PointError(n, root=r) for n, r in names_roots}


def _point_error_means(jobs, plain: bool) -> Dict[str, torch.Tensor]:
    """{key: (B,) mean point error} of ``jobs`` [(key, PointError, est,
    gt)], all in one :func:`aligned_point_errors` call: the jobs on one
    (est, gt) share a pair unless they ask the same mode twice or two
    root sets."""
    entries, where = [], []
    for key, pe, est, gt in jobs:
        mode = _ALIGN_MODES[pe.alignment_name]
        root = pe.root if pe.alignment_name == "root" else None
        for i, (e, g, names, r) in enumerate(entries):
            modes = {_ALIGN_MODES[n] for n in names}
            if (e is est and g is gt and mode not in modes
                    and (root is None or r is None)):
                break
        else:
            i = len(entries)
            entries.append((est, gt, [], None))
        e, g, names, r = entries[i]
        names.append(pe.alignment_name)
        entries[i] = (e, g, names, root if root is not None else r)
        where.append((key, i, pe.alignment_name))
    errors = aligned_point_errors(
        [(e.contiguous(), g.contiguous(), n, r) for e, g, n, r in entries],
        plain)
    return {key: errors[i][name].mean(dim=-1) for key, i, name in where}


class Evaluator:
    """Runs a model over eval loaders and aggregates metrics on ``device``.

    Metrics per batch: v2v / v2v_t vertex errors under their alignments,
    p2p_t through the sparse point regressors, measurement absolute
    errors, mpjpe under the configured alignments and mpjpe14 through the
    J14 regressor (NaN where ``joints14_valid`` is 0)."""

    def __init__(
        self,
        point_regressor: Optional[SparsePointRegressor] = None,
        target_point_regressor: Optional[SparsePointRegressor] = None,
        alignments: Dict[str, PointError] | None = None,
        j14_regressor: Optional[np.ndarray] = None,
        mpjpe14_alignments: Dict[str, PointError] | None = None,
        v2v_alignments: Dict[str, PointError] | None = None,
        v2v_t_alignments: Dict[str, PointError] | None = None,
        device: str | torch.device = "cuda",
    ):
        self.device = get_device(device)
        self.point_regressor = (None if point_regressor is None
                                else point_regressor.to(self.device))
        self.target_point_regressor = (
            None if target_point_regressor is None
            else target_point_regressor.to(self.device))
        self.alignments = _default(alignments, ("root", None),
                                   ("procrustes", None))
        # J14 regressor: the first 14 rows, root-aligned on the hips [2, 3].
        self.j14_regressor = (
            None if j14_regressor is None
            else torch.as_tensor(np.asarray(j14_regressor, np.float32)[:14],
                                 device=self.device))
        self.mpjpe14_alignments = _default(
            mpjpe14_alignments, ("root", (2, 3)), ("procrustes", None))
        # 'translation' keeps the bare metric name.
        self.v2v_alignments = _default(v2v_alignments, ("translation", None))
        self.v2v_t_alignments = _default(v2v_t_alignments,
                                         ("translation", None))

    # -- per-batch metric computation (on the outputs' device) -------------
    def compute_batch_metrics(
        self,
        outputs: Dict[str, Any],
        targets: Dict[str, torch.Tensor],
        last_stage: str = "stage_02",
        plain: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """outputs: the regressor's output dict; targets may hold
        'gt_v_shaped' (B, V, 3), 'gt_vertices', 'gt_joints3d' (B, J, 4),
        'gt_joints14' with 'joints14_valid', and GT measurement scalars.
        Returns {metric: (B,) tensor}.

        ``plain=True`` computes every per-point error with the kernels'
        plain versions, on any device: the reference the kernels are held
        against."""
        with full_f32_matmul():
            return self._batch_metrics(outputs, targets, last_stage, plain)

    def _batch_metrics(self, outputs, targets, last_stage, plain):
        stage = outputs[last_stage]
        # The point errors, in the order of the metrics: (key, PointError,
        # est, gt), all computed by one grouped call (K8b, one launch).
        jobs = []
        p2p = (self.point_regressor is not None and "gt_v_shaped" in targets
               and "v_shaped" in stage)
        if "gt_v_shaped" in targets and "v_shaped" in stage:
            for name, pe in self.v2v_t_alignments.items():
                key = "v2v_t" if name == "translation" else f"v2v_t_{name}"
                jobs.append((key, pe, stage["v_shaped"],
                             targets["gt_v_shaped"]))
            if p2p:
                jobs.append(("p2p_t", None, None, None))
        if "gt_vertices" in targets and "vertices" in stage:
            for name, pe in self.v2v_alignments.items():
                key = "v2v" if name == "translation" else f"v2v_{name}"
                jobs.append((key, pe, stage["vertices"],
                             targets["gt_vertices"]))
        if "gt_joints3d" in targets and "joints" in stage:
            gt = targets["gt_joints3d"]
            est = stage["joints"][:, : gt.shape[1]]
            # The reference protocol drops the confidence channel and
            # takes a plain mean over all mapped joints.
            gt = gt[..., :3]
            for name, pe in self.alignments.items():
                jobs.append((f"mpjpe_{name}", pe, est, gt))
        mpjpe14 = set()
        if (self.j14_regressor is not None and "gt_joints14" in targets
                and "vertices" in stage):
            est14 = torch.einsum("jv,bvn->bjn", self.j14_regressor,
                                 stage["vertices"])
            gt14 = targets["gt_joints14"][..., :3]
            for name, pe in self.mpjpe14_alignments.items():
                mpjpe14.add(f"mpjpe14_{name}")
                jobs.append((f"mpjpe14_{name}", pe, est14, gt14))
        means = _point_error_means([j for j in jobs if j[1] is not None],
                                   plain)
        if p2p:
            reg = self.point_regressor
            means["p2p_t"] = (reg.plain if plain else reg)(
                stage["v_shaped"], targets["gt_v_shaped"],
                self.target_point_regressor).mean(dim=-1)
        valid = targets.get("joints14_valid")
        metrics: Dict[str, torch.Tensor] = {}
        for key, *_ in jobs:
            e = means[key]
            if key in mpjpe14 and valid is not None:
                # invalid samples -> NaN, skipped by the accumulator
                e = torch.where(valid.reshape(e.shape) > 0, e,
                                torch.full_like(e, float("nan")))
            metrics[key] = e

        meas = stage.get("measurements") or outputs.get("measurements")
        if meas is not None:
            for key in MEASUREMENT_KEYS:
                if key in targets:
                    gt = targets[key].reshape(meas[key].shape)
                    metrics[f"{key}_error"] = torch.abs(meas[key] - gt)
        return metrics

    # -- full run ----------------------------------------------------------
    def run(
        self,
        model_fn: Callable[[torch.Tensor, Optional[Dict]], Dict],
        dataloaders: Dict[str, Any],
        last_stage: str = "stage_02",
        on_batch: Optional[Callable[[Dict, Dict, Dict], None]] = None,
    ) -> Dict[str, Dict[str, float]]:
        """model_fn(images, model_batch) -> regressor outputs.
        dataloaders: name -> iterable of batch dicts with 'images',
        'targets', optional 'model_batch', 'genders', 'bmi_buckets' and
        'bmi_hist_groups'. ``on_batch(outputs, targets, metrics)``, if
        given, sees each batch's tensors. Returns {dataset:
        {metric[/group]: mean}} and keeps the per-BMI-group histogram
        means in ``self.bmi_histograms`` ({dataset: {metric: (6,) array,
        NaN for empty groups}})."""
        results: Dict[str, Dict[str, float]] = {}
        self.bmi_histograms: Dict[str, Dict[str, np.ndarray]] = {}
        for ds_name, loader in dataloaders.items():
            accs: Dict[str, MetricAccumulator] = defaultdict(
                MetricAccumulator)
            hist_sums: Dict[str, np.ndarray] = {}
            hist_counts: Dict[str, np.ndarray] = {}
            for batch in loader:
                targets = batch.get("targets", {})
                with torch.inference_mode():
                    outputs = model_fn(batch["images"],
                                       batch.get("model_batch"))
                    metrics = self.compute_batch_metrics(
                        outputs, targets, last_stage=last_stage)
                    if on_batch is not None:
                        on_batch(outputs, targets, metrics)
                    names = list(metrics)
                    # one device -> host copy per batch
                    host = (torch.stack([metrics[n].float() for n in names])
                            .cpu().numpy() if names else None)
                genders = batch.get("genders")
                bmis = batch.get("bmi_buckets")
                hist_groups = batch.get("bmi_hist_groups")
                groups = None
                if genders is not None:
                    groups = [str(g) for g in genders]
                    if bmis is not None:
                        groups = [f"{g}/{b}" for g, b in zip(groups, bmis)]
                for i, name in enumerate(names):
                    vals = host[i]
                    accs[name].update(vals, groups)
                    if hist_groups is None:
                        continue
                    hg = np.asarray(hist_groups).reshape(-1)
                    if name not in hist_sums:
                        n = len(BMI_HIST_NAMES)
                        hist_sums[name] = np.zeros(n)
                        hist_counts[name] = np.zeros(n, np.int64)
                    # NaN marks invalid samples: out of the bucket sums
                    valid = ((hg >= 0) & (hg < len(BMI_HIST_NAMES))
                             & np.isfinite(vals))
                    np.add.at(hist_sums[name], hg[valid], vals[valid])
                    np.add.at(hist_counts[name], hg[valid], 1)

            ds_result = {name: acc.mean for name, acc in accs.items()}
            for name, acc in accs.items():
                for group, val in acc.group_means().items():
                    ds_result[f"{name}/{group}"] = val
            results[ds_name] = ds_result
            self.bmi_histograms[ds_name] = {
                name: np.where(hist_counts[name] > 0,
                               sums / np.maximum(hist_counts[name], 1),
                               np.nan)
                for name, sums in hist_sums.items()}
        return results


def _load_j14(path: str) -> np.ndarray:
    if path.endswith(".pkl"):
        import pickle

        with open(path, "rb") as f:
            j14 = pickle.load(f, encoding="latin1")
    elif path.endswith(".npy"):
        j14 = np.load(path)
    else:
        raise ValueError(f"Unknown J14 regressor extension: {path}")
    if hasattr(j14, "todense"):  # scipy sparse pkl
        j14 = np.asarray(j14.todense())
    return np.asarray(j14)


def build_evaluator(exp_cfg: Optional[Dict] = None, keypoint_names=None,
                    device: str | torch.device = "cuda", **kwargs
                    ) -> Evaluator:
    """Evaluator from a config dict: v2v / v2v_t / mpjpe alignment sets and
    the mpjpe root joints from ``evaluation.body``, root-joint NAMES
    resolved against ``keypoint_names`` (the model's joint order), the
    P2P-20k regressor pickles from ``evaluation.body.p2p_t`` and the J14
    regressor (``.pkl`` or ``.npy``) from ``j14_regressor_path``.
    ``kwargs`` go to :class:`Evaluator` and win over the config, including
    ready ``point_regressor`` / ``target_point_regressor`` objects and a
    ``j14_regressor`` array."""
    cfg = dict(exp_cfg or {})
    eval_cfg = dict(cfg.get("evaluation") or {}).get("body") or {}
    p2p_cfg = dict(eval_cfg.get("p2p_t") or {})

    def point_errors(names, root=None):
        return {name: PointError(name, root=tuple(root)
                                 if (name == "root" and root) else None)
                for name in names}

    if "v2v" in eval_cfg and "v2v_alignments" not in kwargs:
        kwargs["v2v_alignments"] = point_errors(eval_cfg["v2v"])
    if "v2v_t" in eval_cfg and "v2v_t_alignments" not in kwargs:
        kwargs["v2v_t_alignments"] = point_errors(eval_cfg["v2v_t"])
    mpjpe_cfg = dict(eval_cfg.get("mpjpe") or {})
    if mpjpe_cfg and "alignments" not in kwargs:
        root_names = list(mpjpe_cfg.get("root_joints") or [])
        root = None
        if root_names and keypoint_names:
            kn = list(keypoint_names)
            root = [kn.index(n) for n in root_names if n in kn] or None
        if root_names and root is None:
            # A silent fall-through to joint-0 alignment would report
            # mpjpe_root under a different protocol than configured.
            logger.warning("mpjpe root_joints %s match none of the model's "
                           "keypoint names; falling back to joint 0 for the "
                           "'root' alignment", root_names)
        align_names = list(mpjpe_cfg.get("alignments")
                           or ("root", "procrustes"))
        kwargs["alignments"] = point_errors(align_names, root=root)
        # mpjpe14 reuses the same alignment set with the hips [2, 3]
        kwargs.setdefault("mpjpe14_alignments",
                          point_errors(align_names, root=[2, 3]))

    align = bool(p2p_cfg.get("align", True))
    in_path = os.path.expandvars(
        p2p_cfg.get("input_point_regressor_path", "") or "")
    tgt_path = os.path.expandvars(
        p2p_cfg.get("target_point_regressor_path", "") or "")
    if "point_regressor" not in kwargs and in_path and os.path.exists(
            in_path):
        kwargs["point_regressor"] = SparsePointRegressor.from_pickle(
            in_path, align=align, device=device)
        if (tgt_path and tgt_path != in_path and os.path.exists(tgt_path)
                and "target_point_regressor" not in kwargs):
            kwargs["target_point_regressor"] = (
                SparsePointRegressor.from_pickle(tgt_path, align=align,
                                                 device=device))
    j14_path = os.path.expandvars(cfg.get("j14_regressor_path", "") or "")
    if kwargs.get("j14_regressor") is None and j14_path and os.path.exists(
            j14_path):
        kwargs["j14_regressor"] = _load_j14(j14_path)
    return Evaluator(device=device, **kwargs)
