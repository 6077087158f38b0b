"""A2B / A2S: linguistic attributes (+ measurements) -> SMPL-X betas
(port of ``shapy_tpu/models/attributes/a2b.py``).

The config selects the input features; the two preprocessing modes are
whw2s (sqrt weight, at fit and predict time) and BodyTalk (cube-root mass,
x100 height, while the feature vector is built). :class:`A2B` is an
``nn.Module`` whose network is ``a2b`` (a reference Lightning A2B's
``state_dict`` names). It fits in closed form or with the network zoo's
``fit`` on a train / val / test split or leave-one-out, and validates
through an attached body model and measurement module (neither is a
submodule: they are the caller's, on the caller's device).

:meth:`A2B.validate` measures both meshes with K1 (``BodyMeasurements``,
the kernel on the card) and :meth:`A2B.fit_nn` trains with mesh-space
losses, its measurement terms through K1's forward and backward: one
launch each a step, the prediction and the target measured in one call.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from shapy_tpu_torch.models.attributes.b2a import _checkpoint_cfg
from shapy_tpu_torch.models.attributes.features import (
    build_feature_vector,
    feature_vector_tensor,
    select_features,
    to_whw2s,
)
from shapy_tpu_torch.models.attributes.networks import build_network
from shapy_tpu_torch.models.attributes.polynomial import Polynomial
from shapy_tpu_torch.utils.device import full_f32_matmul

MEASURED = ("height", "chest", "waist", "hips")


class A2B(nn.Module):
    def __init__(self, cfg: Optional[Dict] = None, body_model=None,
                 meas_module=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        cfg = dict(cfg or {}, **kwargs)
        self.cfg = cfg
        self.betas_size = int(cfg.get("num_shape_comps", 10))
        self.model_type = cfg.get("model_type", "smplx")
        self.model_gender = cfg.get("model_gender", "neutral")
        self.ds_gender = cfg.get("ds_gender", "female")
        self.bodytalk_meas_preprocess = bool(
            cfg.get("bodytalk_meas_preprocess", False)
        )
        reg = dict(cfg.get("regression") or {})
        self.whw2s_model = bool(reg.get("use_whw2s_setting", False))
        self.use_loo = bool(reg.get("use_loo", False))

        self.selected_attr, self.selected_attr_idx, self.selected_mmts = (
            select_features(cfg)
        )
        self.input_feature_size = len(self.selected_attr) + len(
            self.selected_mmts
        )
        self.a2b = build_network(cfg.get("network"),
                                 self.input_feature_size, self.betas_size,
                                 generator=generator)
        # Attached, not registered: the caller's modules on its device.
        self.attached = {"body_model": body_model,
                         "meas_module": meas_module}
        self.eval()

    @property
    def body_model(self):
        return self.attached["body_model"]

    @property
    def meas_module(self):
        return self.attached["meas_module"]

    @property
    def feature_names(self) -> List[str]:
        return list(self.selected_attr) + list(self.selected_mmts)

    # -- features ----------------------------------------------------------
    def create_input_feature_vec(self, batch: Dict) -> np.ndarray:
        """batch with 'rating' + measurement keys -> (B, n_features)."""
        return build_feature_vector(
            batch,
            self.selected_attr_idx,
            self.selected_mmts,
            self.bodytalk_meas_preprocess,
        )

    def preprocess(self, features: np.ndarray) -> np.ndarray:
        if self.whw2s_model:
            return to_whw2s(features, self.feature_names)
        return features

    def create_input_feature_vec_tensor(self, batch: Dict) -> torch.Tensor:
        """The feature vector inside the regressor's forward: the BodyTalk
        preprocessing only, no whw2s (a fit-time transform)."""
        return feature_vector_tensor(batch, self.selected_attr_idx,
                                     self.selected_mmts,
                                     self.bodytalk_meas_preprocess)

    # -- inference ---------------------------------------------------------
    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return self.a2b(features)

    def predict(self, features) -> np.ndarray:
        return self.a2b.predict(self.preprocess(np.asarray(features)))

    def _shape(self, betas) -> torch.Tensor:
        body = self.body_model
        assert body is not None, "attach a body model first"
        betas = torch.as_tensor(np.asarray(betas), dtype=torch.float32,
                                device=body.v_template.device)
        with torch.no_grad(), full_f32_matmul():
            return body.forward_shape(betas)["v_shaped"]

    def predict_shape(self, features) -> Tuple[np.ndarray, torch.Tensor]:
        """features -> (betas, v_shaped on the body model's device)."""
        betas = self.predict(features).astype(np.float32)
        return betas, self._shape(betas)

    # -- fitting -----------------------------------------------------------
    def _tvt(self, db: Dict) -> Tuple:
        beta_key = f"betas_{self.model_type}_{self.model_gender}"
        out = []
        for split in ("train", "val", "test"):
            d = db[split]
            out.append(
                (
                    self.create_input_feature_vec(d),
                    np.asarray(d[beta_key])[:, : self.betas_size],
                )
            )
        return tuple(out)

    def fit(self, db: Dict, generator: Optional[torch.Generator] = None
            ) -> Dict[str, Dict[str, float]]:
        (xtr, ytr), (xval, yval), (xte, yte) = self._tvt(db)
        self.a2b.fit(self.preprocess(xtr), ytr, generator=generator)
        report = {}
        for name, (x, y) in (("val", (xval, yval)), ("test", (xte, yte))):
            pred = self.a2b.predict(self.preprocess(x))
            report[name] = self.validate(y, pred)
        return report

    def nn_loss(self, xb: torch.Tensor, yb: torch.Tensor,
                v2v_weight: float = 1.0, betas_weight: float = 0.0,
                edge_weight: float = 0.0,
                meas_weights: Optional[Dict[str, float]] = None,
                edges=None) -> torch.Tensor:
        """``fit_nn``'s loss of one batch: mean v2v of the shaped meshes,
        the betas' MSE, the edge loss and, per measurement, its weight
        times its mean absolute error. The predicted and target meshes are
        measured in one call."""
        body, meas = self.body_model, self.meas_module
        meas_weights = dict(meas_weights or {})
        pred_betas = self.a2b(xb)
        pred_out = body.forward_shape(pred_betas)["v_shaped"]
        gt_out = body.forward_shape(yb)["v_shaped"]
        loss = xb.new_zeros(())
        if v2v_weight > 0:
            loss = loss + v2v_weight * torch.mean(
                torch.linalg.vector_norm(pred_out - gt_out, dim=-1))
        if betas_weight > 0:
            loss = loss + betas_weight * torch.mean((pred_betas - yb) ** 2)
        if edge_weight > 0:
            from shapy_tpu_torch.losses.losses import vertex_edge_loss

            loss = loss + edge_weight * vertex_edge_loss(pred_out, gt_out,
                                                         edges)
        if meas_weights and meas is not None:
            B = xb.shape[0]
            both = meas.forward_from_vertices(
                torch.cat([pred_out, gt_out.detach()]))["measurements"]
            for k, w in meas_weights.items():
                if w > 0:
                    m = both[k]["tensor"]
                    loss = loss + w * torch.mean(torch.abs(m[:B] - m[B:]))
        return loss

    def fit_nn_step(self, optimizer: torch.optim.Optimizer,
                    xb: torch.Tensor, yb: torch.Tensor, **weights
                    ) -> torch.Tensor:
        """One Adam step on :meth:`nn_loss`; returns the loss."""
        with full_f32_matmul():
            loss = self.nn_loss(xb, yb, **weights)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        optimizer.step()
        return loss.detach()

    def fit_nn(
        self,
        db: Dict,
        v2v_weight: float = 1.0,
        betas_weight: float = 0.0,
        edge_weight: float = 0.0,
        meas_weights: Optional[Dict[str, float]] = None,
        num_steps: int = 2000,
        learning_rate: float = 1e-3,
        batch_size: int = 256,
        seed: int = 0,
        generator: Optional[torch.Generator] = None,
        on_step: Optional[Callable[[int, torch.Tensor], None]] = None,
    ) -> Dict[str, Dict[str, float]]:
        """NN training with mesh-space losses (:meth:`nn_loss`) through the
        attached body model (and measurement module for the measurement
        terms), ``num_steps`` Adam steps on ``batch_size`` rows drawn with
        replacement from ``generator`` (CPU, seeded with ``seed`` when
        None); ``on_step(step, loss)`` sees each step's loss. Returns the
        val split's :meth:`validate`."""
        from shapy_tpu_torch.core.geometry import faces_to_edges

        net = self.a2b
        assert not isinstance(net, Polynomial), (
            "fit_nn requires an NN network type (mlp/resnet/moe)"
        )
        body = self.body_model
        assert body is not None, "attach a body model"
        (xtr, ytr), (xval, yval), _ = self._tvt(db)
        dev = net.device
        X = torch.as_tensor(self.preprocess(xtr), dtype=torch.float32,
                            device=dev)
        Y = torch.as_tensor(np.asarray(ytr), dtype=torch.float32,
                            device=dev)
        weights = dict(v2v_weight=v2v_weight, betas_weight=betas_weight,
                       edge_weight=edge_weight, meas_weights=meas_weights,
                       edges=(faces_to_edges(body.faces)
                              if edge_weight > 0 else None))
        net.eval()
        net.requires_grad_(True)
        optimizer = torch.optim.Adam(net.parameters(), lr=learning_rate)
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        rows = torch.randint(0, X.shape[0], (
            num_steps, min(batch_size, X.shape[0])),
            generator=generator).to(dev)
        for step, idx in enumerate(rows):
            loss = self.fit_nn_step(optimizer, X[idx], Y[idx], **weights)
            if on_step is not None:
                on_step(step, loss)
        pred = self.a2b.predict(self.preprocess(xval))
        return {"val": self.validate(yval, pred)}

    def fit_loo(self, features: np.ndarray, betas: np.ndarray
                ) -> Dict[str, float]:
        """Leave-one-out cross-validation."""
        n = features.shape[0]
        preds = np.zeros_like(betas[:, : self.betas_size])
        for i in range(n):
            mask = np.arange(n) != i
            self.a2b.fit(
                self.preprocess(features[mask]),
                betas[mask, : self.betas_size],
            )
            preds[i] = self.a2b.predict(self.preprocess(features[i:i + 1]))[0]
        return self.validate(betas[:, : self.betas_size], preds)

    # -- metrics -----------------------------------------------------------
    def validate(self, gt_betas: np.ndarray, pred_betas: np.ndarray
                 ) -> Dict[str, float]:
        """betas L1; with a body model the v2v (mm) of the shaped meshes,
        each moved to its mean; with a measurement module too, the MAEs of
        height, chest, waist, hips (mm) and mass (kg) on those meshes."""
        out: Dict[str, float] = {
            "betas_l1": float(np.abs(gt_betas - pred_betas).mean())
        }
        if self.body_model is None:
            return out
        gt_v = self._shape(gt_betas).cpu().numpy()
        pr_v = self._shape(pred_betas).cpu().numpy()
        gt_v = gt_v - gt_v.mean(axis=1, keepdims=True)
        pr_v = pr_v - pr_v.mean(axis=1, keepdims=True)
        out["v2v_mm"] = float(
            np.linalg.norm(gt_v - pr_v, axis=-1).mean() * 1000.0
        )
        meas = self.meas_module
        if meas is not None:
            dev = self.body_model.v_template.device
            with torch.no_grad(), full_f32_matmul():
                gt_m, pr_m = (
                    {k: v["tensor"].cpu().numpy() for k, v in
                     meas.forward_from_vertices(torch.from_numpy(v).to(dev))[
                         "measurements"].items()}
                    for v in (gt_v, pr_v))
            for k in MEASURED:
                out[f"{k}_mae_mm"] = float(
                    np.abs(gt_m[k] - pr_m[k]).mean() * 1000.0)
            out["mass_mae_kg"] = float(
                np.abs(gt_m["mass"] - pr_m["mass"]).mean())
        return out

    # -- checkpoint I/O ----------------------------------------------------
    @classmethod
    def load_from_checkpoint(cls, path: str, cfg: Optional[Dict] = None,
                             **kwargs) -> "A2B":
        """A reference Lightning checkpoint, any network type: its
        ``hyper_parameters['cfg']`` (updated by ``cfg``) builds the model
        (``kwargs``: ``body_model``, ``meas_module``), its ``a2b.`` block
        loads into ``a2b``."""
        from shapy_tpu_torch.models.attributes.ckpt_import import (
            network_from_state_dict,
        )

        conf, sd = _checkpoint_cfg(path, cfg)
        obj = cls(conf, **kwargs)
        if any(k.startswith("a2b.") for k in sd):
            obj.a2b = network_from_state_dict(
                conf.get("network"), obj.input_feature_size,
                obj.betas_size, sd, "a2b.")
        return obj
