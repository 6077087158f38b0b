"""Weights of the JAX package -> the port's modules.

The JAX regressor's params are a pytree ``{'backbone': {name: array},
'head': {name: array}, 'param_mean': array}`` whose leaf names are
already torch ``state_dict`` names. Converting is flattening the pytree
with ``.`` and transposing conv kernels HWIO -> OIHW; the MLP and
``param_mean`` load as they are. The body model's params (``v_template``,
``shapedirs``, ``posedirs`` ... all of them) load by name.

Load before :meth:`BodyRegressor.prepare_for_eval_`, which folds BN and
so changes the backbone's keys, or before
:meth:`BodyRegressor.prepare_for_train_`, which keeps every BN unfolded
with the running stats loaded here, so that a train step starts from the
JAX package's state. The reverse direction, :func:`state_dict_from_jax`
on a JAX gradient or updated-param pytree, names it as the port does.
Inputs are numpy arrays (or anything ``np.asarray`` takes), never jax
objects imported here.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

import numpy as np
import torch
from torch import nn


def state_dict_from_jax(params: Mapping, prefix: str = ""
                        ) -> Dict[str, torch.Tensor]:
    """Flatten nested param dicts to ``{dotted.name: tensor}``, with every
    4-D array (an HWIO conv kernel) transposed to OIHW."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in params.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(state_dict_from_jax(value, prefix=f"{name}."))
            continue
        arr = np.asarray(value)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        out[name] = torch.from_numpy(np.array(arr, order="C"))
    return out


def load_from_jax(module: nn.Module, params: Mapping,
                  ignore: Iterable[str] = ()) -> nn.Module:
    """Copy ``params`` into ``module``. Every key must land on a
    parameter or buffer of the same shape; module keys under a prefix in
    ``ignore`` may stay unloaded (e.g. ``model.`` when loading only the
    regressor's own weights)."""
    sd = state_dict_from_jax(params)
    missing, unexpected = module.load_state_dict(sd, strict=False)
    ignore = tuple(ignore)
    missing = [k for k in missing if not k.startswith(ignore)]
    if missing or unexpected:
        raise KeyError(f"from_jax: missing {missing[:8]}, unexpected "
                       f"{unexpected[:8]}")
    return module


def load_regressor_from_jax(regressor: nn.Module, params: Mapping
                            ) -> nn.Module:
    """The JAX regressor's ``params`` -> the port's regressor of the same
    family (``SMPLRegressor``, ``SMPLHRegressor`` or ``SMPLXRegressor``,
    built from the same config and mean files; its body model keeps its
    own params)."""
    return load_from_jax(
        regressor,
        {k: params[k] for k in ("backbone", "head", "param_mean")},
        ignore=("model.",))


def load_body_model_from_jax(model: nn.Module, params: Mapping) -> nn.Module:
    """The JAX body model's ``params`` -> the port's body model, built with
    the same options. Every param loads; one the port lacks, or a port
    buffer the params lack, raises ``KeyError``."""
    return load_from_jax(model, params)
