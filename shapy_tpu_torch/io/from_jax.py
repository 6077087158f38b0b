"""Weights of the JAX package -> the port's modules.

The JAX regressor's params are a pytree ``{'backbone': {name: array},
'head': {name: array}, 'param_mean': array}`` whose leaf names are
already torch ``state_dict`` names. Converting is flattening the pytree
with ``.`` and transposing conv kernels HWIO -> OIHW; the MLP and
``param_mean`` load as they are. The body model's params (``v_template``,
``shapedirs``, ``posedirs`` ... all of them) and the discriminators'
(dense weights in the JAX layout, the spectral-norm ``u`` buffers among
them) load by name. The attribute models' networks and probabilistic
heads convert by their flax names (:func:`attribute_network_state_dict`,
:func:`prob_head_state_dict`).

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


def load_discriminator_from_jax(disc: nn.Module, params: Mapping
                                ) -> nn.Module:
    """A JAX discriminator's ``params`` (``HMRDiscriminator``'s layers with
    their spectral-norm ``u`` vectors, or ``PoseDiscriminator``'s MLPs) ->
    the port's discriminator of the same type and sizes. Every param and
    every ``u`` loads; one missing or extra raises ``KeyError``."""
    return load_from_jax(disc, params)


# -- the attribute models ---------------------------------------------------

def _dense(p: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    """A flax Dense ``{'kernel': (in, out), 'bias'}`` -> a torch Linear's
    ``weight`` (out, in) / ``bias`` under ``prefix``."""
    return {f"{prefix}weight": np.asarray(p["kernel"]).T,
            f"{prefix}bias": np.asarray(p["bias"])}


def _mlp_sd(p: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    n = sum(1 for k in p if k.startswith("Dense_")) - 1
    sd: Dict[str, np.ndarray] = {}
    for i in range(n):
        sd.update(_dense(p[f"Dense_{i}"], f"{prefix}layers.{i}.fc."))
        if f"prelu_{i}" in p:
            sd[f"{prefix}layers.{i}.activ.weight"] = np.asarray(
                p[f"prelu_{i}"])
    sd.update(_dense(p[f"Dense_{n}"], f"{prefix}output_layer."))
    return sd


def _resnet_sd(p: Mapping) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    if "projection" in p:
        sd.update(_dense(p["projection"], "projection.fc."))
    if "projection_prelu" in p:
        sd["projection.activ.weight"] = np.asarray(p["projection_prelu"])
    n = sum(1 for k in p if k.startswith("block_"))
    for i in range(n):
        blk = p[f"block_{i}"]
        for name in ("linear1", "linear2"):
            sd.update(_dense(blk[name], f"network.{i}.{name}."))
        if "downsample" in blk:
            sd.update(_dense(blk["downsample"], f"network.{i}.downsample.0."))
        if "act_weight" in blk:
            sd[f"network.{i}.act.weight"] = np.asarray(blk["act_weight"])
    sd.update(_dense(p["final"], f"network.{n}."))
    return sd


def _inner_sd(net: nn.Module, p: Mapping, prefix: str) -> Dict:
    from shapy_tpu_torch.models.attributes.networks import LinearNet

    if isinstance(net, LinearNet):
        return _dense(p["Dense_0"], prefix)
    return _mlp_sd(p, prefix)


def attribute_network_state_dict(net: nn.Module, variables: Mapping
                                 ) -> Dict[str, torch.Tensor]:
    """A JAX attribute network's weights -> the state dict of ``net``,
    the port's network of the same type and sizes: a ``Polynomial``'s
    params ``{'weight', 'bias'}``, or a flax network's variables
    ``{'params': ..., 'buffers': ...}`` (MLP, ResNet1D, MixtureOfExperts,
    MixtureOfInputExperts, IterativeRegressorRNN with its RNN cells'
    ``weight_ih`` / ``weight_hh`` stacks and learned states, LinearNet,
    SimpleNet)."""
    from shapy_tpu_torch.models.attributes import networks as zoo

    if isinstance(net, zoo.Polynomial):
        sd = {"linear.weight": np.asarray(variables["weight"]),
              "linear.bias": np.asarray(variables["bias"])}
        return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    p = variables["params"]
    if isinstance(net, zoo.MLP):
        sd = _mlp_sd(p)
    elif isinstance(net, zoo.ResNet1D):
        sd = _resnet_sd(p)
    elif isinstance(net, zoo.SimpleNet):
        sd = {}
        for j in range(3):
            sd.update(_dense(p[f"Dense_{j}"], f"{2 * j}."))
    elif isinstance(net, zoo.LinearNet):
        sd = _dense(p["Dense_0"], "")
    elif isinstance(net, (zoo.MixtureOfExperts, zoo.MixtureOfInputExperts)):
        sd = _inner_sd(net.gating, p["gating"], "gating.")
        for i, expert in enumerate(net.ffns):
            sd.update(_inner_sd(expert, p[f"expert_{i}"], f"ffns.{i}."))
    elif isinstance(net, zoo.IterativeRegressorRNN):
        reg = p["regressor"]
        sd = _dense(reg["output"], "regressor.output.")
        cell = net.regressor
        for li in range(len(cell.rnn_list)):
            for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                sd[f"regressor.rnn_list.{li}.{name}"] = np.asarray(
                    reg[f"{name}_l{li}"])
            for s in range(cell.num_states):
                key = f"state{s:02d}_l{li}"
                if key in reg:
                    sd[f"regressor.hidden_state."
                       f"{li * cell.num_states + s}"] = np.asarray(reg[key])
        mean = dict(variables.get("buffers") or {}).get("param_mean")
        sd["param_mean"] = (np.zeros(net.param_mean.shape, np.float32)
                            if mean is None else np.asarray(mean))
    else:
        raise TypeError(f"no JAX weights for {type(net).__name__}")
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in
            sd.items()}


def load_attribute_network_from_jax(net: nn.Module, variables: Mapping
                                    ) -> nn.Module:
    """Load :func:`attribute_network_state_dict` into ``net`` (every
    parameter and buffer, nothing missing or extra)."""
    net.load_state_dict(attribute_network_state_dict(net, variables))
    return net


def prob_head_state_dict(module: nn.Module, params: Mapping
                         ) -> Dict[str, torch.Tensor]:
    """A JAX probabilistic head's ``params`` -> the state dict of the
    port's ``MVNHead`` (hidden Dense_i -> ``layers.i``, then ``mean``,
    ``diag``, ``off``) or ``ConditionalFlow`` (``layers_i`` ->
    ``layers.i``, each coupling's Dense_0..3 -> ``fc1``, ``fc2``,
    ``scale``, ``shift``)."""
    from shapy_tpu_torch.models.attributes.prob import (
        ConditionalFlow,
        MVNHead,
    )

    sd: Dict[str, np.ndarray] = {}
    if isinstance(module, MVNHead):
        n = len(module.layers)
        for i in range(n):
            sd.update(_dense(params[f"Dense_{i}"], f"layers.{i}."))
        for j, name in enumerate(("mean", "diag", "off")):
            sd.update(_dense(params[f"Dense_{n + j}"], f"{name}."))
    elif isinstance(module, ConditionalFlow):
        for i in range(len(module.layers)):
            layer = params[f"layers_{i}"]
            for j, name in enumerate(("fc1", "fc2", "scale", "shift")):
                sd.update(_dense(layer[f"Dense_{j}"], f"layers.{i}.{name}."))
    else:
        raise TypeError(f"no JAX weights for {type(module).__name__}")
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in
            sd.items()}
