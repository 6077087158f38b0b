"""The attribute models' network zoo (port of
``shapy_tpu/models/attributes/networks.py``).

Every network is an :class:`~.base.AttributeNetwork` (an ``nn.Module``
with ``predict`` / ``fit``) whose parameter names are the reference's
torch names (``attributes_betas/models.py``), so that the ``a2b.`` /
``b2a.`` block of a reference Lightning checkpoint loads through
``load_state_dict`` (:mod:`.ckpt_import`):

* :class:`MLP`: ``layers.{i}`` (``FCNormActiv``: ``fc``, optional
  ``norm_layer``, ``activ``) and ``output_layer``;
* :class:`ResNet1D`: optional ``projection`` (an ``FCNormActiv``), then
  ``network.{i}`` (:class:`ResBlock1D`: ``linear1``, ``norm1``,
  ``linear2``, ``norm2``, ``act``, ``downsample.0`` / ``.1``) and the last
  Linear ``network.{n}``;
* :class:`MixtureOfExperts` / :class:`MixtureOfInputExperts`: ``gating``
  and ``ffns.{i}``;
* :class:`IterativeRegressorRNN`: ``regressor.rnn_list.{l}`` (an
  ``nn.GRUCell`` / ``nn.LSTMCell``), ``regressor.output``,
  ``regressor.hidden_state.{n}`` (learned initial states) and the
  ``param_mean`` buffer;
* :class:`SimpleNet`: ``0``, ``2``, ``4`` (a Linear-ReLU stack);
  :class:`LinearNet`: ``weight`` / ``bias``.

Normalization: with ``normalization: {type: bn}`` in its config (or a
checkpoint that holds BN statistics) a linear is followed by a
``BatchNorm1d``, run in eval mode on its running statistics, where the
JAX package folds it into the linear at import. Without it the networks
are the JAX package's plain ones. Every linear keeps its bias (the JAX
package's Dense layers have one); a checkpoint without it loads a zero.

PReLU slopes are shared ``(1,)`` or per-feature ``(C,)``, the shape the
loaded slope has. ``build_network`` is the JAX package's factory;
``generator`` draws the initial weights (torch's default
distributions).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from shapy_tpu_torch.models.attributes.base import AttributeNetwork
from shapy_tpu_torch.models.attributes.polynomial import Polynomial

BATCH_NORM_TYPES = ("bn", "batch-norm", "batch_norm", "batchnorm")


def activ_name(cfg) -> str:
    """The reference's activation cfg ({'type': 'relu'} / 'leaky-relu' /
    ...) -> one normalised name."""
    if isinstance(cfg, dict):
        cfg = cfg.get("type", "relu")
    name = str(cfg or "relu").replace("-", "_")
    return {"lrelu": "leaky_relu", "none": "linear"}.get(name, name)


def uses_batch_norm(sub_cfg: Dict) -> bool:
    norm = sub_cfg.get("normalization")
    if isinstance(norm, dict):
        norm = norm.get("type")
    return str(norm or "none").lower() in BATCH_NORM_TYPES


# torch and jax defaults agree (LeakyReLU slope 0.01, ELU alpha 1.0); GELU
# is flax's tanh approximation.
_ACTIVATIONS = {
    "relu": F.relu,
    "leaky_relu": F.leaky_relu,
    "elu": F.elu,
    "selu": F.selu,
    "celu": F.celu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "swish": F.silu,
    "softplus": F.softplus,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "linear": lambda x: x,
}


class Activation(nn.Module):
    """A parameterless activation by normalised name."""

    def __init__(self, name: str):
        super().__init__()
        if name == "prelu":
            raise ValueError(
                "prelu needs a slope parameter; only MLP/ResNet1D (and the "
                "MoE variants built on them) support it")
        if name not in _ACTIVATIONS:
            raise ValueError(f"Unknown activation: {name}")
        self.name = name
        self.fn = _ACTIVATIONS[name]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


class PReLU(nn.Module):
    """torch ``nn.PReLU``'s semantics, its slope ``weight`` shared (1,)
    or per-feature (C,): a loaded slope brings its own shape."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight * x)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        w = state_dict.get(prefix + "weight")
        if w is not None and tuple(w.shape) != tuple(self.weight.shape):
            self.weight = nn.Parameter(self.weight.new_empty(w.shape))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def make_activation(name: str) -> nn.Module:
    return PReLU() if name == "prelu" else Activation(name)


class FCNormActiv(nn.Module):
    """``fc``, optional ``norm_layer`` (BatchNorm1d), ``activ``, then
    dropout."""

    def __init__(self, in_dim: int, out_dim: int, activation: str = "relu",
                 batch_norm: bool = False, dropout: float = 0.0):
        super().__init__()
        self.fc = nn.Linear(in_dim, out_dim)
        if batch_norm:
            self.norm_layer = nn.BatchNorm1d(out_dim)
        self.activ = make_activation(activation)
        self.dropout = nn.Dropout(dropout) if dropout > 0 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc(x)
        if hasattr(self, "norm_layer"):
            x = self.norm_layer(x)
        x = self.activ(x)
        if self.dropout is not None:
            x = self.dropout(x)
        return x


class MLP(AttributeNetwork):
    """Plain MLP; ``prelu`` has one learnable slope a layer."""

    def __init__(self, input_dim: int, output_dim: int,
                 hidden_dims: Sequence[int] = (256, 256),
                 activation: str = "relu", dropout: float = 0.0,
                 batch_norm: bool = False):
        super().__init__()
        dims = [int(input_dim), *[int(h) for h in hidden_dims]]
        self.layers = nn.ModuleList(
            FCNormActiv(a, b, activation, batch_norm, dropout)
            for a, b in zip(dims[:-1], dims[1:]))
        self.output_layer = nn.Linear(dims[-1], int(output_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return self.output_layer(x)


class ResBlock1D(nn.Module):
    """The reference's BasicBlock: two linears (each with its norm) and
    the activation before the residual add, a linear ``downsample`` where
    the width changes, no activation after the add; a ``prelu`` block
    shares one slope ``act`` between both linears."""

    def __init__(self, in_dim: int, width: int, activation: str = "relu",
                 batch_norm: bool = False):
        super().__init__()
        self.linear1 = nn.Linear(in_dim, width)
        self.linear2 = nn.Linear(width, width)
        if batch_norm:
            self.norm1 = nn.BatchNorm1d(width)
            self.norm2 = nn.BatchNorm1d(width)
        self.act = make_activation(activation)
        if in_dim != width:
            down: List[nn.Module] = [nn.Linear(in_dim, width)]
            if batch_norm:
                down.append(nn.BatchNorm1d(width))
            self.downsample = nn.Sequential(*down)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.linear1(x)
        if hasattr(self, "norm1"):
            h = self.norm1(h)
        h = self.act(h)
        h = self.linear2(h)
        if hasattr(self, "norm2"):
            h = self.norm2(h)
        h = self.act(h)
        if hasattr(self, "downsample"):
            x = self.downsample(x)
        return x + h


class ResNet1D(AttributeNetwork):
    """Optional projection to ``layers[0]``, one block a width of
    ``layers``, and a final linear; the activation reaches the projection
    and every block."""

    def __init__(self, input_dim: int, output_dim: int,
                 layers: Sequence[int] = (256, 256), proj_layer: bool = True,
                 activation: str = "relu", batch_norm: bool = False):
        super().__init__()
        layers = [int(v) for v in layers]
        d = int(input_dim)
        if proj_layer:
            self.projection = FCNormActiv(d, layers[0], activation,
                                          batch_norm)
            d = layers[0]
        blocks: List[nn.Module] = []
        for width in layers:
            blocks.append(ResBlock1D(d, width, activation, batch_norm))
            d = width
        blocks.append(nn.Linear(d, int(output_dim)))
        self.network = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "projection"):
            x = self.projection(x)
        return self.network(x)


class LinearNet(AttributeNetwork):
    """One linear map, its parameters ``weight`` / ``bias`` (a bare
    ``nn.Linear`` in the reference)."""

    def __init__(self, input_dim: int, output_dim: int):
        super().__init__()
        ref = nn.Linear(int(input_dim), int(output_dim))
        self.weight = ref.weight
        self.bias = ref.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class SimpleNet(AttributeNetwork):
    """Three linears with ReLUs, their widths stepping from the input's to
    the output's in thirds; named ``0``, ``2``, ``4`` as the reference's
    ``nn.Sequential``."""

    def __init__(self, input_dim: int, output_dim: int):
        super().__init__()
        l1 = int(input_dim - (input_dim - output_dim) / 3)
        l2 = int(input_dim - 2 * (input_dim - output_dim) / 3)
        self.add_module("0", nn.Linear(int(input_dim), l1))
        self.add_module("2", nn.Linear(l1, l2))
        self.add_module("4", nn.Linear(l2, int(output_dim)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(getattr(self, "0")(x))
        x = F.relu(getattr(self, "2")(x))
        return getattr(self, "4")(x)


class MixtureOfExperts(AttributeNetwork):
    """Soft mixture of ``num_experts`` MLP experts; the gate is an MLP of
    the same config, softmaxed over the experts."""

    def __init__(self, input_dim: int, output_dim: int,
                 num_experts: int = 4, hidden_dims: Sequence[int] = (128,),
                 activation: str = "relu", batch_norm: bool = False):
        super().__init__()
        self.gating = MLP(input_dim, num_experts, hidden_dims, activation,
                          batch_norm=batch_norm)
        self.ffns = nn.ModuleList(
            MLP(input_dim, output_dim, hidden_dims, activation,
                batch_norm=batch_norm)
            for _ in range(int(num_experts)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = torch.softmax(self.gating(x), dim=-1)
        outs = torch.stack([f(x) for f in self.ffns], dim=-1)  # (B, out, E)
        return torch.einsum("boe,be->bo", outs, gate)


class MixtureOfInputExperts(AttributeNetwork):
    """One expert a scalar input feature, each seeing only its own
    column, mixed by a softmax gate over the whole input; the experts and
    the gate are MLPs or (``expert_type='linear'``) bare linears."""

    def __init__(self, input_dim: int, output_dim: int,
                 expert_type: str = "mlp",
                 expert_layers: Sequence[int] = (64,),
                 activation: str = "relu", batch_norm: bool = False):
        super().__init__()

        def make(d_in: int, d_out: int) -> nn.Module:
            if expert_type == "linear":
                return LinearNet(d_in, d_out)
            return MLP(d_in, d_out, expert_layers, activation,
                       batch_norm=batch_norm)

        self.gating = make(input_dim, input_dim)
        self.ffns = nn.ModuleList(make(1, output_dim)
                                  for _ in range(int(input_dim)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = torch.softmax(self.gating(x), dim=-1)
        outs = torch.stack([f(x[:, i:i + 1])
                            for i, f in enumerate(self.ffns)], dim=1)
        return torch.sum(gate[..., None] * outs, dim=1)


class MultiLayerRNNCell(nn.Module):
    """A stack of ``nn.GRUCell`` / ``nn.LSTMCell`` (``rnn_list``) and the
    linear ``output``. Each layer reads its parent's new hidden state,
    with dropout between layers; ``output`` reads the last hidden state
    before dropout. (The reference's own forward feeds the raw input to
    every layer and crashes for more than one layer or LSTM with dropout;
    this is the JAX package's reading, the same on the configurations the
    reference runs.) With ``learn_state`` the initial states are
    parameters ``hidden_state.{n}``, n = layer x states + state (h, then
    c for LSTM), each (1, H)."""

    def __init__(self, input_dim: int, output_dim: int,
                 hidden_dims: Sequence[int] = (1024,),
                 cell_type: str = "lstm", dropout: float = 0.0,
                 learn_state: bool = False):
        super().__init__()
        self.lstm = cell_type == "lstm"
        if cell_type not in ("lstm", "gru"):
            raise ValueError(f"Unknown RNN cell type: {cell_type}")
        self.num_states = 2 if self.lstm else 1
        self.hidden_dims = [int(h) for h in hidden_dims]
        cell = nn.LSTMCell if self.lstm else nn.GRUCell
        dims = [int(input_dim), *self.hidden_dims]
        self.rnn_list = nn.ModuleList(cell(a, b) for a, b in
                                      zip(dims[:-1], dims[1:]))
        self.output = nn.Linear(dims[-1], int(output_dim))
        self.dropout = nn.Dropout(dropout) if dropout > 0 else None
        if learn_state:
            self.hidden_state = nn.ParameterList(
                nn.Parameter(torch.zeros(1, h)) for h in self.hidden_dims
                for _ in range(self.num_states))

    def initial_state(self, B: int, like: torch.Tensor):
        state = []
        for li, H in enumerate(self.hidden_dims):
            if hasattr(self, "hidden_state"):
                s = [self.hidden_state[li * self.num_states + n].expand(B, H)
                     for n in range(self.num_states)]
            else:
                s = [like.new_zeros(B, H) for _ in range(self.num_states)]
            state.append(tuple(s))
        return state

    def forward(self, x: torch.Tensor, state=None):
        if state is None:
            state = self.initial_state(x.shape[0], x)
        new_state = []
        inp = x
        for cell, layer_state in zip(self.rnn_list, state):
            if self.lstm:
                h, c = cell(inp, tuple(layer_state))
                new_state.append((h, c))
            else:
                h = cell(inp, layer_state[0])
                new_state.append((h,))
            inp = h if self.dropout is None else self.dropout(h)
        return self.output(h), tuple(new_state)


class IterativeRegressorRNN(AttributeNetwork):
    """HMR-style refinement with a recurrent ``regressor``: its input is
    [features (+ param_mean)] at every stage (the mean is never replaced
    by the running estimate), only the RNN state evolves, and the deltas
    add up onto the mean."""

    def __init__(self, input_dim: int, output_dim: int,
                 hidden_dims: Sequence[int] = (1024,),
                 cell_type: str = "lstm", dropout: float = 0.0,
                 learn_state: bool = False, append_params: bool = True,
                 num_stages: int = 3):
        super().__init__()
        self.append_params = append_params
        self.num_stages = int(num_stages)
        self.register_buffer("param_mean", torch.zeros(int(output_dim)))
        reg_in = int(input_dim) + (int(output_dim) if append_params else 0)
        self.regressor = MultiLayerRNNCell(reg_in, output_dim, hidden_dims,
                                           cell_type, dropout, learn_state)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cond = self.param_mean[None].expand(x.shape[0], -1)
        reg_input = torch.cat([x, cond], -1) if self.append_params else x
        deltas, state = self.regressor(reg_input, None)
        params = cond + deltas
        for _ in range(1, self.num_stages):
            deltas, state = self.regressor(reg_input, state)
            params = params + deltas
        return params


@torch.no_grad()
def reset_parameters_(net: nn.Module, generator: torch.Generator
                      ) -> nn.Module:
    """Draw ``net``'s weights from ``generator`` with torch's default
    distributions: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every linear's
    weight and bias, U(-1/sqrt(H), 1/sqrt(H)) for the RNN cells, ones /
    zeros for BN, 0.25 for PReLU; learned RNN states stay zero."""
    for m in net.modules():
        if isinstance(m, (nn.Linear, LinearNet)):
            bound = 1.0 / math.sqrt(m.weight.shape[1])
            for p in (m.weight, m.bias):
                p.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, (nn.GRUCell, nn.LSTMCell)):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for p in (m.weight_ih, m.weight_hh, m.bias_ih, m.bias_hh):
                p.uniform_(-bound, bound, generator=generator)
    return net


def build_network(
    network_cfg: Optional[Dict[str, Any]],
    input_dim: int,
    output_dim: int,
    batch_norm: Optional[bool] = None,
    generator: Optional[torch.Generator] = None,
) -> AttributeNetwork:
    """The JAX package's factory: ``network_cfg['type']`` (polynomial,
    mlp, resnet, moe, imoe, iterative, linear, simple) with its sub-config.
    ``batch_norm`` None reads the sub-config's ``normalization``;
    ``generator`` (seed 0 when None) draws the initial weights. The
    network is in eval mode, with ``fit``'s learning rate and step count
    from the sub-config."""
    cfg = dict(network_cfg or {})
    net_type = cfg.get("type", "polynomial")
    if net_type == "polynomial":
        sub = dict(cfg.get("polynomial") or {})
        return Polynomial(
            input_dim,
            output_dim,
            degree=int(sub.get("degree", 2)),
            alpha=float(sub.get("alpha", 0.0)),
        )
    cfg_key = {"mixture-of-experts": "moe",
               "mixture-of-input-experts": "imoe"}.get(net_type, net_type)
    sub = dict(cfg.get(cfg_key) or {})
    bn = uses_batch_norm(sub) if batch_norm is None else bool(batch_norm)
    if net_type == "mlp":
        net = MLP(input_dim, output_dim,
                  tuple(sub.get("layers", sub.get("hidden_dims",
                                                  (256, 256)))),
                  activ_name(sub.get("activation", "relu")),
                  float(sub.get("dropout", 0.0)), bn)
    elif net_type == "resnet":
        layers = sub.get("layers")
        if layers is None:
            layers = (int(sub.get("width", 256)),) * int(sub.get("depth", 3))
        net = ResNet1D(input_dim, output_dim, tuple(int(v) for v in layers),
                       bool(sub.get("proj_layer", True)),
                       activ_name(sub.get("activation", "relu")), bn)
    elif net_type in ("moe", "mixture-of-experts"):
        inner = dict(sub.get("network") or {})
        inner_sub = dict(inner.get(inner.get("type", "mlp")) or {})
        net = MixtureOfExperts(
            input_dim, output_dim,
            int(sub.get("num_experts", 8)),
            tuple(inner_sub.get("layers", sub.get("hidden_dims", (128,)))),
            activ_name(inner_sub.get("activation", "relu")),
            uses_batch_norm(inner_sub) if batch_norm is None else bn)
    elif net_type in ("imoe", "mixture-of-input-experts"):
        inner = dict(sub.get("network") or {})
        inner_type = inner.get("type", "mlp")
        inner_sub = dict(inner.get(inner_type) or {})
        net = MixtureOfInputExperts(
            input_dim, output_dim,
            expert_type=inner_type,
            expert_layers=tuple(inner_sub.get(
                "layers", inner_sub.get("hidden_dims", (64,)))),
            activation=activ_name(inner_sub.get("activation", "relu")),
            batch_norm=(uses_batch_norm(inner_sub) if batch_norm is None
                        else bn))
    elif net_type == "iterative":
        rnn = dict(dict(sub.get("network") or {}).get("rnn") or {})
        net = IterativeRegressorRNN(
            input_dim, output_dim,
            hidden_dims=tuple(rnn.get("layer_dims", (1024,))),
            cell_type=rnn.get("type", "lstm"),
            dropout=float(rnn.get("dropout", 0.0)),
            learn_state=bool(rnn.get("learn_state", False)),
            append_params=bool(sub.get("append_params", True)),
            num_stages=int(sub.get("num_stages", 3)),
        )
    elif net_type == "linear":
        net = LinearNet(input_dim, output_dim)
    elif net_type == "simple":
        net = SimpleNet(input_dim, output_dim)
    else:
        raise ValueError(f"Unknown network type: {net_type}")
    reset_parameters_(net, generator if generator is not None
                      else torch.Generator().manual_seed(0))
    net.learning_rate = float(sub.get("learning_rate", 1e-3))
    net.num_steps = int(sub.get("num_steps", 2000))
    return net.eval()
