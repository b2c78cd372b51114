"""Propagation-family layers (JAX counterpart:
``tf_geometric_tpu/layers/conv/propagation.py``): SGC, TAGCN, APPNP, SSGC,
ChebyNet, GIN and LEConv.

Parameters carry the flax layers' names and layouts (``kernel`` [in,
units], ``bias``; ``kernel_i``/``bias_i`` per dense layer or Chebyshev
order; ``self_kernel``…), so ``convert.propagation_state_dict_from_flax``
loads a flax layer's params as they are. Kernels are glorot-uniform from
``generator`` on the CPU, then moved to ``device``; biases are zeros.
Dropout runs in training mode (``module.train()``) and takes a
``generator`` or explicit keep masks per call.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ...nn.conv.appnp import appnp
from ...nn.conv.chebynet import chebynet, chebynet_cache_normed_edge
from ...nn.conv.gin import gin
from ...nn.conv.le_conv import le_conv
from ...nn.conv.sgc import sgc
from ...nn.conv.ssgc import ssgc
from ...nn.conv.tagcn import tagcn
from ..base import glorot_uniform, unpack_edge_inputs

__all__ = ["SGC", "TAGCN", "APPNP", "SSGC", "ChebyNet", "GIN", "LEConv"]


def _kernel(shape, generator, device):
    return nn.Parameter(glorot_uniform(shape, generator).to(device))


def _bias(units, use_bias, device):
    return nn.Parameter(torch.zeros(units, device=device)) if use_bias else None


class SGC(nn.Module):
    """h = Â^k (x W) + b."""

    def __init__(self, in_features: int, units: int, k: int = 1, use_bias: bool = True,
                 activation: Optional[Callable] = None, renorm: bool = True,
                 improved: bool = False, generator=None, device="cuda"):
        super().__init__()
        self.k, self.activation, self.renorm, self.improved = k, activation, renorm, improved
        self.kernel = _kernel((in_features, units), generator, device)
        self.bias = _bias(units, use_bias, device)

    def forward(self, inputs, cache=None):
        x, edge_index, edge_weight = unpack_edge_inputs(inputs)
        return sgc(x, edge_index, edge_weight, self.k, self.kernel, self.bias, self.activation,
                   renorm=self.renorm, improved=self.improved, cache=cache)


class TAGCN(nn.Module):
    """[x, Âx, …, Â^k x] W + b; ``kernel`` is [(k + 1)·in, units]."""

    def __init__(self, in_features: int, units: int, k: int = 3, use_bias: bool = True,
                 activation: Optional[Callable] = None, renorm: bool = False,
                 improved: bool = False, generator=None, device="cuda"):
        super().__init__()
        self.k, self.activation, self.renorm, self.improved = k, activation, renorm, improved
        self.kernel = _kernel((in_features * (k + 1), units), generator, device)
        self.bias = _bias(units, use_bias, device)

    def forward(self, inputs, cache=None):
        x, edge_index, edge_weight = unpack_edge_inputs(inputs)
        return tagcn(x, edge_index, edge_weight, self.k, self.kernel, self.bias,
                     self.activation, renorm=self.renorm, improved=self.improved, cache=cache)


class _MlpPropagation(nn.Module):
    """APPNP and SSGC: an MLP encoder over ``units_list`` (``kernel_i``
    [d_i, d_{i+1}], ``bias_i``), then ``_op``'s propagation."""

    _op = None

    def __init__(self, in_features: int, units_list: Sequence[int], k: int = 10,
                 alpha: float = 0.1, dense_activation: Callable = torch.relu,
                 activation: Optional[Callable] = None, use_bias: bool = True,
                 dense_drop_rate: float = 0.0, last_dense_drop_rate: float = 0.0,
                 edge_drop_rate: float = 0.0, generator=None, device="cuda"):
        super().__init__()
        self.k, self.alpha = k, alpha
        self.dense_activation, self.activation = dense_activation, activation
        self.dense_drop_rate = dense_drop_rate
        self.last_dense_drop_rate = last_dense_drop_rate
        self.edge_drop_rate = edge_drop_rate
        dims = [in_features] + list(units_list)
        self.num_dense = len(units_list)
        for i in range(self.num_dense):
            setattr(self, f"kernel_{i}", _kernel((dims[i], dims[i + 1]), generator, device))
            setattr(self, f"bias_{i}", _bias(dims[i + 1], use_bias, device))

    def _dense(self):
        return ([getattr(self, f"kernel_{i}") for i in range(self.num_dense)],
                [getattr(self, f"bias_{i}") for i in range(self.num_dense)])

    def forward(self, inputs, cache=None, generator=None, edge_keep_mask=None,
                dense_keep_masks=None):
        x, edge_index, edge_weight = unpack_edge_inputs(inputs)
        kernels, biases = self._dense()
        return type(self)._op(
            x, edge_index, edge_weight, kernels, biases, dense_activation=self.dense_activation,
            activation=self.activation, k=self.k, alpha=self.alpha,
            dense_drop_rate=self.dense_drop_rate, last_dense_drop_rate=self.last_dense_drop_rate,
            edge_drop_rate=self.edge_drop_rate, cache=cache, training=self.training,
            generator=generator, edge_keep_mask=edge_keep_mask, dense_keep_masks=dense_keep_masks)


class APPNP(_MlpPropagation):
    """An MLP over ``units_list``, then k steps of personalized PageRank."""

    _op = staticmethod(appnp)


class SSGC(_MlpPropagation):
    """An MLP over ``units_list``, then α·h + Σ_k (1-α)/k · Â^k h."""

    _op = staticmethod(ssgc)


class ChebyNet(nn.Module):
    """Σ_k T_k(L̂) x W_k + b, one ``kernel_i`` [in, units] per order."""

    def __init__(self, in_features: int, units: int, k: int = 3, use_bias: bool = True,
                 activation: Optional[Callable] = None, normalization_type: str = "sym",
                 use_dynamic_lambda_max: bool = False, generator=None, device="cuda"):
        super().__init__()
        self.k, self.activation = k, activation
        self.normalization_type = normalization_type
        self.use_dynamic_lambda_max = use_dynamic_lambda_max
        for i in range(k):
            setattr(self, f"kernel_{i}", _kernel((in_features, units), generator, device))
        self.bias = _bias(units, use_bias, device)

    def build_cache_for_graph(self, graph, override=False, device="cuda"):
        chebynet_cache_normed_edge(graph, self.normalization_type, self.use_dynamic_lambda_max,
                                   override=override, device=device)
        return graph.cache

    def forward(self, inputs, cache=None):
        x, edge_index, edge_weight = unpack_edge_inputs(inputs)
        kernels = [getattr(self, f"kernel_{i}") for i in range(self.k)]
        return chebynet(x, edge_index, edge_weight, self.k, kernels, self.bias, self.activation,
                        self.normalization_type, self.use_dynamic_lambda_max, cache=cache)


class GIN(nn.Module):
    """GIN layer around a user MLP (a module, registered as ``mlp_model``).
    With ``train_eps`` the ε of ``(1 + ε)·x`` is a parameter ``eps`` [1]
    starting at ``eps``, as the flax layer's; else the constant ``eps``.
    ``layer([x, edge_index(, edge_weight)])`` or ``layer([x, sparse_adj])``;
    edge weights are not used (the adjacency is binary)."""

    def __init__(self, mlp_model: Callable, eps: float = 0.0, train_eps: bool = False,
                 device="cuda"):
        super().__init__()
        self.mlp_model = mlp_model
        if train_eps:
            self.eps = nn.Parameter(torch.full((1,), float(eps), device=device))
        else:
            self.eps = float(eps)

    def forward(self, inputs):
        x, edge_index, _ = unpack_edge_inputs(inputs)
        eps = self.eps[0] if isinstance(self.eps, torch.Tensor) else self.eps
        return gin(x, edge_index, self.mlp_model, eps=eps)


class LEConv(nn.Module):
    """Three kernels and biases: ``self_*``, ``aggr_self_*``, ``aggr_neighbor_*``."""

    _NAMES = ("self", "aggr_self", "aggr_neighbor")

    def __init__(self, in_features: int, units: int, use_bias: bool = True,
                 activation: Optional[Callable] = None, generator=None, device="cuda"):
        super().__init__()
        self.activation = activation
        for name in self._NAMES:
            setattr(self, f"{name}_kernel", _kernel((in_features, units), generator, device))
            setattr(self, f"{name}_bias", _bias(units, use_bias, device))

    def forward(self, inputs, cache=None):
        x, edge_index, edge_weight = unpack_edge_inputs(inputs)
        params = [getattr(self, f"{n}_{p}") for n in self._NAMES for p in ("kernel", "bias")]
        return le_conv(x, edge_index, edge_weight, *params, activation=self.activation)
