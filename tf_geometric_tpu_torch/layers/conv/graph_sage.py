"""GraphSAGE layers (JAX counterpart: ``tf_geometric_tpu/layers/conv/graph_sage.py``).

Weight names, shapes and initializers follow the flax layers: with
``concat=True`` the self and neighbour kernels produce ``units // 2``
features each, so the concatenated output has ``units``; the pool variants
put a ``kernel_units · 4``-wide edge MLP before the neighbour kernel. Kernels
are glorot-uniform from ``generator`` in the flax creation order, biases
zeros. ``LSTMGraphSage`` runs a ``torch.nn.LSTM`` over the neighbour axis,
the counterpart of the flax ``OptimizedLSTMCell``
(``convert.sage_state_dict_from_flax`` maps one onto the other).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ...nn.conv.graph_sage import (gcn_graph_sage, lstm_graph_sage, max_pool_graph_sage,
                                   mean_graph_sage, mean_pool_graph_sage, sum_graph_sage)
from ..base import glorot_uniform, unpack_edge_inputs

__all__ = ["MeanGraphSage", "SumGraphSage", "GCNGraphSage", "MeanPoolGraphSage",
           "MaxPoolGraphSage", "LSTMGraphSage"]


def _kernel_units(units: int, concat: bool) -> int:
    if concat and units % 2 != 0:
        raise ValueError("units must be an even number if concat is True")
    return units // 2 if concat else units


def _glorot(fan_in: int, fan_out: int, generator, device):
    return nn.Parameter(glorot_uniform((fan_in, fan_out), generator).to(device))


def _zeros(size: int, device):
    return nn.Parameter(torch.zeros(size, device=device))


class _SageBase(nn.Module):
    def __init__(self, units: int, activation: Optional[Callable], normalize: bool):
        super().__init__()
        self.units = units
        self.activation = activation
        self.normalize = normalize


class _PairKernelSage(_SageBase):
    """Self and neighbour kernels [in_features, kernel_units], then ``bias``
    [units] (mean and sum variants)."""

    _op = None

    def __init__(self, in_features: int, units: int, activation: Optional[Callable] = torch.relu,
                 use_bias: bool = True, concat: bool = True, normalize: bool = False,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__(units, activation, normalize)
        self.concat = concat
        ku = _kernel_units(units, concat)
        self.self_kernel = _glorot(in_features, ku, generator, device)
        self.neighbor_kernel = _glorot(in_features, ku, generator, device)
        self.bias = _zeros(units, device) if use_bias else None

    def forward(self, inputs, cache=None):
        x, edge_index, edge_weight = unpack_edge_inputs(inputs)
        return type(self)._op(x, edge_index, edge_weight, self.self_kernel,
                              self.neighbor_kernel, bias=self.bias, activation=self.activation,
                              concat=self.concat, normalize=self.normalize)


class MeanGraphSage(_PairKernelSage):
    """Mean aggregator layer."""
    _op = staticmethod(mean_graph_sage)


class SumGraphSage(_PairKernelSage):
    """Sum aggregator layer."""
    _op = staticmethod(sum_graph_sage)


class GCNGraphSage(_SageBase):
    """GCN aggregator layer: ``kernel`` [in_features, units], ``bias`` [units]."""

    def __init__(self, in_features: int, units: int, activation: Optional[Callable] = torch.relu,
                 use_bias: bool = True, normalize: bool = False,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__(units, activation, normalize)
        self.kernel = _glorot(in_features, units, generator, device)
        self.bias = _zeros(units, device) if use_bias else None

    def forward(self, inputs, cache=None):
        x, edge_index, edge_weight = unpack_edge_inputs(inputs)
        return gcn_graph_sage(x, edge_index, edge_weight, self.kernel, self.bias,
                              self.activation, self.normalize, cache=cache)


class _PoolSage(_SageBase):
    """``self_kernel`` [in, ku], ``neighbor_mlp_kernel`` [in, 4·ku],
    ``neighbor_mlp_bias`` [4·ku], ``neighbor_kernel`` [4·ku, ku], ``bias``
    [units] (mean- and max-pool variants)."""

    _op = None

    def __init__(self, in_features: int, units: int, activation: Optional[Callable] = torch.relu,
                 use_bias: bool = True, concat: bool = True, normalize: bool = False,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__(units, activation, normalize)
        self.concat = concat
        ku = _kernel_units(units, concat)
        self.self_kernel = _glorot(in_features, ku, generator, device)
        self.neighbor_mlp_kernel = _glorot(in_features, ku * 4, generator, device)
        self.neighbor_mlp_bias = _zeros(ku * 4, device) if use_bias else None
        self.neighbor_kernel = _glorot(ku * 4, ku, generator, device)
        self.bias = _zeros(units, device) if use_bias else None

    def forward(self, inputs, cache=None):
        x, edge_index, edge_weight = unpack_edge_inputs(inputs)
        return type(self)._op(x, edge_index, edge_weight, self.self_kernel,
                              self.neighbor_mlp_kernel, self.neighbor_kernel,
                              neighbor_mlp_bias=self.neighbor_mlp_bias, bias=self.bias,
                              activation=self.activation, concat=self.concat,
                              normalize=self.normalize)


class MeanPoolGraphSage(_PoolSage):
    """Edge MLP then mean pool."""
    _op = staticmethod(mean_pool_graph_sage)


class MaxPoolGraphSage(_PoolSage):
    """Edge MLP then max pool."""
    _op = staticmethod(max_pool_graph_sage)


class LSTMGraphSage(_SageBase):
    """LSTM aggregator layer: ``self_kernel`` [in, ku], ``neighbor_kernel``
    [ku, ku], ``bias`` [units] and ``lstm``, a one-layer ``torch.nn.LSTM``
    (in → ku, batch first, zero initial state) whose full output sequence is
    averaged. ``max_neighbors`` fixes K (default: the largest in-degree)."""

    def __init__(self, in_features: int, units: int, activation: Optional[Callable] = torch.relu,
                 use_bias: bool = True, concat: bool = True, normalize: bool = False,
                 max_neighbors: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__(units, activation, normalize)
        self.concat = concat
        self.max_neighbors = max_neighbors
        ku = _kernel_units(units, concat)
        self.self_kernel = _glorot(in_features, ku, generator, device)
        self.neighbor_kernel = _glorot(ku, ku, generator, device)
        self.bias = _zeros(units, device) if use_bias else None
        self.lstm = nn.LSTM(in_features, ku, batch_first=True, device=device)

    def forward(self, inputs, cache=None):
        x, edge_index, _ = unpack_edge_inputs(inputs)
        return lstm_graph_sage(x, edge_index, lambda seq: self.lstm(seq)[0], self.self_kernel,
                               self.neighbor_kernel, bias=self.bias,
                               activation=self.activation, concat=self.concat,
                               normalize=self.normalize, max_neighbors=self.max_neighbors)
