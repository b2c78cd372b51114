"""Pooling layers (JAX counterpart: ``tf_geometric_tpu/layers/pool/pool_layers.py``).

The whole-graph readouts, SortPool and SAGPool have no parameters. DiffPool
and MinCutPool own their bias, ASAP its 12 tensors, Set2Set its LSTM cell;
the GNNs of DiffPool, MinCutPool and SAGPool are callables the caller
passes in (a module passed so becomes a submodule).

MinCutPool keeps no state: where the flax layer also ``sow``s its losses
into a ``"losses"`` collection, this one returns them under
``return_losses=True`` (``(outputs, (cut, orth))``) or their function under
``return_loss_func=True``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ...nn.pool.asap import asap
from ...nn.pool.common_pool import max_pool, mean_pool, min_pool, sum_pool
from ...nn.pool.diff_pool import diff_pool
from ...nn.pool.min_cut_pool import min_cut_pool
from ...nn.pool.sag_pool import sag_pool
from ...nn.pool.set2set import set2set
from ...nn.pool.sort_pool import sort_pool
from ..base import glorot_uniform

__all__ = ["CommonPool", "MeanPool", "SumPool", "MaxPool", "MinPool", "SortPool", "DiffPool",
           "MinCutPool", "SAGPool", "ASAP", "Set2Set"]


class CommonPool(nn.Module):
    """Whole-graph readout: ``layer([x, node_graph_index])``."""

    def __init__(self, pool_func: Callable, num_graphs: Optional[int] = None):
        super().__init__()
        self.pool_func = pool_func
        self.num_graphs = num_graphs

    def forward(self, inputs):
        x, node_graph_index = inputs
        return self.pool_func(x, node_graph_index, num_graphs=self.num_graphs)


class MeanPool(CommonPool):
    def __init__(self, num_graphs: Optional[int] = None):
        super().__init__(mean_pool, num_graphs)


class SumPool(CommonPool):
    def __init__(self, num_graphs: Optional[int] = None):
        super().__init__(sum_pool, num_graphs)


class MaxPool(CommonPool):
    def __init__(self, num_graphs: Optional[int] = None):
        super().__init__(max_pool, num_graphs)


class MinPool(CommonPool):
    def __init__(self, num_graphs: Optional[int] = None):
        super().__init__(min_pool, num_graphs)


class SortPool(nn.Module):
    """``layer([x, edge_index, edge_weight, node_graph_index])`` → the pooled
    ``(x, edge_index, edge_weight, node_graph_index)`` of ``sort_pool``."""

    def __init__(self, k: Optional[int] = None, ratio: Optional[float] = None,
                 sort_index: int = -1, num_graphs: Optional[int] = None):
        super().__init__()
        self.k, self.ratio, self.sort_index, self.num_graphs = k, ratio, sort_index, num_graphs

    def forward(self, inputs):
        x, edge_index, edge_weight, node_graph_index = inputs
        return sort_pool(x, edge_index, edge_weight, node_graph_index, k=self.k,
                         ratio=self.ratio, sort_index=self.sort_index,
                         num_graphs=self.num_graphs)


def _pool_bias(use_bias: bool, units: Optional[int], device):
    if not use_bias:
        return None
    if units is None:
        raise ValueError('"units" is required when use_bias=True')
    return nn.Parameter(torch.zeros(units, device=device))


class DiffPool(nn.Module):
    """``layer([x, edge_index, edge_weight, node_graph_index], cache=None)``
    → ``diff_pool``'s pooled ``(x, edge_index, edge_weight,
    node_graph_index)``. Owns ``bias`` [units] (zeros)."""

    def __init__(self, feature_gnn: Callable, assign_gnn: Callable, units: Optional[int] = None,
                 num_clusters: int = 2, activation: Optional[Callable] = None,
                 use_bias: bool = True, num_graphs: Optional[int] = None, device="cuda"):
        super().__init__()
        self.feature_gnn, self.assign_gnn = feature_gnn, assign_gnn
        self.num_clusters, self.activation, self.num_graphs = num_clusters, activation, num_graphs
        self.bias = _pool_bias(use_bias, units, device)

    def forward(self, inputs, cache=None):
        x, edge_index, edge_weight, node_graph_index = inputs
        return diff_pool(x, edge_index, edge_weight, node_graph_index, self.feature_gnn,
                         self.assign_gnn, self.num_clusters, bias=self.bias,
                         activation=self.activation, cache=cache, num_graphs=self.num_graphs)


class MinCutPool(nn.Module):
    """``layer([x, edge_index, edge_weight, node_graph_index], cache=None,
    return_loss_func=False, return_losses=False)`` → ``min_cut_pool``'s
    outputs (see the module docstring). Owns ``bias`` [units] (zeros)."""

    def __init__(self, feature_gnn: Callable, assign_gnn: Callable, units: Optional[int] = None,
                 num_clusters: int = 2, activation: Optional[Callable] = None,
                 use_bias: bool = True, gnn_use_normed_edge: bool = True,
                 num_graphs: Optional[int] = None, device="cuda"):
        super().__init__()
        self.feature_gnn, self.assign_gnn = feature_gnn, assign_gnn
        self.num_clusters, self.activation, self.num_graphs = num_clusters, activation, num_graphs
        self.gnn_use_normed_edge = gnn_use_normed_edge
        self.bias = _pool_bias(use_bias, units, device)

    def forward(self, inputs, cache=None, return_loss_func: bool = False,
                return_losses: bool = False):
        x, edge_index, edge_weight, node_graph_index = inputs
        return min_cut_pool(x, edge_index, edge_weight, node_graph_index, self.feature_gnn,
                            self.assign_gnn, self.num_clusters, bias=self.bias,
                            activation=self.activation,
                            gnn_use_normed_edge=self.gnn_use_normed_edge,
                            return_loss_func=return_loss_func, return_losses=return_losses,
                            cache=cache, num_graphs=self.num_graphs)


class SAGPool(nn.Module):
    """``layer([x, edge_index, edge_weight, node_graph_index], cache=None)``
    → ``sag_pool``'s pooled outputs (fixed-size with ``k``, host-side with
    ``ratio``)."""

    def __init__(self, score_gnn: Callable, k: Optional[int] = None,
                 ratio: Optional[float] = None, score_activation: Optional[Callable] = None,
                 num_graphs: Optional[int] = None):
        super().__init__()
        self.score_gnn, self.k, self.ratio = score_gnn, k, ratio
        self.score_activation, self.num_graphs = score_activation, num_graphs

    def forward(self, inputs, cache=None):
        x, edge_index, edge_weight, node_graph_index = inputs
        return sag_pool(x, edge_index, edge_weight, node_graph_index, self.score_gnn, k=self.k,
                        ratio=self.ratio, score_activation=self.score_activation, cache=cache,
                        num_graphs=self.num_graphs)


# ASAP's tensors, as the flax layer names them, with their shapes in terms of
# in_features "f" and units "u"
_ASAP_PARAMS = (
    ("attention_gcn_kernel", ("f", "u")), ("attention_gcn_bias", ("u",)),
    ("attention_query_kernel", ("u", "u")), ("attention_query_bias", ("u",)),
    ("attention_score_kernel", ("2u", 1)), ("attention_score_bias", (1,)),
    ("le_conv_self_kernel", ("f", 1)), ("le_conv_self_bias", (1,)),
    ("le_conv_aggr_self_kernel", ("f", 1)), ("le_conv_aggr_self_bias", (1,)),
    ("le_conv_aggr_neighbor_kernel", ("f", 1)), ("le_conv_aggr_neighbor_bias", (1,)))


class ASAP(nn.Module):
    """``layer([x, edge_index, edge_weight, node_graph_index], cache=None,
    generator=None, keep_mask=None)`` → ``asap``'s pooled outputs. Owns the
    12 tensors of the flax layer under its names: kernels glorot-uniform
    from ``generator``, biases zeros (none with ``use_bias=False``).
    Attention dropout in training mode draws from the call's ``generator``
    or takes its ``keep_mask``."""

    def __init__(self, in_features: int, units: int, k: Optional[int] = None,
                 ratio: Optional[float] = None, drop_rate: float = 0.0,
                 le_conv_activation: Optional[Callable] = torch.sigmoid, use_bias: bool = True,
                 num_graphs: Optional[int] = None, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.k, self.ratio, self.drop_rate, self.num_graphs = k, ratio, drop_rate, num_graphs
        self.le_conv_activation = le_conv_activation
        sizes = {"f": in_features, "u": units, "2u": 2 * units, 1: 1}
        for name, shape in _ASAP_PARAMS:
            shape = tuple(sizes[d] for d in shape)
            if name.endswith("kernel"):
                setattr(self, name, nn.Parameter(glorot_uniform(shape, generator).to(device)))
            else:
                setattr(self, name, nn.Parameter(torch.zeros(shape, device=device))
                        if use_bias else None)

    def forward(self, inputs, cache=None, generator=None, keep_mask=None):
        x, edge_index, edge_weight, node_graph_index = inputs
        params = {name: getattr(self, name) for name, _ in _ASAP_PARAMS}
        return asap(x, edge_index, edge_weight, node_graph_index, **params, k=self.k,
                    ratio=self.ratio, le_conv_activation=self.le_conv_activation,
                    drop_rate=self.drop_rate, training=self.training, cache=cache,
                    generator=generator, keep_mask=keep_mask, num_graphs=self.num_graphs)


class Set2Set(nn.Module):
    """``layer([x, node_graph_index])`` → ``set2set`` [G, 2·in_features].
    Owns ``cell``, a ``torch.nn.LSTMCell(2·in_features, in_features)``
    started from a zero state (flax's ``OptimizedLSTMCell`` carries ``(c,
    h)``, torch's cell ``(h, c)``; ``convert.set2set_state_dict_from_flax``
    maps its weights)."""

    def __init__(self, in_features: int, num_iterations: int = 4,
                 num_graphs: Optional[int] = None, device="cuda"):
        super().__init__()
        self.num_iterations, self.num_graphs = num_iterations, num_graphs
        self.cell = nn.LSTMCell(2 * in_features, in_features, device=device)

    def _lstm(self, h, state):
        h, c = self.cell(h) if state is None else self.cell(h, state)
        return h, (h, c)

    def forward(self, inputs):
        x, node_graph_index = inputs
        return set2set(x, node_graph_index, self._lstm, self.num_iterations,
                       num_graphs=self.num_graphs)
