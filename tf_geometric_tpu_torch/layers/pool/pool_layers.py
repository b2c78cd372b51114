"""Pooling layers (JAX counterpart: ``tf_geometric_tpu/layers/pool/pool_layers.py``):
the whole-graph readouts and SortPool, modules without parameters."""
from __future__ import annotations

from typing import Callable, Optional

from torch import nn

from ...nn.pool.common_pool import max_pool, mean_pool, min_pool, sum_pool
from ...nn.pool.sort_pool import sort_pool

__all__ = ["CommonPool", "MeanPool", "SumPool", "MaxPool", "MinPool", "SortPool"]


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
