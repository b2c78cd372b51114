"""GCN layer (JAX counterpart: ``tf_geometric_tpu/layers/conv/gcn.py``)."""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ...nn.conv.gcn import gcn, gcn_build_cache_by_adj, gcn_build_cache_for_graph
from ..base import glorot_uniform, unpack_inputs

__all__ = ["GCN"]


class GCN(nn.Module):
    """Graph Convolutional Network layer (Kipf & Welling).

    ``layer([x, edge_index(, edge_weight)], cache=...)`` or
    ``layer([x, sparse_adj], ...)``. Weights: ``kernel`` [in_features, units]
    (glorot-uniform from ``generator``) and ``bias`` (zeros). Edge dropout
    runs in training mode and takes a ``generator`` or ``keep_mask`` per call.
    """

    def __init__(self, in_features: int, units: int,
                 activation: Optional[Callable] = None, use_bias: bool = True,
                 norm: str = "both", add_self_loop: bool = True, sym: bool = True,
                 renorm: bool = True, improved: bool = False,
                 edge_drop_rate: float = 0.0, num_or_size_splits=None,
                 use_kernel: bool = True, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.units = units
        self.activation = activation
        self.norm = norm
        self.add_self_loop = add_self_loop
        self.sym = sym
        self.renorm = renorm
        self.improved = improved
        self.edge_drop_rate = edge_drop_rate
        self.num_or_size_splits = num_or_size_splits
        self.kernel = (nn.Parameter(glorot_uniform((in_features, units), generator)
                                    .to(device)) if use_kernel else None)
        self.bias = (nn.Parameter(torch.zeros(units, device=device))
                     if use_bias else None)

    def build_cache_by_adj(self, sparse_adj, override=False, cache=None):
        return gcn_build_cache_by_adj(
            sparse_adj, norm=self.norm, add_self_loop=self.add_self_loop,
            sym=self.sym, renorm=self.renorm, improved=self.improved,
            override=override, cache=cache)

    def build_cache_for_graph(self, graph, override=False, device="cuda"):
        return gcn_build_cache_for_graph(
            graph, norm=self.norm, add_self_loop=self.add_self_loop,
            sym=self.sym, renorm=self.renorm, improved=self.improved,
            override=override, device=device)

    def forward(self, inputs, cache: Optional[dict] = None, generator=None,
                keep_mask=None):
        x, sparse_adj = unpack_inputs(inputs)
        return gcn(
            x, sparse_adj, self.kernel, bias=self.bias, activation=self.activation,
            norm=self.norm, add_self_loop=self.add_self_loop, sym=self.sym,
            renorm=self.renorm, improved=self.improved,
            edge_drop_rate=self.edge_drop_rate,
            num_or_size_splits=self.num_or_size_splits,
            training=self.training, cache=cache, generator=generator,
            keep_mask=keep_mask)
