"""GAT layer (JAX counterpart: ``tf_geometric_tpu/layers/conv/gat.py``)."""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ...nn.conv.gat import gat
from ...utils.profiling import span
from ..base import glorot_uniform, unpack_edge_inputs

__all__ = ["GAT"]


class GAT(nn.Module):
    """Multi-head graph attention layer.

    ``layer([x, edge_index(, edge_weight)], cache=...)`` or ``layer([x,
    sparse_adj], ...)``; edge weights are not used. Weights, with the flax
    layer's names, shapes and initializers: ``query_kernel`` and
    ``key_kernel`` [in_features, attention_units], ``kernel`` [in_features,
    units] (``units * num_heads`` when the heads are averaged instead of
    split), glorot-uniform from ``generator`` in that order, and zero biases
    ``query_bias``, ``key_bias`` and ``bias`` [units]. Attention dropout
    runs in training mode and takes a ``generator`` or ``keep_mask`` per
    call.
    """

    def __init__(self, in_features: int, units: int, attention_units: Optional[int] = None,
                 activation: Optional[Callable] = None,
                 query_activation: Optional[Callable] = torch.relu,
                 key_activation: Optional[Callable] = torch.relu, num_heads: int = 1,
                 split_value_heads: bool = True, edge_drop_rate: float = 0.0,
                 use_bias: bool = True, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        att_units = attention_units if attention_units is not None else units
        value_units = units if split_value_heads else units * num_heads
        self.units = units
        self.activation = activation
        self.query_activation = query_activation
        self.key_activation = key_activation
        self.num_heads = num_heads
        self.split_value_heads = split_value_heads
        self.edge_drop_rate = edge_drop_rate

        def kernel(fan_out):
            return nn.Parameter(glorot_uniform((in_features, fan_out), generator).to(device))

        def zeros(size):
            return nn.Parameter(torch.zeros(size, device=device))

        self.query_kernel = kernel(att_units)
        self.query_bias = zeros(att_units)
        self.key_kernel = kernel(att_units)
        self.key_bias = zeros(att_units)
        self.kernel = kernel(value_units)
        self.bias = zeros(units) if use_bias else None

    @span("tfg.layers.GAT")
    def forward(self, inputs, cache: Optional[dict] = None, generator=None, keep_mask=None):
        x, edge_index, _ = unpack_edge_inputs(inputs)
        return gat(x, edge_index,
                   self.query_kernel, self.query_bias, self.query_activation,
                   self.key_kernel, self.key_bias, self.key_activation,
                   self.kernel, self.bias, self.activation,
                   num_heads=self.num_heads, split_value_heads=self.split_value_heads,
                   edge_drop_rate=self.edge_drop_rate, training=self.training,
                   generator=generator, keep_mask=keep_mask, cache=cache)
