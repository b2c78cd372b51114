"""DropEdge layer (JAX counterpart: ``tf_geometric_tpu/layers/sampling/drop_edge.py``)."""
from __future__ import annotations

from typing import Optional

from torch import nn

from ...nn.sampling.drop_edge import drop_edge

__all__ = ["DropEdge"]


class DropEdge(nn.Module):
    """``drop_edge`` in training mode (``module.train()``); the identity in
    eval mode. Each call takes a ``generator`` or a ``keep_mask``."""

    def __init__(self, rate: float = 0.5, force_undirected: bool = False,
                 num_nodes: Optional[int] = None):
        super().__init__()
        self.rate, self.force_undirected, self.num_nodes = rate, force_undirected, num_nodes

    def forward(self, inputs, generator=None, keep_mask=None):
        return drop_edge(inputs, rate=self.rate, force_undirected=self.force_undirected,
                         training=self.training, generator=generator, num_nodes=self.num_nodes,
                         keep_mask=keep_mask)
