"""MapReduceGNN: a layer with overridable map / reduce / update (JAX
counterpart: ``tf_geometric_tpu/layers/kernel/map_reduce.py``)."""
from __future__ import annotations

from torch import nn

from ...nn.kernel.map_reduce import aggregate_neighbors
from ..base import unpack_edge_inputs

__all__ = ["MapReduceGNN"]


class MapReduceGNN(nn.Module):
    """Subclass and override ``map``, ``reduce`` and ``update``; the call
    runs ``aggregate_neighbors`` with them."""

    def map(self, repeated_x, neighbor_x, edge_weight=None):
        raise NotImplementedError

    def reduce(self, neighbor_msg, node_index, num_nodes=None):
        raise NotImplementedError

    def update(self, x, reduced_neighbor_msg):
        raise NotImplementedError

    def get_mapper(self):
        return lambda repeated_x, neighbor_x, edge_weight=None: self.map(
            repeated_x, neighbor_x, edge_weight)

    def get_reducer(self):
        return lambda neighbor_msg, node_index, num_nodes=None: self.reduce(
            neighbor_msg, node_index, num_nodes)

    def get_updater(self):
        return lambda x, reduced_neighbor_msg: self.update(x, reduced_neighbor_msg)

    def forward(self, inputs):
        x, edge_index, edge_weight = unpack_edge_inputs(inputs)
        return aggregate_neighbors(x, edge_index, edge_weight, self.get_mapper(),
                                   self.get_reducer(), self.get_updater())
