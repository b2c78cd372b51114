from .base import glorot_uniform, unpack_edge_inputs, unpack_inputs
from .conv.gat import GAT
from .conv.gcn import GCN

__all__ = ["GAT", "GCN", "glorot_uniform", "unpack_edge_inputs", "unpack_inputs"]
