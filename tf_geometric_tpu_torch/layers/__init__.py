from .base import glorot_uniform, unpack_edge_inputs, unpack_inputs
from .conv import (GAT, GCN, GCNGraphSage, LSTMGraphSage, MaxPoolGraphSage, MeanGraphSage,
                   MeanPoolGraphSage, SumGraphSage)

__all__ = ["GAT", "GCN", "MeanGraphSage", "SumGraphSage", "GCNGraphSage", "MeanPoolGraphSage",
           "MaxPoolGraphSage", "LSTMGraphSage", "glorot_uniform", "unpack_edge_inputs",
           "unpack_inputs"]
