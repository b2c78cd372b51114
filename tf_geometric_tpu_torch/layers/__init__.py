from .base import glorot_uniform, unpack_edge_inputs, unpack_inputs
from .conv import (GAT, GCN, GIN, GCNGraphSage, LSTMGraphSage, MaxPoolGraphSage, MeanGraphSage,
                   MeanPoolGraphSage, SumGraphSage)
from .pool import CommonPool, MaxPool, MeanPool, MinPool, SortPool, SumPool

__all__ = ["GAT", "GCN", "GIN", "CommonPool", "MeanPool", "SumPool", "MaxPool", "MinPool",
           "SortPool", "MeanGraphSage", "SumGraphSage", "GCNGraphSage", "MeanPoolGraphSage",
           "MaxPoolGraphSage", "LSTMGraphSage", "glorot_uniform", "unpack_edge_inputs",
           "unpack_inputs"]
