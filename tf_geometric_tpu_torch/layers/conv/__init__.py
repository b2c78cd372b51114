from .gat import GAT
from .gcn import GCN
from .propagation import GIN
from .graph_sage import (GCNGraphSage, LSTMGraphSage, MaxPoolGraphSage, MeanGraphSage,
                         MeanPoolGraphSage, SumGraphSage)

__all__ = ["GAT", "GCN", "GIN", "MeanGraphSage", "SumGraphSage", "GCNGraphSage", "MeanPoolGraphSage",
           "MaxPoolGraphSage", "LSTMGraphSage"]
