from .gat import GAT
from .gcn import GCN
from .graph_sage import (GCNGraphSage, LSTMGraphSage, MaxPoolGraphSage, MeanGraphSage,
                         MeanPoolGraphSage, SumGraphSage)

__all__ = ["GAT", "GCN", "MeanGraphSage", "SumGraphSage", "GCNGraphSage", "MeanPoolGraphSage",
           "MaxPoolGraphSage", "LSTMGraphSage"]
