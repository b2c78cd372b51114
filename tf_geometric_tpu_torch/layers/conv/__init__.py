from .gat import GAT
from .gcn import GCN
from .propagation import APPNP, GIN, SGC, SSGC, TAGCN, ChebyNet, LEConv
from .graph_sage import (GCNGraphSage, LSTMGraphSage, MaxPoolGraphSage, MeanGraphSage,
                         MeanPoolGraphSage, SumGraphSage)

__all__ = ["GAT", "GCN", "GIN", "SGC", "TAGCN", "APPNP", "SSGC", "ChebyNet", "LEConv",
           "MeanGraphSage", "SumGraphSage", "GCNGraphSage", "MeanPoolGraphSage",
           "MaxPoolGraphSage", "LSTMGraphSage"]
