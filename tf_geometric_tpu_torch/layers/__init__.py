from .base import glorot_uniform, l2_loss, unpack_edge_inputs, unpack_inputs
from .conv import (APPNP, GAT, GCN, GIN, SGC, SSGC, TAGCN, ChebyNet, GCNGraphSage, LEConv,
                   LSTMGraphSage, MaxPoolGraphSage, MeanGraphSage, MeanPoolGraphSage,
                   SumGraphSage)
from .kernel import MapReduceGNN
from .pool import (ASAP, CommonPool, DiffPool, MaxPool, MeanPool, MinCutPool, MinPool, SAGPool,
                   Set2Set, SortPool, SumPool)
from .sampling import DropEdge

__all__ = ["GAT", "GCN", "GIN", "SGC", "TAGCN", "APPNP", "SSGC", "ChebyNet", "LEConv",
           "MapReduceGNN", "DropEdge", "l2_loss", "CommonPool", "MeanPool", "SumPool", "MaxPool",
           "MinPool", "SortPool", "DiffPool", "MinCutPool", "SAGPool", "ASAP", "Set2Set",
           "MeanGraphSage", "SumGraphSage", "GCNGraphSage", "MeanPoolGraphSage",
           "MaxPoolGraphSage", "LSTMGraphSage", "glorot_uniform", "unpack_edge_inputs",
           "unpack_inputs"]
