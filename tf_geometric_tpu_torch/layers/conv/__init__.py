from .gat import GAT
from .gcn import GCN

__all__ = ["GAT", "GCN"]
