from .gcn import GCN

__all__ = ["GCN"]
