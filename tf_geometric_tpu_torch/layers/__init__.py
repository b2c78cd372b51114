from .base import glorot_uniform, unpack_inputs
from .conv.gcn import GCN

__all__ = ["GCN", "glorot_uniform", "unpack_inputs"]
