from .device_sampler import DeviceNeighborSampler, draw_fixed_k
from .drop_edge import drop_edge

__all__ = ["DeviceNeighborSampler", "draw_fixed_k", "drop_edge"]
