from .device_sampler import DeviceNeighborSampler, FixedKDraw, draw_fixed_k
from .drop_edge import drop_edge

__all__ = ["DeviceNeighborSampler", "FixedKDraw", "draw_fixed_k", "drop_edge"]
