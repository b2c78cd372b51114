from .device_sampler import DeviceNeighborSampler, draw_fixed_k

__all__ = ["DeviceNeighborSampler", "draw_fixed_k"]
