"""Reading device time out of a ``torch.profiler`` trace."""
from __future__ import annotations

import torch

__all__ = ["device_time_by_kernel"]


def device_time_by_kernel(prof, steps: int):
    """(name, device ms per step, launches per step) of every kernel a
    ``torch.profiler`` trace of ``steps`` steps saw, slowest first; user
    annotations (``Optimizer.step#Adam.step``), which span kernels counted
    already, are left out."""
    kernels = [(e.key, e.self_device_time_total / 1e3 / steps, e.count / steps)
               for e in prof.key_averages()
               if e.self_device_time_total > 0
               and e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    return sorted(kernels, key=lambda k: -k[1])
