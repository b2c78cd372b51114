"""Timing on the card and reading device time out of a ``torch.profiler``
trace (JAX counterpart: ``tf_geometric_tpu/utils/profiling.py``)."""
from __future__ import annotations

import torch

__all__ = ["device_time_by_kernel", "measure_step_time", "estimate_spmm_roofline",
           "H100_HBM_BYTES_PER_S"]

H100_HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory


def measure_step_time(step_fn, args, warmup: int = 2, iters: int = 10, repeats: int = 5) -> float:
    """Seconds per step of chained steps on the card: ``step_fn(*args)``
    returns the next ``args``, so the steps form one dependency chain (as
    the JAX function asks). ``warmup`` steps, then ``repeats`` runs of
    ``iters`` steps, each timed with CUDA events; returns the median run's
    time per step. Raises without a CUDA device: a host clock here would
    not be a device time."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_step_time times on a CUDA device; none is available")
    for _ in range(warmup):
        args = step_fn(*args)
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            args = step_fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / iters)
    return sorted(times)[len(times) // 2]


def estimate_spmm_roofline(num_edges: int, num_nodes: int, num_features: int,
                           dtype_bytes: int = 4,
                           hbm_bandwidth: float = H100_HBM_BYTES_PER_S) -> float:
    """Streaming-bytes upper bound of one SpMM pass, in edges/s: each edge's
    index and value (8 bytes) and gathered row, and the output rows, over
    the H100's memory rate (the JAX function's formula)."""
    bytes_total = (num_edges * (8 + num_features * dtype_bytes)
                   + num_nodes * num_features * dtype_bytes)
    return num_edges / (bytes_total / hbm_bandwidth)


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
