"""Tracing, timing on the card and reading device time out of a
``torch.profiler`` trace (JAX counterpart: ``tf_geometric_tpu/utils/profiling.py``)."""
from __future__ import annotations

import contextlib
import os
import tempfile

import torch

__all__ = ["trace", "device_time_by_kernel", "measure_step_time", "estimate_spmm_roofline",
           "H100_HBM_BYTES_PER_S", "STEP_TIME_WARMUP"]

H100_HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
STEP_TIME_WARMUP = 2            # measure_step_time's untimed steps before its two runs


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "tfg_tpu_torch_trace")):
    """Trace the block with ``torch.profiler`` (the CPU, and the card when
    there is one) and write it into ``log_dir`` as a trace TensorBoard's
    profiler plugin reads (``tensorboard_trace_handler``)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


def measure_step_time(step_fn, args, lo: int = 5, hi: int = 25) -> float:
    """Seconds per step of chained steps on the card, by a slope fit:
    ``step_fn(*args)`` returns the next ``args``, so the steps form one
    dependency chain. After ``STEP_TIME_WARMUP`` steps, runs of ``lo`` and then ``hi``
    steps are timed with CUDA events; returns ``(t_hi - t_lo) / (hi - lo)``,
    which cancels what a run pays once (the first launch's latency, the
    final synchronization). Raises without a CUDA device: a host clock here
    would not be a device time."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_step_time times on a CUDA device; none is available")

    def run(iters, a):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            a = step_fn(*a)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3, a

    _, args = run(STEP_TIME_WARMUP, args)
    t_lo, args = run(lo, args)
    t_hi, args = run(hi, args)
    return (t_hi - t_lo) / (hi - lo)


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
