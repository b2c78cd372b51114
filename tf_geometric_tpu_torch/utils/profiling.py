"""Tracing, timing on the card and reading device time out of a
``torch.profiler`` trace (JAX counterpart: ``tf_geometric_tpu/utils/profiling.py``),
and the port's own spans and counters.

Spans and counters. ``span(name)`` marks a stretch of host time at a layer
boundary of the port (every name starts with ``tfg.``); it is a context
manager and a decorator. Spans record only inside ``tracing()``: outside it
a span checks one module-level flag and records nothing. Inside, each span
keeps its name, start and end (``time.perf_counter_ns``), its parent (the
innermost span open on the same thread when it opened) and its thread, in
memory; each thread has its own stack of open spans, since autograd runs a
backward on a thread of its own. While a ``torch.profiler`` session is
active a recording span also opens a ``record_function`` of its name, which
puts it on the profiler's timeline beside the device operations.
``count(name, n)`` adds to a counter; counters always count. ``spans()``,
``counters()`` and ``reset()`` read and clear both.
"""
from __future__ import annotations

import contextlib
import functools
import tempfile
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

__all__ = ["trace", "device_time_by_kernel", "measure_step_time", "estimate_spmm_roofline",
           "H100_HBM_BYTES_PER_S", "STEP_TIME_WARMUP", "Span", "span", "count", "tracing",
           "spans", "counters", "reset"]

H100_HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
STEP_TIME_WARMUP = 2            # measure_step_time's untimed steps before its two runs


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Trace the block with ``torch.profiler`` (the CPU, and the card when
    there is one) and write it into ``log_dir`` (default: a new temporary
    directory for each call) as a trace TensorBoard's profiler plugin reads
    (``tensorboard_trace_handler``); yields the directory."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="tfg_torch_trace_")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------

class Span(NamedTuple):
    """One recorded span. ``parent`` is the index in ``spans()`` of the span
    that enclosed it on its thread, or None; ``end_ns`` is None while it is
    open; ``thread`` is the native thread id."""
    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    thread: int


_tracing = False                # the switch: spans record only while it is on
_records: List[list] = []       # [name, start_ns, end_ns, parent record, thread]
_counters: Dict[str, int] = {}
_lock = threading.Lock()        # the records' and counters' updates, from any thread
_thread = threading.local()     # .open: this thread's open records, innermost last; .id


class span:
    """A named span of host time: ``with span("tfg.ops.x.forward"): ...`` or
    ``@span("tfg.setup.x")`` on a function. Records only inside ``tracing()``."""

    __slots__ = ("name", "_record", "_annotation")

    def __init__(self, name: str):
        self.name = name
        self._record = None

    def __enter__(self):
        if _tracing:
            self._open()
        return self

    def __exit__(self, *exc):
        if self._record is not None:
            self._close()
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _tracing:
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)
        return traced

    def _open(self):
        stack = getattr(_thread, "open", None)
        if stack is None:
            # the native id once a thread: a system call, ~10 µs on a sandboxed host
            stack, _thread.id = [], threading.get_native_id()
            _thread.open = stack
        self._annotation = None
        if torch.autograd._profiler_enabled():
            self._annotation = torch.autograd.profiler.record_function(self.name)
            self._annotation.__enter__()
        record = [self.name, time.perf_counter_ns(), None, stack[-1] if stack else None,
                  _thread.id]
        with _lock:
            _records.append(record)
        stack.append(record)
        self._record = record

    def _close(self):
        self._record[2] = time.perf_counter_ns()
        stack = _thread.open
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self._record:
                del stack[i]
                break
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
        self._record = self._annotation = None


@contextlib.contextmanager
def tracing():
    """Spans record inside the block; the switch is restored after it."""
    global _tracing
    before, _tracing = _tracing, True
    try:
        yield
    finally:
        _tracing = before


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` (always on)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def spans() -> List[Span]:
    """The spans recorded since the last ``reset()``, in the order they opened."""
    with _lock:
        records = list(_records)
    index = {id(r): i for i, r in enumerate(records)}
    return [Span(name, start, end, None if parent is None else index.get(id(parent)), thread)
            for name, start, end, parent, thread in records]


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    with _lock:
        return dict(_counters)


def reset() -> None:
    """Forgets the recorded spans and zeroes every counter."""
    with _lock:
        _records.clear()
        _counters.clear()


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
