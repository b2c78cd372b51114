"""The host side of a kernel launch, for every wrapper in ``ops/``.

The C entries of ``csrc/`` (built and loaded by ``ops._build``) take raw
pointers, a dtype code, a lane-vector width and a CUDA stream, and return a
``cudaError_t``. What every wrapper needs around such a call lives here:

- ``DTYPE_CODES``: the code each entry takes for a float32 or bfloat16
  tensor;
- ``require_cuda``: the refusal of a tensor the kernels cannot read (not on
  the card, on another card, or not contiguous);
- ``vec_elements`` and ``max_vec_bytes``: the widest lane vector the
  tensors' widths and base addresses allow;
- ``use_kernel``: the choice between a kernel and its plain PyTorch version;
- ``launch``: the entry, looked up and typed once, called on the current
  stream of the tensors' device, its error raised, the launch counted as
  ``launches.<family>`` (``utils.profiling``) under one of
  ``LAUNCH_FAMILIES``; ``query`` and ``entry`` for the entries that launch
  nothing (kernel attributes, scratch sizes).

A new kernel family adds its name to ``LAUNCH_FAMILIES`` and launches
through ``launch``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from ..utils.profiling import count, counters
from . import _build

__all__ = ["DTYPE_CODES", "LAUNCH_FAMILIES", "require_cuda", "vec_elements", "max_vec_bytes",
           "use_kernel", "entry", "launch", "query", "kernel_launch_counts"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the kernel wrappers' launch counters, ``launches.<family>``
LAUNCH_FAMILIES = ("csr_spmm", "sorted_segment_sum", "gat_forward", "gat_backward_dst",
                   "gat_backward_src", "fixed_k_draw", "fixed_k_forward", "fixed_k_backward",
                   "spmm_heads", "sddmm_heads", "tiled_spmm")

_entries: Dict[tuple, object] = {}


def kernel_launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count in this process."""
    found = counters()
    return {name: found.get(f"launches.{name}", 0) for name in LAUNCH_FAMILIES}


def require_cuda(named_tensors, device) -> None:
    """Raise ``ValueError`` at the first ``(name, tensor)`` that is not a
    contiguous CUDA tensor on ``device``."""
    for name, t in named_tensors:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def vec_elements(width: int, loaded, stored=()) -> int:
    """Elements per lane vector: the largest power of two that divides
    ``width``, spans at most 16 bytes of the ``loaded`` tensors (one dtype)
    and keeps every tensor's base address aligned to its vector (to 16
    bytes for a wider stored vector, which the kernels write in 16-byte
    pieces)."""
    vec, elt = 1, loaded[0].element_size()
    while 2 * vec * elt <= 16 and width % (2 * vec) == 0 and all(
            t.data_ptr() % min(2 * vec * t.element_size(), 16) == 0
            for t in (*loaded, *stored)):
        vec *= 2
    return vec


def max_vec_bytes(tensors) -> int:
    """The widest vector load (16 bytes at most) that every tensor's base
    address allows."""
    width = 16
    for t in tensors:
        while t.data_ptr() % width:
            width //= 2
    return width


def use_kernel(t, plain: bool, what: str) -> bool:
    """Whether an op runs its kernel on ``t``'s device: never under
    ``plain`` (its plain version runs on any device), always on a CUDA
    tensor, never on a CPU one; any other device has no ``what`` kernel."""
    if plain or t.device.type == "cpu":
        return False
    if t.is_cuda:
        return True
    raise NotImplementedError(f"no {what} kernel for device {t.device}")


def entry(source: str, symbol: str, argtypes: Sequence, restype=ctypes.c_int):
    """The C entry ``symbol`` of ``source``'s library, looked up and typed
    at its first use (``_build.kernel_function``) and kept."""
    fn = _entries.get((source, symbol))
    if fn is None:
        fn = _entries[source, symbol] = _build.kernel_function(source, symbol, argtypes,
                                                               restype)
    return fn


def _raise_on_error(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: cudaError {rc}")


def launch(source: str, symbol: str, argtypes: Sequence, args: Sequence, device, family: str,
           n=1) -> None:
    """Call the entry ``symbol`` of ``source`` with ``args`` and the
    current stream of ``device`` last (``argtypes`` without the stream),
    raise on the ``cudaError_t`` it returns, and count ``n`` launches of
    ``family``: an int, or a function read after the call (an entry that
    reports how many kernels it launched)."""
    if family not in LAUNCH_FAMILIES:
        raise ValueError(f"launch family {family!r} is not in LAUNCH_FAMILIES")
    fn = entry(source, symbol, [*argtypes, ctypes.c_void_p])
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    _raise_on_error(rc, f"{symbol} kernel launch")
    count(f"launches.{family}", n() if callable(n) else n)


def query(source: str, symbol: str, argtypes: Sequence, args: Sequence) -> None:
    """Call an entry that launches nothing and returns a ``cudaError_t``
    (a kernel's attributes on the card); raise on its error."""
    _raise_on_error(entry(source, symbol, argtypes)(*args), symbol)
