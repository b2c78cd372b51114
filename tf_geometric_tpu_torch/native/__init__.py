"""Host-side graph ops (JAX counterpart: ``tf_geometric_tpu/native/__init__.py``).

``sort_by_row`` and ``build_row_ptr`` are numpy: their arrays equal those of
the JAX module's compiled counting sort. The fixed-k neighbour draw, label
propagation and the partition refinement run in C++ (``graph_ops.cpp``,
this package's own copy of the JAX package's ops), compiled with ``g++ -O3
-std=c++17 -shared -fPIC`` (and ``-fopenmp`` where that builds) at their
first use into ``tf_geometric_tpu_torch/_build/native/``, keyed by the
source's hash, and loaded with ctypes. Without a compiler, or with
``TFG_TPU_NATIVE=0``, ``available()`` is False and each of the three returns
None, as JAX's do: the callers then take their numpy branch.

Rows outside ``[0, num_rows]`` (negative ids, or padded ids past
``num_rows``) sort into a trailing bucket after row ``num_rows - 1``; the row
pointers count in-range rows only, so no CSR view reaches the strays.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["available", "sort_by_row", "build_row_ptr", "sample_fixed_k", "lpa_labels",
           "partition_refine"]

_SRC = Path(__file__).with_name("graph_ops.cpp")
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build" / "native"
_BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _compile() -> Optional[Path]:
    """The library for the current source, compiled if missing (into a
    per-process temporary name, then renamed, so concurrent builds do not
    see each other's half-written files); None when g++ cannot build it."""
    key = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so_path = _BUILD_DIR / f"graph_ops_{key}.so"
    if so_path.exists():
        return so_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_name(f"{so_path.name}.{os.getpid()}.tmp")
    base = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)]
    for cmd in (base + ["-fopenmp"], base):
        try:
            proc = subprocess.run(cmd, capture_output=True, timeout=_BUILD_TIMEOUT_S)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if proc.returncode == 0:
            os.replace(tmp, so_path)
            return so_path
    return None


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.tfg_sample_fixed_k.argtypes = [i64p, i32p, f32p, i64p, ctypes.c_int64, ctypes.c_int32,
                                       ctypes.c_uint64, i32p, f32p]
    lib.tfg_sample_fixed_k.restype = None
    lib.tfg_lpa_sweep.argtypes = [i64p, i32p, ctypes.c_int32, i64p, i64p]
    lib.tfg_lpa_sweep.restype = ctypes.c_int64
    lib.tfg_partition_refine.argtypes = [i64p, i32p, ctypes.c_int32, ctypes.c_int32, i64p,
                                         ctypes.c_int32, ctypes.c_int32, i32p]
    lib.tfg_partition_refine.restype = ctypes.c_int64
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            if os.environ.get("TFG_TPU_NATIVE", "1") != "0":
                path = _compile()
                if path is not None:
                    try:
                        _lib = _load(path)
                    except OSError:
                        _lib = None
        return _lib


def available() -> bool:
    """True when the compiled library is loaded."""
    return _get_lib() is not None


def sort_by_row(rows, num_rows: int) -> np.ndarray:
    """Stable order such that ``rows[order]`` is row-sorted, strays last."""
    rows = np.ascontiguousarray(rows, np.int32)
    clamped = np.where((rows < 0) | (rows > num_rows), num_rows, rows)
    return np.argsort(clamped, kind="stable")


def build_row_ptr(rows, num_rows: int) -> np.ndarray:
    """CSR row pointers [num_rows + 1] int64 (rows may be unsorted;
    out-of-range entries are ignored)."""
    rows = np.ascontiguousarray(rows, np.int32)
    counts = np.bincount(rows[(rows >= 0) & (rows < num_rows)], minlength=num_rows)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def sample_fixed_k(row_ptr, col, weight, sources, k: int, seed: int):
    """k neighbours per source, with replacement, from the CSR ``row_ptr`` /
    ``col`` / ``weight``; a source without edges points at itself with
    weight 0. A function of (seed, source) only. Returns (col [S, k] int32,
    weight [S, k] float32), or None without the library."""
    lib = _get_lib()
    if lib is None:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, np.int64)
    col = np.ascontiguousarray(col, np.int32)
    weight = np.ascontiguousarray(weight, np.float32)
    sources = np.ascontiguousarray(sources, np.int64)
    if sources.size and (sources.min() < 0 or sources.max() >= row_ptr.shape[0] - 1):
        raise ValueError("sample_fixed_k: a source lies outside the CSR's rows")
    num_sources = sources.shape[0]
    out_col = np.empty((num_sources, k), np.int32)
    out_w = np.empty((num_sources, k), np.float32)
    lib.tfg_sample_fixed_k(row_ptr, col, weight, sources, num_sources, int(k),
                           np.uint64(seed), out_col.reshape(-1), out_w.reshape(-1))
    return out_col, out_w


def lpa_labels(row_ptr, col, num_nodes: int, num_iters: int = 8):
    """Synchronous majority-vote label propagation from ``arange(num_nodes)``
    (smallest label on a tie), at most ``num_iters`` sweeps, stopping at the
    first sweep that changes nothing; the final labels, or None without the
    library."""
    lib = _get_lib()
    if lib is None:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, np.int64)
    col = np.ascontiguousarray(col, np.int32)
    labels = np.arange(num_nodes, dtype=np.int64)
    new_labels = np.empty_like(labels)
    for _ in range(num_iters):
        changes = lib.tfg_lpa_sweep(row_ptr, col, int(num_nodes), labels, new_labels)
        labels, new_labels = new_labels, labels
        if changes == 0:
            break
    return labels.copy()


def partition_refine(row_ptr, col, part, caps, slack: int, num_iters: int):
    """Capacity-bounded refinement and exact repair of ``part`` (int32 [N],
    C-contiguous, changed in place so that each part's fill equals its cap)
    over a symmetric CSR graph (``parallel/partition.py``'s
    ``partition_order`` steps 3-4); the number of moves, or None without the
    library."""
    lib = _get_lib()
    if lib is None:
        return None
    if part.dtype != np.int32 or not part.flags.c_contiguous:
        raise ValueError("partition_refine: part must be a C-contiguous int32 array")
    row_ptr = np.ascontiguousarray(row_ptr, np.int64)
    col = np.ascontiguousarray(col, np.int32)
    caps = np.ascontiguousarray(caps, np.int64)
    return int(lib.tfg_partition_refine(row_ptr, col, int(part.shape[0]), int(caps.shape[0]),
                                        caps, int(slack), int(num_iters), part))
