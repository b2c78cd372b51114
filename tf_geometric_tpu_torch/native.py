"""Host-side CSR helpers in numpy (JAX counterpart: the numpy branch of
``sort_by_row`` and ``build_row_ptr`` in ``tf_geometric_tpu/native/__init__.py``,
whose compiled C++ path gives the same arrays).

Rows outside ``[0, num_rows]`` (negative ids, or padded ids past
``num_rows``) sort into a trailing bucket after row ``num_rows - 1``; the row
pointers count in-range rows only, so no CSR view reaches the strays.
"""
from __future__ import annotations

import numpy as np

__all__ = ["sort_by_row", "build_row_ptr"]


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
