"""COO sparse-matrix container (JAX counterpart: ``tf_geometric_tpu/sparse/matrix.py``).

* ``index [2, nnz]`` (int64) and ``value [nnz]`` (float) are tensors on one
  device; ``shape`` is a Python tuple.
* Padded entries use out-of-range row ids (``row == shape[0]``) with zero
  values; every segment op drops them.
* Row convention: ``index[0] = row`` is the aggregation destination,
  ``index[1] = col`` the source.

A SparseMatrix built from numpy or a list lands on ``device`` (default
``"cuda"``); one built from tensors stays on their device. ``matmul``, ``@``
and ``rmatmul_dense`` run ``ops/spmm.py``: the hand-written kernels on the
card, their plain versions on the CPU.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from .. import _segment_core as _seg

__all__ = ["SparseMatrix", "diags", "eye", "concat", "sparse_shape", "chunked_feature_matmul"]


def chunked_feature_matmul(spmm_fn, h, num_or_size_splits):
    """Feature-dim chunked SpMM (the reference's large-graph lever,
    nn/conv/gcn.py:274-280): split ``h``'s last dim, run ``spmm_fn`` per
    chunk sequentially to bound peak memory, and concatenate."""
    if num_or_size_splits is None:
        return spmm_fn(h)
    if isinstance(num_or_size_splits, int):
        chunks = torch.tensor_split(h, num_or_size_splits, dim=-1)
    else:
        sections = np.cumsum(num_or_size_splits)[:-1].tolist()
        chunks = torch.tensor_split(h, sections, dim=-1)
    return torch.cat([spmm_fn(c) for c in chunks], dim=-1)


def _as_tensor(data, device, dtype=None):
    if isinstance(data, torch.Tensor):
        return data if dtype is None else data.to(dtype)
    return torch.as_tensor(np.asarray(data), dtype=dtype, device=device)


class SparseMatrix:
    """COO matrix with a fixed shape, mirroring ``tf_sparse.SparseMatrix``."""

    __slots__ = ("index", "value", "_shape")

    def __init__(self, index, value=None, shape=None, device="cuda"):
        index = _as_tensor(index, device, torch.int64)
        if index.dim() != 2 or index.shape[0] != 2:
            raise ValueError(f"index must be [2, nnz], got shape {tuple(index.shape)}")
        if value is None:
            value = torch.ones(index.shape[1], dtype=torch.float32, device=index.device)
        else:
            value = _as_tensor(value, index.device)
            if value.dtype == torch.float64:
                value = value.float()
            value = value.to(index.device)
            if value.shape[:1] != index.shape[1:]:
                raise ValueError(f"value length {tuple(value.shape)} does not "
                                 f"match nnz {index.shape[1]}")
        if shape is None:
            n = int(index.max()) + 1 if index.numel() else 0
            shape = (n, n)
        self.index = index
        self.value = value
        self._shape = (int(shape[0]), int(shape[1]))

    @property
    def shape(self) -> Tuple[int, int]:
        return self._shape

    @property
    def row(self):
        return self.index[0]

    @property
    def col(self):
        return self.index[1]

    @property
    def nnz(self) -> int:
        return int(self.index.shape[1])

    @property
    def device(self):
        return self.index.device

    def with_value(self, new_value) -> "SparseMatrix":
        return SparseMatrix(self.index, new_value, self._shape)

    def __repr__(self):
        return (f"SparseMatrix(shape={self._shape}, nnz={self.nnz}, "
                f"dtype={self.value.dtype}, device={self.device})")

    @classmethod
    def from_dense(cls, dense) -> "SparseMatrix":
        """COO of the nonzero entries of a dense 2-D tensor (same device)."""
        row, col = torch.nonzero(dense, as_tuple=True)
        return cls(torch.stack([row, col]), dense[row, col].float(), tuple(dense.shape))

    def to_scipy(self):
        """A ``scipy.sparse.coo_matrix`` of the in-range entries, on the host."""
        import scipy.sparse as sp
        index = self.index.detach().cpu().numpy()
        value = self.value.detach().cpu().numpy()
        ok = ((index[0] >= 0) & (index[0] < self._shape[0])
              & (index[1] >= 0) & (index[1] < self._shape[1]))
        return sp.coo_matrix((value[ok], (index[0][ok], index[1][ok])), shape=self._shape)

    @classmethod
    def from_scipy(cls, mat, device="cuda") -> "SparseMatrix":
        """The entries of a scipy sparse matrix (in its COO order), float32
        values, on ``device``."""
        coo = mat.tocoo()
        index = np.stack([coo.row, coo.col], axis=0).astype(np.int64)
        return cls(index, coo.data.astype(np.float32), coo.shape, device=device)

    # -- linear algebra ------------------------------------------------------
    def matmul(self, h, num_or_size_splits=None):
        """SpMM ``self @ h`` for dense ``h`` [shape[1], F]; ``num_or_size_splits``
        chunks the feature dim (nn/conv/gcn.py:274-280)."""
        if isinstance(h, SparseMatrix):
            return self._matmul_sparse(h)
        return chunked_feature_matmul(self._spmm, h, num_or_size_splits)

    def _spmm(self, h):
        from ..ops import spmm as _spmm_op
        return _spmm_op.spmm(self.index, self.value, h, self._shape[0])

    def _matmul_sparse(self, other: "SparseMatrix") -> "SparseMatrix":
        """Sparse @ sparse through a dense intermediate, as the JAX package does."""
        return SparseMatrix.from_dense(self.to_dense() @ other.to_dense())

    def __matmul__(self, h):
        return self.matmul(h)

    def rmatmul_dense(self, h):
        """``h @ self`` for dense ``h``: ``(selfᵀ @ hᵀ)ᵀ``."""
        return self.transpose()._spmm(h.T.contiguous()).T

    # -- segment reductions --------------------------------------------------
    def _axis_ids(self, axis: int):
        if axis in (-1, 1):
            return self.row, self._shape[0]
        if axis in (0, -2):
            return self.col, self._shape[1]
        raise ValueError(f"invalid axis {axis}")

    def segment_sum(self, axis: int = -1):
        """Reduce values along ``axis``; axis=-1 sums each row."""
        ids, n = self._axis_ids(axis)
        return _seg.segment_sum(self.value, ids, n)

    def segment_max(self, axis: int = -1):
        ids, n = self._axis_ids(axis)
        return _seg.segment_max(self.value, ids, n)

    def segment_mean(self, axis: int = -1):
        ids, n = self._axis_ids(axis)
        return _seg.segment_mean(self.value, ids, n)

    def segment_softmax(self, axis: int = -1) -> "SparseMatrix":
        ids, n = self._axis_ids(axis)
        return self.with_value(_seg.segment_softmax(self.value, ids, n))

    # -- structural ops ------------------------------------------------------
    def add_diag(self, diag_value: Union[float, torch.Tensor] = 1.0) -> "SparseMatrix":
        """Append diagonal entries (self-loops) AFTER the existing edges;
        nnz grows by min(shape). Duplicate coordinates sum downstream."""
        n = min(self._shape)
        diag_idx = torch.arange(n, device=self.device).repeat(2, 1)
        if isinstance(diag_value, (int, float)):
            diag_val = torch.full((n,), float(diag_value), dtype=self.value.dtype,
                                  device=self.device)
        else:
            diag_val = torch.broadcast_to(
                torch.as_tensor(diag_value, dtype=self.value.dtype, device=self.device),
                (n,))
        return SparseMatrix(torch.cat([self.index, diag_idx], dim=1),
                            torch.cat([self.value, diag_val]), self._shape)

    def add_self_loop(self, fill_weight: float = 1.0) -> "SparseMatrix":
        return self.add_diag(fill_weight)

    def transpose(self) -> "SparseMatrix":
        return SparseMatrix(self.index.flip(0), self.value,
                            (self._shape[1], self._shape[0]))

    @property
    def T(self) -> "SparseMatrix":
        return self.transpose()

    def dropout(self, rate: float, generator=None, training: bool = True,
                keep_mask=None) -> "SparseMatrix":
        """Zero entries with probability ``rate`` and scale survivors by
        1/(1-rate). The keep decisions come from ``keep_mask`` if given, else
        are drawn with ``generator``; one of the two is required when
        training with rate > 0."""
        if not training or rate <= 0.0:
            return self
        if keep_mask is None:
            if generator is None:
                raise ValueError(
                    "SparseMatrix.dropout requires a generator or keep_mask when "
                    "training with rate > 0 (a silent no-op would train "
                    "unregularized)")
            keep_mask = torch.rand(self.value.shape, generator=generator,
                                   device=self.device) < (1.0 - rate)
        keep_mask = torch.as_tensor(keep_mask, dtype=torch.bool, device=self.device)
        return self.with_value(torch.where(keep_mask, self.value / (1.0 - rate),
                                           torch.zeros_like(self.value)))

    def to_dense(self):
        """Densify; duplicate coordinates sum, out-of-range entries drop."""
        n_rows, n_cols = self._shape
        valid = ((self.row >= 0) & (self.row < n_rows)
                 & (self.col >= 0) & (self.col < n_cols))
        flat = torch.where(valid, self.row * n_cols + self.col,
                           torch.full_like(self.row, n_rows * n_cols))
        return _seg.segment_sum(self.value, flat, n_rows * n_cols).reshape(n_rows, n_cols)

    # scalar arithmetic on the values
    def __mul__(self, scalar):
        return self.with_value(self.value * scalar)

    __rmul__ = __mul__

    def __truediv__(self, scalar):
        return self.with_value(self.value / scalar)

    def __neg__(self):
        return self.with_value(-self.value)


def diags(diagonal, device="cuda") -> SparseMatrix:
    """Diagonal SparseMatrix from a vector (tfs.diags)."""
    diagonal = _as_tensor(diagonal, device)
    n = diagonal.shape[0]
    idx = torch.arange(n, device=diagonal.device).repeat(2, 1)
    return SparseMatrix(idx, diagonal, (n, n))


def eye(n: int, dtype=torch.float32, device="cuda") -> SparseMatrix:
    """Identity SparseMatrix (tfs.eye)."""
    return diags(torch.ones(n, dtype=dtype, device=device))


def concat(matrices: Sequence[SparseMatrix], axis: int = 0) -> SparseMatrix:
    """Block-concatenate sparse matrices along rows (axis=0) or cols (axis=1).

    Out-of-range (padded) entries stay out of range in the result."""
    if axis not in (0, 1):
        raise ValueError("concat supports axis 0 or 1")
    total = sum(m.shape[axis] for m in matrices)
    other_size = max((m.shape[1 - axis] for m in matrices), default=0)
    parts_idx, parts_val = [], []
    offset = 0
    for m in matrices:
        ax_ids = m.index[axis]
        ot_ids = m.index[1 - axis]
        valid = ((ax_ids >= 0) & (ax_ids < m.shape[axis])
                 & (ot_ids >= 0) & (ot_ids < m.shape[1 - axis]))
        new_ax = torch.where(valid, ax_ids + offset, torch.full_like(ax_ids, total))
        new_ot = torch.where(valid, ot_ids, torch.full_like(ot_ids, other_size))
        parts_idx.append(torch.stack([new_ax, new_ot]) if axis == 0
                         else torch.stack([new_ot, new_ax]))
        parts_val.append(m.value)
        offset += m.shape[axis]
    shape = (total, other_size) if axis == 0 else (other_size, total)
    return SparseMatrix(torch.cat(parts_idx, dim=1), torch.cat(parts_val), shape)


def sparse_shape(x):
    """The shape of a dense tensor or array or of a SparseMatrix, as a tuple."""
    if isinstance(x, SparseMatrix):
        return x.shape
    return tuple(x.shape)
