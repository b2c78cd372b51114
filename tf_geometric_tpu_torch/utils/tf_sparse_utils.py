"""Sparse-feature slicing helpers (JAX counterpart:
``tf_geometric_tpu/utils/tf_sparse_utils.py``).

``sparse_gather_sub`` selects and relabels the rows (or columns) of a
SparseMatrix, as sampling sparse node features needs it; the selection is
made on the host, the values are gathered on their device so a gradient
reaches them. ``compute_num_or_size_splits`` is the feature-dim split plan
of the chunked SpMM (``SparseMatrix.matmul(h, num_or_size_splits)``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..sparse.matrix import SparseMatrix
from .union_utils import convert_union_to_numpy

__all__ = ["sparse_gather_sub", "sparse_tensor_gather_sub", "compute_num_or_size_splits"]


def sparse_gather_sub(x: SparseMatrix, sub_index, axis: int = 0) -> SparseMatrix:
    """The rows (``axis`` 0) or columns (``axis`` 1) ``sub_index`` of ``x``,
    renumbered ``0..len(sub_index) - 1``, entries in their stored order, on
    ``x``'s device."""
    index = convert_union_to_numpy(x.index, np.int64)
    sub_index = convert_union_to_numpy(sub_index, np.int64)
    gather_axis = 0 if axis in (0, -2) else 1
    other_axis = 1 - gather_axis
    size = x.shape[gather_axis]
    mask = np.zeros(size, bool)
    mask[sub_index] = True
    keep = mask[index[gather_axis]]
    reverse = np.full(size, -1, np.int64)
    reverse[sub_index] = np.arange(len(sub_index))
    new_index = np.empty((2, int(keep.sum())), np.int64)
    new_index[gather_axis] = reverse[index[gather_axis][keep]]
    new_index[other_axis] = index[other_axis][keep]
    new_shape = [0, 0]
    new_shape[gather_axis] = len(sub_index)
    new_shape[other_axis] = x.shape[other_axis]
    kept = torch.as_tensor(np.nonzero(keep)[0], device=x.device)
    return SparseMatrix(torch.as_tensor(new_index, device=x.device), x.value[kept],
                        tuple(new_shape))


def sparse_tensor_gather_sub(x: SparseMatrix, sub_index, axis: int = 0) -> SparseMatrix:
    """The reference's ``tf.sparse.SparseTensor`` variant: SparseMatrix is the
    port's one sparse container, so this is ``sparse_gather_sub``."""
    return sparse_gather_sub(x, sub_index, axis=axis)


def compute_num_or_size_splits(num_h_features: int, num_splits):
    """Split plan over the feature dim: None for no split, ``num_splits``
    when it divides the width, else chunks of ``ceil(F / num_splits)`` and
    a remainder (raises when that plan has another count)."""
    if num_splits is None or num_splits == 1:
        return None
    if num_h_features % num_splits == 0:
        return num_splits
    split_size = int(np.ceil(num_h_features / num_splits))
    num_pre = num_h_features // split_size
    last = num_h_features % split_size
    plan = [split_size] * num_pre + ([last] if last > 0 else [])
    if len(plan) != num_splits:
        raise ValueError(f"cannot split H of shape [None, {num_h_features}] into "
                         f"{num_splits} matrices, please provide a valid num_splits")
    return plan
