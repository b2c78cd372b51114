"""COO SpMM / SDDMM with a hand-written backward, in plain PyTorch.

Counterpart of ``tf_geometric_tpu/ops/spmm.py``:

    forward:   y[r] = Σ_{e: row[e]=r} value[e] · h[col[e]]
    d/d h:     dh = Aᵀ @ dy       (SpMM with swapped index)
    d/d value: dv[e] = <dy[row[e]], h[col[e]]>   (SDDMM; 0 for padded edges)

This is the no-cache path (``SparseMatrix.matmul``). Its Hopper kernel is a
later slice of the port (ROADMAP §2, "ops/spmm.py spmm / sddmm"), so on a
CUDA tensor these functions raise instead of running plain PyTorch there;
the GCN path on the card goes through the cached ``CsrAdj`` instead.
"""
from __future__ import annotations

import torch

from .. import _segment_core as _seg

__all__ = ["spmm", "sddmm"]


def _require_cpu(*tensors):
    for t in tensors:
        if t.device.type != "cpu":
            raise NotImplementedError(
                "COO spmm/sddmm has no CUDA kernel yet (ROADMAP §2, ops/spmm.py "
                "spmm / sddmm); build the cache so the CSR path is used, or run "
                f"on the CPU (got a tensor on {t.device})")


def _gather_rows(h, ids):
    """Clamped gather: out-of-range (padded) ids read a valid row harmlessly."""
    return h[ids.long().clamp(0, h.shape[0] - 1)]


def _spmm_plain(index, value, h, num_rows: int):
    msg = _gather_rows(h, index[1]) * value[:, None].to(h.dtype)
    return _seg.segment_sum(msg, index[0], num_rows)


def _sddmm_plain(index, a, b):
    return (_gather_rows(a, index[0]) * _gather_rows(b, index[1])).sum(-1)


class _Spmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, index, value, h, num_rows):
        ctx.save_for_backward(index, value, h)
        ctx.num_rows = num_rows
        return _spmm_plain(index, value, h, num_rows)

    @staticmethod
    def backward(ctx, dy):
        index, value, h = ctx.saved_tensors
        dh = dv = None
        if ctx.needs_input_grad[2]:
            dh = _spmm_plain(index.flip(0), value, dy, h.shape[0])
        if ctx.needs_input_grad[1]:
            dv = _sddmm_plain(index, dy, h)
            valid = (index[0] >= 0) & (index[0] < ctx.num_rows)
            dv = torch.where(valid, dv, torch.zeros_like(dv))
        return None, dv, dh, None


def spmm(index, value, h, num_rows: int):
    """COO SpMM ``A @ h`` with a custom backward (CPU tensors only)."""
    _require_cpu(index, value, h)
    return _Spmm.apply(index, value, h, num_rows)


def sddmm(index, a, b):
    """Per-edge inner product ``out[e] = <a[row[e]], b[col[e]]>`` (CPU tensors only)."""
    _require_cpu(index, a, b)
    return _sddmm_plain(index, a, b)
