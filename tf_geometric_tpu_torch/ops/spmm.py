"""COO SpMM / SDDMM with a hand-written backward (JAX counterpart:
``tf_geometric_tpu/ops/spmm.py``):

    forward:   y[r] = Σ_{e: row[e]=r} value[e] · h[clip(col[e])]
    d/d h:     dh = Aᵀ @ dy       (SpMM with swapped index)
    d/d value: dv[e] = <dy[row[e]], h[clip(col[e])]>   (SDDMM; 0 for padded edges)

Edges come in any order and duplicates sum. An edge whose row is out of
range is dropped; one whose column is out of range with an in-range row
reads the clamped row ``h[clip(col)]``, as the JAX op's ``_gather_rows``
does. ``dh`` runs on the swapped index with ``h.shape[0]`` rows, so an edge
with an out-of-range row still reaches ``dh`` through ``dy[clip(row)]``.

Each call builds CSR views of the edge list on the tensors' device
(``ops/spmm_heads.build_csr_view``, a stable sort by row for the forward and
``dv``, by column for ``dh``) and runs the H-head kernels of
``csrc/spmm_heads.cu`` with one head on CUDA tensors, their plain versions
on CPU tensors and inside ``ops.config.use_plain_versions()``.

Types follow JAX's promotion: the result is ``promote_types(h, value)``
(bfloat16 ``h`` with float32 values gives float32, the product formed in
float32), ``dh`` is ``promote_types(dy, value)`` and ``dv``
``promote_types(dy, h)``, as the JAX VJP returns them; PyTorch's autograd
then hands each gradient to its input in the input's own dtype.
"""
from __future__ import annotations

import torch

from . import config as _config
from .spmm_heads import CsrView, build_csr_view, sddmm_heads, spmm_heads

__all__ = ["spmm", "sddmm", "spmm_xla", "sddmm_xla"]


def _gather_rows(h, ids):
    """Clipped gather: an out-of-range (padded) id reads row 0 or the last."""
    return h[ids.long().clamp(0, h.shape[0] - 1)]


def spmm_xla(index, value, h, num_rows: int):
    """The plain COO SpMM, the JAX package's XLA reference: gather, scale,
    and a sum by row in PyTorch (an edge whose row is out of range drops
    out); autograd differentiates it as it stands."""
    row = index[0].long()
    msg = _gather_rows(h, index[1]) * value[:, None]
    keep = (row >= 0) & (row < num_rows)
    out = torch.zeros((num_rows, h.shape[1]), dtype=msg.dtype, device=h.device)
    return out.index_add(0, row[keep], msg[keep])


def sddmm_xla(index, a, b):
    """The plain per-edge inner product ``out[e] = <a[clip(row[e])],
    b[clip(col[e])]>``, the JAX package's XLA reference."""
    return (_gather_rows(a, index[0]) * _gather_rows(b, index[1])).sum(-1)


class _Spmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, index, value, h, num_rows, plain):
        view = build_csr_view(index[0], index[1], num_rows, h.shape[0])
        w = value.float()[:, None].contiguous()
        out = spmm_heads(view, w, h, 1, torch.promote_types(h.dtype, value.dtype), plain)
        ctx.save_for_backward(index, w, h, *view)
        ctx.num_rows, ctx.plain, ctx.value_dtype = num_rows, plain, value.dtype
        return out

    @staticmethod
    def backward(ctx, dy):
        index, w, h, *fwd_view = ctx.saved_tensors
        dy = dy.contiguous()
        dh = dv = None
        if ctx.needs_input_grad[2]:
            bwd_view = build_csr_view(index[1], index[0], h.shape[0], ctx.num_rows)
            dh = spmm_heads(bwd_view, w, dy, 1, torch.promote_types(dy.dtype, ctx.value_dtype),
                            ctx.plain)
        if ctx.needs_input_grad[1]:
            # the forward's view holds exactly the edges with an in-range row;
            # the others keep dv = 0
            dv = torch.zeros((index.shape[1], 1), dtype=torch.float32, device=dy.device)
            sddmm_heads(CsrView(*fwd_view), dy, h, 1, dv, ctx.plain)
            dv = dv[:, 0].to(torch.promote_types(dy.dtype, h.dtype))
        return None, dv, dh, None, None


def spmm(index, value, h, num_rows: int):
    """COO SpMM ``A @ h`` (``index`` [2, E], ``value`` [E], ``h`` [C, F]),
    differentiable in ``value`` and ``h``."""
    if h.dim() != 2 or index.dim() != 2 or index.shape[0] != 2 or value.shape != index.shape[1:]:
        raise ValueError(f"index must be [2, E], value [E] and h [C, F]: {tuple(index.shape)}, "
                         f"{tuple(value.shape)}, {tuple(h.shape)}")
    return _Spmm.apply(index, value, h, num_rows, _config.plain_versions)


def sddmm(index, a, b):
    """Per-edge inner product ``out[e] = <a[clip(row[e])], b[clip(col[e])]>``
    (the GAT score), in ``promote_types(a, b)``."""
    out = torch.zeros((index.shape[1], 1), dtype=torch.float32, device=a.device)
    if a.shape[0] and b.shape[0]:
        rows = index[0].long().clamp(0, a.shape[0] - 1)
        sddmm_heads(build_csr_view(rows, index[1], a.shape[0], b.shape[0]), a, b, 1, out,
                    _config.plain_versions)
    return out[:, 0].to(torch.promote_types(a.dtype, b.dtype))
