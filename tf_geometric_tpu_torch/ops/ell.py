"""``ell_spmm``: ``A·h`` with an optional per-edge value gradient (JAX
counterpart: ``tf_geometric_tpu/ops/ell.py``, ``ell_spmm`` and
``EllAdj.with_edge_values``).

The JAX function runs on a uniform-K ELL packing, square with a split
diagonal or rectangular; the graph-parallel runtime uses it for the halo
shards' local and remote blocks (``parallel/halo.py``). The port keeps its
contract on a ``CsrAdj`` of either shape, so the products run in the kernels
that already serve the single-chip GCN: Kernel A (``csrc/csr_spmm.cu``) on
the forward side and, for ``dh = Aᵀ·dy``, on the transposed side, each
followed by Kernel B (``csrc/sorted_segment.cu``) where a block has hub rows.
With ``diff_values=True`` the backward also gives each edge's value gradient
``dv[e] = <dy[row_e], h[col_e]>`` (0 on padded or dropped edges, the split
diagonal's edges included) by the SDDMM kernel of ``csrc/spmm_heads.cu``
with one head: once over the forward side, whose virtual rows read the
``dy`` row of the hub that owns them, and once over the diagonal. The
gradient flows to the tensor given to ``with_edge_values`` here; the
``CsrAdj`` method of that name keeps its constant-value contract.

Bound on the H100: bytes, as Kernel A's and the SDDMM's
(``ops/spmm_heads.sddmm_pass_bytes``).
"""
from __future__ import annotations

import torch

from . import config as _config
from .csr_spmm import CsrAdj, CsrSide, csr_spmm, side_matmul, side_matmul_plain
from .spmm_heads import CsrView, sddmm_heads, spmm_multihead

__all__ = ["ell_spmm", "ell_spmm_multihead", "with_edge_values", "side_value_grad"]

# the JAX function's name for the attention-weighted multi-head SpMM over a
# GAT layout (``ell_spmm_multihead(ell, edge_att, v, d_head)``): the port
# runs it on a ``CsrGatLayout`` (``csrc/spmm_heads.cu``)
ell_spmm_multihead = spmm_multihead


def with_edge_values(adj: CsrAdj, edge_values) -> CsrAdj:
    """``adj`` re-skinned with per-edge values [num_edges] (both directions
    and the diagonal, through the edge-id maps), carrying ``edge_values`` so
    that ``ell_spmm(..., diff_values=True)`` returns their gradient, as the
    JAX ``EllAdj.with_edge_values`` does."""
    out = adj.with_edge_values(edge_values)
    out.edge_values = edge_values
    return out


def _virtual_owners(side: CsrSide):
    """[num_virtual] the owner row of each virtual row (the count given, so
    the host does not wait for the device)."""
    chunks = (side.owner_ptr[1:] - side.owner_ptr[:-1]).long()
    return torch.repeat_interleave(side.owner_rows.long(), chunks, output_size=side.num_virtual)


def side_value_grad(adj: CsrAdj, h, dy, plain: bool = False):
    """``dv[e] = <dy[row_e], h[col_e]>`` float32 [num_edges] for every edge
    stored in ``adj`` (split diagonal included), 0 elsewhere: the SDDMM over
    the forward side (a virtual row reads its owner's ``dy`` row) and over
    the diagonal, its kernel on CUDA tensors, its plain version on CPU ones
    or under ``plain``."""
    side = adj.fwd
    out = torch.zeros((adj.num_edges + 1, 1), dtype=torch.float32, device=dy.device)
    a = dy if not side.num_virtual else torch.cat([dy, dy[_virtual_owners(side)]])
    view = CsrView(side.row_ptr, side.col, side.eid.int())
    sddmm_heads(view, a, h, 1, out, plain=plain)
    if adj.diag_val is not None:
        rows = torch.arange(adj.shape[0] + 1, dtype=torch.int32, device=dy.device)
        diag = CsrView(rows, rows[:-1], adj.diag_eid.int())  # sentinel id num_edges
        sddmm_heads(diag, dy, h[:adj.shape[0]], 1, out, plain=plain)
    return out[:adj.num_edges, 0]


class _EllSpmmValues(torch.autograd.Function):
    """``A·h`` whose backward gives ``dh = Aᵀ·dy`` and the edge values'
    gradient."""

    @staticmethod
    def forward(ctx, h, values, adj, plain):
        ctx.save_for_backward(h)
        ctx.adj, ctx.plain = adj, plain
        return (side_matmul_plain if plain else side_matmul)(adj.fwd, h, adj.diag_val)

    @staticmethod
    def backward(ctx, dy):
        (h,) = ctx.saved_tensors
        adj, plain = ctx.adj, ctx.plain
        dy = dy.contiguous()
        dh = dv = None
        if ctx.needs_input_grad[0]:
            dh = (side_matmul_plain if plain else side_matmul)(adj.bwd, dy, adj.diag_val)
        if ctx.needs_input_grad[1]:
            dv = side_value_grad(adj, h, dy, plain).to(adj.edge_values.dtype)
        return dh, dv, None, None


def ell_spmm(adj: CsrAdj, h, diff_values: bool = False, compute_dtype=None):
    """``A @ h`` for a ``CsrAdj`` (square or rectangular). ``diff_values=True``
    also gives the gradient of the values the layout was re-skinned with by
    ``with_edge_values`` (a layout without them has constant values, as
    ``diff_values=False`` treats every layout). ``h`` is cast to
    ``compute_dtype`` (default ``ops.config.ell_compute_dtype``) for the
    product and the result cast back."""
    if not diff_values or adj.edge_values is None:
        return csr_spmm(adj, h, compute_dtype)
    if h.dim() != 2 or h.shape[0] != adj.shape[1]:
        raise ValueError(f"h must be [{adj.shape[1]}, F], got {tuple(h.shape)}")
    cd = compute_dtype if compute_dtype is not None else _config.ell_compute_dtype
    orig_dtype = h.dtype
    if cd is not None and orig_dtype != cd:
        h = h.to(cd)
    out = _EllSpmmValues.apply(h.contiguous(), adj.edge_values, adj, _config.plain_versions)
    return out.to(orig_dtype)
