"""TAGCN: Topology Adaptive GCN (JAX counterpart:
``tf_geometric_tpu/nn/conv/tagcn.py``)."""
from __future__ import annotations

import torch

from ...sparse.matrix import SparseMatrix
from .gcn import compute_cache_key, gcn_norm_adj, maybe_compile_ell

__all__ = ["tagcn"]


def tagcn(x, edge_index, edge_weight, k: int, kernel, bias=None, activation=None,
          renorm: bool = False, improved: bool = False, cache=None):
    """Concatenate [x, Âx, …, Â^k x], then one dense product; the hops run
    over the CSR twin of the cached normalized adjacency. Default
    ``renorm=False``, as the reference."""
    num_nodes = x.shape[0]
    normed_adj = gcn_norm_adj(
        SparseMatrix(edge_index, edge_weight, (num_nodes, num_nodes), device=x.device),
        renorm=renorm, improved=improved, cache=cache)
    normed_adj = maybe_compile_ell(
        normed_adj, cache, compute_cache_key("both", True, True, renorm, improved))

    if isinstance(x, SparseMatrix):
        x = x.to_dense()

    xs = [x]
    for _ in range(k):
        xs.append(normed_adj @ xs[-1])
    out = torch.cat(xs, dim=-1) @ kernel
    if bias is not None:
        out = out + bias
    if activation is not None:
        out = activation(out)
    return out
