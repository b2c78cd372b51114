"""GCN: normalization precompute + forward (JAX counterpart:
``tf_geometric_tpu/nn/conv/gcn.py``).

The forward is dense ``x @ W`` then one SpMM ``Â @ h``. Normalization
(``gcn_norm_adj``) is a precompute producing a new SparseMatrix, stored in the
per-graph ``cache`` dict under a key over the full normalization config; the
CSR twin of the normalized matrix (``maybe_compile_ell``) and the propagated
features are derived entries of the same cache.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...ops.csr_spmm import CsrAdj
from ...sparse.matrix import SparseMatrix
from ..kernel.map_reduce import gcn_mapper

__all__ = [
    "gcn",
    "gcn_norm_adj",
    "gcn_build_cache_by_adj",
    "gcn_build_cache_for_graph",
    "gcn_norm_edge",
    "gcn_cache_normed_edge",
    "gcn_mapper",
    "compute_cache_key",
    "compile_and_dropout",
    "precompute_propagated_features",
    "maybe_compile_ell",
]

CACHE_KEY_GCN_NORMED_ADJ_TEMPLATE = "gcn_normed_adj_{}_{}_{}_{}_{}"


def compute_cache_key(norm, add_self_loop, sym, renorm, improved):
    """Cache key over the full normalization config."""
    return CACHE_KEY_GCN_NORMED_ADJ_TEMPLATE.format(norm, add_self_loop, sym, renorm, improved)


def _inv_pow_no_nan(deg, power):
    """deg**power with inf/nan -> 0: isolated nodes get weight 0."""
    out = torch.where(deg > 0, torch.clamp_min(deg, 1e-38).pow(power),
                      torch.zeros_like(deg))
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def _scale_rows_cols(adj: SparseMatrix, row_scale=None, col_scale=None) -> SparseMatrix:
    """diag(row_scale) @ A @ diag(col_scale) without materializing diagonals."""
    value = adj.value
    n_rows, n_cols = adj.shape
    if row_scale is not None:
        value = value * row_scale[adj.row.clamp(0, n_rows - 1)]
    if col_scale is not None:
        value = value * col_scale[adj.col.clamp(0, n_cols - 1)]
    return adj.with_value(value)


def gcn_norm_adj(sparse_adj: SparseMatrix, norm: str = "both", add_self_loop: bool = True,
                 sym: bool = True, renorm: bool = True, improved: bool = False,
                 cache: Optional[dict] = None) -> SparseMatrix:
    """GCN adjacency normalization.

    norm="both": D^-1/2 (A [+I]) D^-1/2, the self-loop added before the norm
    when ``renorm``, after it otherwise. norm="left"/"right": D^-1 scaling of
    the axis=-1 degree in both modes, as the reference computes it.
    ``improved`` uses self-loop weight 2.0. Isolated nodes normalize to 0.
    """
    cache_key = compute_cache_key(norm, add_self_loop, sym, renorm, improved)
    if cache is not None:
        cached = cache.get(cache_key, None)
        if cached is not None:
            return SparseMatrix(cached[0], cached[1], cached[2])

    fill_weight = 2.0 if improved else 1.0

    if sparse_adj.shape[0] != sparse_adj.shape[1]:
        if add_self_loop:
            raise ValueError("add_self_loop=True requires a square adjacency")
        if sym:
            raise ValueError("sym=True requires a square adjacency")

    if add_self_loop and norm != "both":
        sparse_adj = sparse_adj.add_diag(fill_weight)

    if norm == "both":
        if add_self_loop and renorm:
            sparse_adj = sparse_adj.add_diag(fill_weight)
        row_scale = _inv_pow_no_nan(sparse_adj.segment_sum(axis=-1), -0.5)
        if sym:
            col_scale = row_scale
        else:
            col_scale = _inv_pow_no_nan(sparse_adj.segment_sum(axis=0), -0.5)
        normed = _scale_rows_cols(sparse_adj, row_scale, col_scale)
        if add_self_loop and not renorm:
            normed = normed.add_diag(fill_weight)
    elif norm == "left":
        row_deg = sparse_adj.segment_sum(axis=-1)
        normed = _scale_rows_cols(sparse_adj, _inv_pow_no_nan(row_deg, -1.0), None)
    elif norm == "right":
        # the reference computes the axis=-1 degree here too (gcn.py:113)
        col_deg = sparse_adj.segment_sum(axis=-1)
        normed = _scale_rows_cols(sparse_adj, None, _inv_pow_no_nan(col_deg, -1.0))
    else:
        raise ValueError(f"wrong GCN norm type: {norm}")

    if cache is not None:
        cache[cache_key] = (normed.index.detach(), normed.value.detach(), normed.shape)
    return normed


def gcn_build_cache_by_adj(sparse_adj: SparseMatrix, norm="both", add_self_loop=True,
                           sym=True, renorm=True, improved=False, override=False,
                           cache: Optional[dict] = None) -> dict:
    """Populate ``cache`` with the normed adjacency."""
    if cache is None:
        cache = {}
    elif override:
        key = compute_cache_key(norm, add_self_loop, sym, renorm, improved)
        cache[key] = None
        # derived entries are builds OF the base normalization: a rebuild
        # must drop them too or they keep serving the old adjacency
        cache.pop(key + ":ell", None)
        cache.pop(key + ":propagated", None)
    gcn_norm_adj(sparse_adj, norm, add_self_loop, sym, renorm, improved, cache)
    return cache


def gcn_build_cache_for_graph(graph, norm="both", add_self_loop=True, sym=True,
                              renorm=True, improved=False, override=False,
                              device="cuda") -> dict:
    """Build the normed-adj cache on a Graph (its adjacency on ``device``)."""
    graph.cache = gcn_build_cache_by_adj(
        graph.adj(device=device), norm=norm, add_self_loop=add_self_loop, sym=sym,
        renorm=renorm, improved=improved, override=override, cache=graph.cache)
    return graph.cache


def gcn_norm_edge(edge_index, num_nodes, edge_weight=None, renorm=True,
                  improved=False, cache: Optional[dict] = None, device="cuda"):
    """Deprecated edge-tuple API: returns the normed (index, value)."""
    sparse_adj = SparseMatrix(edge_index, edge_weight, (num_nodes, num_nodes),
                              device=device)
    normed = gcn_norm_adj(sparse_adj, renorm=renorm, improved=improved, cache=cache)
    return normed.index, normed.value


def gcn_cache_normed_edge(graph, renorm=True, improved=False, override=False,
                          device="cuda"):
    """Deprecated: builds the "both"-norm cache entry on a Graph."""
    if override:
        graph.cache[compute_cache_key("both", True, True, renorm, improved)] = None
    gcn_norm_edge(graph.edge_index, graph.num_nodes, graph.edge_weight,
                  renorm, improved, graph.cache, device=device)


def compile_and_dropout(normed_adj, cache, cache_key: str, edge_drop_rate: float,
                        training: bool, generator=None, keep_mask=None):
    """Shared CSR-compile + edge-dropout step.

    Training with dropout re-skins the dropped per-edge values onto the
    cached CSR layout (both directions stay consistent); without a cache it
    drops the COO values. The keep decisions come from ``keep_mask`` if
    given, else are drawn with ``generator``. Inference just compiles."""
    dropping = training and edge_drop_rate > 0.0
    if dropping and generator is None and keep_mask is None:
        raise ValueError(
            "edge dropout requires a generator or keep_mask when training with "
            "edge_drop_rate > 0; a silent no-op would train unregularized")
    if dropping:
        csr = maybe_compile_ell(normed_adj, cache, cache_key)
        if isinstance(csr, CsrAdj):
            if keep_mask is None:
                keep_mask = torch.rand(normed_adj.value.shape, generator=generator,
                                       device=normed_adj.device) < (1.0 - edge_drop_rate)
            keep_mask = torch.as_tensor(keep_mask, dtype=torch.bool,
                                        device=normed_adj.device)
            dropped = torch.where(keep_mask, normed_adj.value / (1.0 - edge_drop_rate),
                                  torch.zeros_like(normed_adj.value))
            return csr.with_edge_values(dropped)
        return normed_adj.dropout(edge_drop_rate, generator=generator,
                                  training=training, keep_mask=keep_mask)
    return maybe_compile_ell(normed_adj, cache, cache_key)


def precompute_propagated_features(x, sparse_adj: SparseMatrix, norm="both",
                                   add_self_loop=True, sym=True, renorm=True,
                                   improved=False, cache: Optional[dict] = None):
    """Precompute ``P = Â·x`` for layers whose SpMM operand is constant.

    In transductive full-batch training the first GCN layer computes
    ``Â·(x W) = (Â·x)·W``, so the SpMM can run once at preprocessing instead
    of every step. Returns P and stores it in ``cache`` under the
    normalization key + ":propagated".
    """
    base_key = compute_cache_key(norm, add_self_loop, sym, renorm, improved)
    cache_key = base_key + ":propagated"
    if cache is not None:
        cached = cache.get(cache_key, None)
        if cached is not None:
            return cached
    normed = gcn_norm_adj(sparse_adj, norm=norm, add_self_loop=add_self_loop,
                          sym=sym, renorm=renorm, improved=improved, cache=cache)
    normed = maybe_compile_ell(normed, cache, base_key)
    with torch.no_grad():
        propagated = normed.matmul(x if not isinstance(x, SparseMatrix) else x.to_dense())
    if cache is not None:
        cache[cache_key] = propagated
    return propagated


def maybe_compile_ell(normed_adj, cache: Optional[dict], cache_key: str):
    """Attach/fetch the CSR twin (``CsrAdj``) of a cached normalized adjacency.

    The name and the ``:ell`` cache key are the JAX package's; the layout
    is the port's. Built on the host once per (graph, config) on the
    matrix's device and stored in the cache dict; returns the COO matrix
    unchanged when no cache is given. A square matrix keeps its diagonal
    apart (``split_diag``): the ~N self-loops become an elementwise
    multiply-add instead of gathers.
    """
    if cache is None:
        return normed_adj
    ell_key = cache_key + ":ell"
    csr = cache.get(ell_key, None)
    if csr is not None:
        return csr
    square = normed_adj.shape[0] == normed_adj.shape[1]
    csr = CsrAdj.from_coo(normed_adj.index, normed_adj.value, normed_adj.shape,
                          split_diag=square, device=normed_adj.device)
    cache[ell_key] = csr
    return csr


def gcn(x, sparse_adj: SparseMatrix, kernel, bias=None, activation=None,
        norm: str = "both", add_self_loop: bool = True, sym: bool = True,
        renorm: bool = True, improved: bool = False, edge_drop_rate: float = 0.0,
        num_or_size_splits=None, training: bool = False, cache: Optional[dict] = None,
        generator=None, keep_mask=None):
    """Functional GCN forward: Â = norm(A [+ I]); h = Â (x W) + b.

    ``x`` may be dense or a SparseMatrix; ``num_or_size_splits`` chunks the
    feature dim of the SpMM; ``edge_drop_rate`` applies dropout on Â's values
    when training, with keep decisions from ``keep_mask`` or ``generator``.
    """
    normed_adj = gcn_norm_adj(sparse_adj, norm=norm, add_self_loop=add_self_loop,
                              sym=sym, renorm=renorm, improved=improved, cache=cache)

    if kernel is None:
        h = x
    elif isinstance(x, SparseMatrix):
        h = x.matmul(kernel)
    else:
        h = x @ kernel

    if isinstance(h, SparseMatrix):
        # sparse propagation operand: the CSR twin takes dense operands only
        if training and edge_drop_rate > 0.0 and (generator is not None
                                                  or keep_mask is not None):
            normed_adj = normed_adj.dropout(edge_drop_rate, generator=generator,
                                            training=training, keep_mask=keep_mask)
    else:
        normed_adj = compile_and_dropout(
            normed_adj, cache,
            compute_cache_key(norm, add_self_loop, sym, renorm, improved),
            edge_drop_rate, training, generator=generator, keep_mask=keep_mask)

    h = normed_adj.matmul(h, num_or_size_splits=num_or_size_splits)

    if bias is not None:
        h = h + bias
    if activation is not None:
        h = activation(h)
    return h
