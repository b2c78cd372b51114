"""GraphSAGE: six aggregators and the fixed-k variants (JAX counterpart:
``tf_geometric_tpu/nn/conv/graph_sage.py``).

Every variant aggregates neighbour features (mean, sum, normalized sum,
edge MLP then mean or max pool, LSTM), projects them with
``neighbor_kernel``, projects the node's own features with
``self_kernel``, combines the two by concatenation or sum, then adds the
bias, applies the activation and optionally L2-normalizes. Edge weights
default to ones only when absent (the JAX package's choice; the executed
reference overwrites them with ones in the gcn and pool variants).

The fixed-k variants aggregate a slot-major ``[k, S]`` draw
(``nn/sampling/device_sampler.py``) through ``ops.fixed_k`` (a hand-written
kernel on CUDA tensors); the others run on the segment ops.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ...ops.fixed_k import fixed_k_aggregate
from ..kernel.map_reduce import gcn_mapper
from ..kernel.segment import segment_max, segment_mean, segment_sum
from .gcn import gcn_norm_edge

__all__ = [
    "mean_graph_sage", "sum_graph_sage", "gcn_graph_sage",
    "mean_pool_graph_sage", "max_pool_graph_sage", "lstm_graph_sage",
    "mean_graph_sage_fixed_k", "sum_graph_sage_fixed_k",
]


def _l2_normalize(h, eps: float = 1e-12):
    return h / torch.sqrt(torch.clamp_min((h * h).sum(dim=-1, keepdim=True), eps))


def _finish(from_x, from_neighbor, bias, activation, concat, normalize):
    h = torch.cat([from_x, from_neighbor], dim=1) if concat else from_x + from_neighbor
    if bias is not None:
        h = h + bias
    if activation is not None:
        h = activation(h)
    if normalize:
        h = _l2_normalize(h)
    return h


def _edges(x, edge_index, edge_weight):
    edge_index = torch.as_tensor(edge_index, device=x.device).long()
    if edge_weight is not None:
        edge_weight = torch.as_tensor(edge_weight, device=x.device)
    return edge_index, edge_weight


def _gather_messages(x, edge_index, edge_weight):
    edge_index, edge_weight = _edges(x, edge_index, edge_weight)
    row, col = edge_index[0], edge_index[1]
    neighbor_x = x[col.clamp(0, x.shape[0] - 1)]
    if edge_weight is not None:
        neighbor_x = gcn_mapper(None, neighbor_x, edge_weight=edge_weight)
    return row, neighbor_x


def mean_graph_sage(x, edge_index, edge_weight, self_kernel, neighbor_kernel,
                    bias=None, activation=None, concat=True, normalize=False):
    """Mean aggregator over the edge list."""
    row, neighbor_x = _gather_messages(x, edge_index, edge_weight)
    reduced = segment_mean(neighbor_x, row, x.shape[0])
    return _finish(x @ self_kernel, reduced @ neighbor_kernel, bias, activation, concat,
                   normalize)


def sum_graph_sage(x, edge_index, edge_weight, self_kernel, neighbor_kernel,
                   bias=None, activation=None, concat=True, normalize=False):
    """Sum aggregator over the edge list."""
    row, neighbor_x = _gather_messages(x, edge_index, edge_weight)
    reduced = segment_sum(neighbor_x, row, x.shape[0])
    return _finish(x @ self_kernel, reduced @ neighbor_kernel, bias, activation, concat,
                   normalize)


def _fixed_k_reduce(x, neighbor_idx, neighbor_weight, neighbor_kernel, compute_dtype):
    """Weighted sum of the k sampled neighbours, projected by
    ``neighbor_kernel``; matmul-first when the kernel narrows the features
    (the sum is linear, so the k gathers then move F_out-wide rows), else
    gather-first at F_in. The gather runs in ``compute_dtype`` when given
    and the sum is cast back to ``x``'s dtype. Returns (sum, k)."""
    matmul_first = neighbor_kernel.shape[1] < x.shape[1]
    src = x @ neighbor_kernel if matmul_first else x
    if compute_dtype is not None:
        src = src.to(compute_dtype)
    acc = fixed_k_aggregate(src, neighbor_idx, neighbor_weight).to(x.dtype)
    return (acc if matmul_first else acc @ neighbor_kernel), neighbor_idx.shape[0]


def mean_graph_sage_fixed_k(x, neighbor_idx, neighbor_weight, self_kernel, neighbor_kernel,
                            bias=None, activation=None, concat=True, normalize=False,
                            compute_dtype=None):
    """``mean_graph_sage`` over a dense slot-major [k, S] draw (with
    replacement: the mean divides by k, so weight-0 pad slots count as
    zeros, as ``segment_mean`` over the flattened fixed-k edge list does)."""
    summed, k = _fixed_k_reduce(x, neighbor_idx, neighbor_weight, neighbor_kernel,
                                compute_dtype)
    return _finish(x @ self_kernel, summed / k, bias, activation, concat, normalize)


def sum_graph_sage_fixed_k(x, neighbor_idx, neighbor_weight, self_kernel, neighbor_kernel,
                           bias=None, activation=None, concat=True, normalize=False,
                           compute_dtype=None):
    """``sum_graph_sage`` over a dense slot-major [k, S] draw."""
    summed, _ = _fixed_k_reduce(x, neighbor_idx, neighbor_weight, neighbor_kernel,
                                compute_dtype)
    return _finish(x @ self_kernel, summed, bias, activation, concat, normalize)


def gcn_graph_sage(x, edge_index, edge_weight, kernel, bias=None, activation=None,
                   normalize=False, cache=None):
    """GCN-style aggregator: symmetric-normalized neighbour sum, one kernel,
    no self path. ``renorm=False`` as the executed reference runs it (it
    passes ``cache`` into ``gcn_norm_edge``'s ``renorm`` slot, and every
    live call hands it a falsy value): normalize first, then add the
    self-loop."""
    num_nodes = x.shape[0]
    edge_index, edge_weight = _edges(x, edge_index, edge_weight)
    normed_index, normed_weight = gcn_norm_edge(edge_index, num_nodes, edge_weight,
                                                renorm=False, cache=cache, device=x.device)
    normed_index = normed_index.long()
    neighbor_x = x[normed_index[1].clamp(0, num_nodes - 1)]
    neighbor_x = gcn_mapper(None, neighbor_x, edge_weight=normed_weight)
    h = segment_sum(neighbor_x, normed_index[0], num_nodes) @ kernel
    if bias is not None:
        h = h + bias
    if activation is not None:
        h = activation(h)
    if normalize:
        h = _l2_normalize(h)
    return h


def _pool_messages(x, edge_index, edge_weight, neighbor_mlp_kernel, neighbor_mlp_bias,
                   activation):
    row, neighbor_x = _gather_messages(x, edge_index, edge_weight)
    h = neighbor_x @ neighbor_mlp_kernel
    if neighbor_mlp_bias is not None:
        h = h + neighbor_mlp_bias
    if activation is not None:
        h = activation(h)
    return row, h


def mean_pool_graph_sage(x, edge_index, edge_weight, self_kernel, neighbor_mlp_kernel,
                         neighbor_kernel, neighbor_mlp_bias=None, bias=None, activation=None,
                         concat=True, normalize=False):
    """Per-edge MLP then mean (the activation applies to the edge MLP and to
    the output, as in the reference)."""
    row, h = _pool_messages(x, edge_index, edge_weight, neighbor_mlp_kernel,
                            neighbor_mlp_bias, activation)
    reduced = segment_mean(h, row, x.shape[0])
    return _finish(x @ self_kernel, reduced @ neighbor_kernel, bias, activation, concat,
                   normalize)


def max_pool_graph_sage(x, edge_index, edge_weight, self_kernel, neighbor_mlp_kernel,
                        neighbor_kernel, neighbor_mlp_bias=None, bias=None, activation=None,
                        concat=True, normalize=False):
    """Per-edge MLP then max (empty neighbourhoods give 0)."""
    row, h = _pool_messages(x, edge_index, edge_weight, neighbor_mlp_kernel,
                            neighbor_mlp_bias, activation)
    reduced = segment_max(h, row, x.shape[0])
    return _finish(x @ self_kernel, reduced @ neighbor_kernel, bias, activation, concat,
                   normalize)


def lstm_graph_sage(x, edge_index, lstm: Callable, self_kernel, neighbor_kernel, bias=None,
                    activation=None, concat=True, normalize=False, training=False,
                    max_neighbors: Optional[int] = None):
    """LSTM aggregator: each node's neighbours (in edge order) packed into a
    dense [N, K, F] tensor (missing slots and slots past K read a zero row),
    ``lstm`` run over the neighbour axis (``[N, K, F] -> [N, K, H]``, the
    full sequence), then the mean over it. ``max_neighbors`` (K) defaults to
    the largest in-degree. ``training`` holds the JAX function's positional
    slot and is unused: a torch module reads its own ``training`` flag."""
    num_nodes = x.shape[0]
    edge_index = torch.as_tensor(edge_index, device=x.device).long()
    row, col = edge_index[0], edge_index[1]
    order = torch.argsort(row, stable=True)
    row_s, col_s = row[order], col[order]
    degree = segment_sum(torch.ones_like(row_s), row_s, num_nodes)
    if max_neighbors is None:
        max_neighbors = int(degree.max()) if degree.numel() else 0
    before = torch.cumsum(degree, 0) - degree
    slot = torch.arange(row_s.shape[0], device=x.device) - before[row_s.clamp(0, num_nodes - 1)]
    in_range = (slot < max_neighbors) & (row_s >= 0) & (row_s < num_nodes)
    neighbor_matrix = torch.full((num_nodes, max_neighbors), num_nodes, dtype=torch.long,
                                 device=x.device)
    neighbor_matrix[row_s[in_range], slot[in_range]] = col_s[in_range]
    padded_x = torch.cat([x, x.new_zeros((1, x.shape[-1]))], dim=0)
    neighbor_h = lstm(padded_x[neighbor_matrix])
    reduced = neighbor_h.mean(dim=1)
    return _finish(x @ self_kernel, reduced @ neighbor_kernel, bias, activation, concat,
                   normalize)
