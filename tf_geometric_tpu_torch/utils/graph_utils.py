"""Edge transforms that GCN and GAT need (JAX counterpart:
``tf_geometric_tpu/utils/graph_utils.py``).

Host-side transforms (dedup, canonicalization, self-loop removal) return
numpy arrays, as the JAX module does; ``add_self_loop_edge`` keeps its
input's kind: a tensor in gives tensors on the same device, anything else
gives numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _segment_core as _seg
from .union_utils import convert_union_to_numpy

__all__ = [
    "convert_edge_index_to_edge_hash",
    "convert_edge_hash_to_edge_index",
    "merge_duplicated_edge",
    "convert_edge_to_upper",
    "convert_edge_to_directed",
    "remove_self_loop_edge",
    "mask_self_loop_edge",
    "add_self_loop_edge",
    "get_laplacian",
    "adj_norm_edge",
    "LaplacianMaxEigenvalue",
]


def convert_edge_index_to_edge_hash(edge_index, num_nodes=None):
    """``row * N + col`` as an int64 per edge, and N."""
    edge_index = convert_union_to_numpy(edge_index, np.int64)
    if num_nodes is None:
        num_nodes = int(edge_index.max()) + 1 if edge_index.size else 0
    return edge_index[0] * num_nodes + edge_index[1], num_nodes


def convert_edge_hash_to_edge_index(edge_hash, num_nodes):
    """Inverse of the hash, as int32 [2, E]."""
    edge_hash = np.asarray(edge_hash, np.int64)
    return np.stack([edge_hash // num_nodes, edge_hash % num_nodes], axis=0).astype(np.int32)


_MERGE_FNS = {
    "min": np.minimum.reduceat,
    "max": np.maximum.reduceat,
    "sum": np.add.reduceat,
}


def _merge_prop(prop, order, starts, mode):
    """Merge a per-edge property across the groups of duplicate edges."""
    sorted_prop = prop[order]
    if mode == "first":
        return sorted_prop[starts]
    if mode == "mean":
        sums = np.add.reduceat(sorted_prop, starts, axis=0)
        counts = np.diff(np.append(starts, len(order))).astype(sorted_prop.dtype)
        return sums / counts.reshape((-1,) + (1,) * (sorted_prop.ndim - 1))
    if mode in _MERGE_FNS:
        return _MERGE_FNS[mode](sorted_prop, starts, axis=0)
    raise ValueError(f"unknown merge mode: {mode}")


def merge_duplicated_edge(edge_index, edge_props=None, merge_modes=None):
    """Collapse duplicate (row, col) pairs, merging each property by its mode
    (min, max, mean, sum or first; one string applies to every property).
    Edges come out sorted by their hash."""
    edge_index = convert_union_to_numpy(edge_index, np.int32)
    if isinstance(merge_modes, str) and edge_props is not None:
        merge_modes = [merge_modes] * len(edge_props)
    edge_hash, num_nodes = convert_edge_index_to_edge_hash(edge_index)
    order = np.argsort(edge_hash, kind="stable")
    sorted_hash = edge_hash[order]
    is_start = np.ones(len(order), bool)
    is_start[1:] = sorted_hash[1:] != sorted_hash[:-1]
    starts = np.nonzero(is_start)[0]
    new_edge_index = convert_edge_hash_to_edge_index(sorted_hash[starts], num_nodes)
    if edge_props is None:
        return new_edge_index, None
    if merge_modes is None:
        merge_modes = ["first"] * len(edge_props)
    new_props = [
        None if p is None else _merge_prop(convert_union_to_numpy(p), order, starts, m)
        for p, m in zip(edge_props, merge_modes)
    ]
    return new_edge_index, new_props


def convert_edge_to_upper(edge_index, edge_props=None, merge_modes=None):
    """Canonicalize every edge to (min, max) and dedupe."""
    edge_index = convert_union_to_numpy(edge_index, np.int32)
    upper = np.stack([edge_index.min(axis=0), edge_index.max(axis=0)], axis=0)
    return merge_duplicated_edge(upper, edge_props, merge_modes)


def convert_edge_to_directed(edge_index, edge_props=None, merge_modes=None):
    """Undirected to directed: canonicalize, dedupe, then append the mirror
    of every edge that is not a self-loop."""
    upper_index, upper_props = convert_edge_to_upper(edge_index, edge_props, merge_modes)
    not_loop = upper_index[0] != upper_index[1]
    new_index = np.concatenate([upper_index, upper_index[::-1, not_loop]], axis=1)
    if upper_props is None:
        return new_index, None
    new_props = [None if p is None else np.concatenate([p, p[not_loop]], axis=0)
                 for p in upper_props]
    return new_index, new_props


def remove_self_loop_edge(edge_index, edge_weight=None):
    """Drop the edges with row == col (numpy out)."""
    edge_index = convert_union_to_numpy(edge_index, np.int32)
    keep = edge_index[0] != edge_index[1]
    edge_index = edge_index[:, keep]
    if edge_weight is not None:
        edge_weight = convert_union_to_numpy(edge_weight)[keep]
    return edge_index, edge_weight


def mask_self_loop_edge(edge_index, num_nodes: int, edge_weight=None):
    """Self-loops become padded edges (row and col ``num_nodes``, weight 0),
    so the edge count stays the same; tensors in, tensors out."""
    edge_index = torch.as_tensor(edge_index)
    is_loop = edge_index[0] == edge_index[1]
    masked_index = torch.where(is_loop[None, :], torch.full_like(edge_index, num_nodes),
                               edge_index)
    if edge_weight is None:
        return masked_index, None
    edge_weight = torch.as_tensor(edge_weight, device=edge_index.device)
    return masked_index, torch.where(is_loop, torch.zeros_like(edge_weight), edge_weight)


def add_self_loop_edge(edge_index, num_nodes: int, edge_weight=None, fill_weight=1.0):
    """Append the diagonal ``(i, i)`` for every node with ``fill_weight``,
    also where a self-loop exists already: E edges become E + num_nodes.
    Weights are float32 (ones where ``edge_weight`` is None)."""
    if isinstance(edge_index, torch.Tensor):
        device = edge_index.device
        diag = torch.arange(num_nodes, dtype=edge_index.dtype, device=device).repeat(2, 1)
        new_index = torch.cat([edge_index, diag], dim=1)
        if edge_weight is None:
            edge_weight = torch.ones(edge_index.shape[1], dtype=torch.float32, device=device)
        else:
            edge_weight = torch.as_tensor(edge_weight, dtype=torch.float32, device=device)
        fill = torch.full((num_nodes,), float(fill_weight), dtype=torch.float32, device=device)
        return new_index, torch.cat([edge_weight, fill])
    edge_index = np.asarray(edge_index)
    diag = np.tile(np.arange(num_nodes, dtype=edge_index.dtype)[None, :], (2, 1))
    new_index = np.concatenate([edge_index, diag], axis=1)
    if edge_weight is None:
        edge_weight = np.ones(edge_index.shape[1], np.float32)
    else:
        edge_weight = convert_union_to_numpy(edge_weight, np.float32)
    fill = np.full(num_nodes, fill_weight, np.float32)
    return new_index, np.concatenate([edge_weight, fill])


def _edge_tensors(edge_index, edge_weight):
    """(int64 index, float32 weight; ones for None) as tensors, on the
    index's device when it is a tensor, else on the CPU."""
    if not isinstance(edge_index, torch.Tensor):
        edge_index = torch.as_tensor(convert_union_to_numpy(edge_index, np.int64))
    edge_index = edge_index.long()
    if edge_weight is None:
        return edge_index, torch.ones(edge_index.shape[1], dtype=torch.float32,
                                      device=edge_index.device)
    if not isinstance(edge_weight, torch.Tensor):
        edge_weight = torch.as_tensor(convert_union_to_numpy(edge_weight, np.float32))
    return edge_index, edge_weight.to(device=edge_index.device, dtype=torch.float32)


def get_laplacian(edge_index, num_nodes: int, edge_weight=None, normalization_type=None,
                  fill_weight=1.0):
    """The graph "Laplacian" as an edge list, as the JAX function and the
    reference compute it (the adjacency term is NOT negated):

    - "sym": D^-1/2 A D^-1/2 entries plus ``fill_weight`` self-loops;
    - "rw": D^-1 A entries plus ``fill_weight`` self-loops;
    - None: self-loops appended, then each entry (r, c, w) becomes
      deg[r] - w, deg from the original edges; padded rows stay 0.

    Returns (index [2, E + N] int64, weight [E + N] float32) as tensors on
    ``edge_index``'s device (the CPU for numpy input)."""
    edge_index, edge_weight = _edge_tensors(edge_index, edge_weight)
    dev = edge_index.device
    row = edge_index[0]
    deg = _seg.segment_sum(edge_weight, row, num_nodes)
    diag = torch.arange(num_nodes, dtype=edge_index.dtype, device=dev).repeat(2, 1)
    new_index = torch.cat([edge_index, diag], dim=1)
    fill = torch.full((num_nodes,), float(fill_weight), dtype=torch.float32, device=dev)
    if normalization_type is None:
        all_weight = torch.cat([edge_weight, fill])
        safe_row = new_index[0].clamp(0, num_nodes - 1)
        in_range = new_index[0] < num_nodes
        return new_index, torch.where(in_range, deg[safe_row] - all_weight,
                                      torch.zeros_like(all_weight))
    safe_row = edge_index[0].clamp(0, num_nodes - 1)
    safe_col = edge_index[1].clamp(0, num_nodes - 1)
    if normalization_type == "sym":
        dinv = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)), torch.zeros_like(deg))
        normed = dinv[safe_row] * edge_weight * dinv[safe_col]
    elif normalization_type == "rw":
        dinv = torch.where(deg > 0, 1.0 / deg.clamp_min(1e-12), torch.zeros_like(deg))
        normed = dinv[safe_row] * edge_weight
    else:
        raise ValueError(f"unknown normalization_type: {normalization_type}")
    return new_index, torch.cat([normed, fill])


def adj_norm_edge(edge_index, num_nodes: int, edge_weight=None, add_self_loop: bool = False,
                  cache=None):
    """Symmetric degree normalization D^-1/2 A D^-1/2 (used by MinCutPool),
    with the JAX function's cache key ``adj_normed_edge_{add_self_loop}``.
    Returns tensors (index int64, weight float32)."""
    key = f"adj_normed_edge_{add_self_loop}"
    if cache is not None:
        cached = cache.get(key, None)
        if cached is not None:
            return cached
    edge_index, edge_weight = _edge_tensors(edge_index, edge_weight)
    if add_self_loop:
        edge_index, edge_weight = add_self_loop_edge(edge_index, num_nodes, edge_weight)
    row, col = edge_index[0], edge_index[1]
    deg = _seg.segment_sum(edge_weight, row, num_nodes)
    dinv = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)), torch.zeros_like(deg))
    normed = dinv[row.clamp(0, num_nodes - 1)] * edge_weight * dinv[col.clamp(0, num_nodes - 1)]
    result = (edge_index, normed)
    if cache is not None:
        cache[key] = result
    return result


class LaplacianMaxEigenvalue:
    """λ_max of the (normalized) Laplacian by scipy's ``eigsh`` on the host,
    with the JAX class's solver arguments (k=1, which="LM"). Self-loops are
    removed first, as the JAX class does."""

    def __init__(self, edge_index, num_nodes=None, edge_weight=None):
        self.edge_index = convert_union_to_numpy(edge_index, np.int32)
        self.edge_weight = (None if edge_weight is None
                            else convert_union_to_numpy(edge_weight, np.float32))
        self.num_nodes = (int(self.edge_index.max()) + 1
                          if num_nodes is None else int(num_nodes))

    def __call__(self, normalization_type="sym"):
        import scipy.sparse as sp
        from scipy.sparse.linalg import eigsh
        edge_index, edge_weight = remove_self_loop_edge(self.edge_index, self.edge_weight)
        lap_index, lap_weight = get_laplacian(edge_index, self.num_nodes, edge_weight,
                                              normalization_type)
        lap_index, lap_weight = lap_index.cpu().numpy(), lap_weight.cpu().numpy()
        lap = sp.csr_matrix((lap_weight.astype(np.float32),
                             (lap_index[0].astype(np.int32), lap_index[1].astype(np.int32))),
                            shape=(self.num_nodes, self.num_nodes))
        vals = eigsh(lap, k=1, which="LM", return_eigenvectors=False)
        return float(vals[0])
