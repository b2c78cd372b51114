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

from .union_utils import convert_union_to_numpy

__all__ = [
    "convert_edge_index_to_edge_hash",
    "convert_edge_hash_to_edge_index",
    "merge_duplicated_edge",
    "convert_edge_to_upper",
    "convert_edge_to_directed",
    "remove_self_loop_edge",
    "add_self_loop_edge",
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
