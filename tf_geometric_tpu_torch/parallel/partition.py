"""Graph partitioning for the graph-parallel runtime (JAX counterpart:
``tf_geometric_tpu/parallel/partition.py``), host-side numpy.

Nodes are sharded into contiguous row blocks, one per rank, and each edge
goes to the rank owning its **destination** row, so the reduction side of
every SpMM is local and only source rows cross ranks (the halo exchange,
``parallel/halo.py``). ``partition_order`` is the METIS-role partitioner
(label-propagation communities, block-aligned bin-packing, capacity-bounded
refinement); ``community_order`` and ``bandwidth_reduction_order`` are the
cheaper orderings. Outputs are padded to identical per-rank sizes.

Label propagation and the refinement sweeps run in C++ when the port's
native library is built (``native.lpa_labels``, ``native.partition_refine``)
and in numpy otherwise, as the JAX module does; the two branches give
different permutations, and each equals the JAX module's same branch.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .. import native
from ..utils.union_utils import convert_union_to_numpy

__all__ = ["nodes_per_part", "EdgePartition", "partition_edges_by_row",
           "bandwidth_reduction_order", "community_order", "partition_order",
           "apply_node_permutation"]


def nodes_per_part(num_nodes: int, num_parts: int) -> int:
    """The uniform per-rank node-block size, rounded up to a multiple of 8."""
    npp = -(-num_nodes // num_parts)
    return -(-npp // 8) * 8


class EdgePartition(NamedTuple):
    """Per-rank edge shards, shaped [num_parts, edges_per_part].

    ``local_row`` is the destination row within the owning rank's node
    block; ``global_col`` indexes the unpartitioned node space. Padded
    entries have ``local_row = nodes_per_part`` (out of range, dropped) and
    value 0."""

    local_row: np.ndarray    # [P, E_pad] int32
    global_col: np.ndarray   # [P, E_pad] int32
    value: np.ndarray        # [P, E_pad] float32
    nodes_per_part: int
    num_parts: int
    num_nodes_padded: int    # num_parts * nodes_per_part


def partition_edges_by_row(edge_index, edge_weight, num_nodes: int,
                           num_parts: int, pad_multiple: int = 128) -> EdgePartition:
    """Assign each edge to the rank owning its destination row block; each
    shard keeps its edges in input order."""
    edge_index = convert_union_to_numpy(edge_index, np.int64)
    if edge_weight is None:
        edge_weight = np.ones(edge_index.shape[1], np.float32)
    edge_weight = convert_union_to_numpy(edge_weight, np.float32)

    npp = nodes_per_part(num_nodes, num_parts)
    owner = np.minimum(edge_index[0] // npp, num_parts - 1)
    counts = np.bincount(owner, minlength=num_parts)
    e_pad = int(-(-counts.max() // pad_multiple) * pad_multiple) if counts.size else pad_multiple

    local_row = np.full((num_parts, e_pad), npp, np.int32)
    global_col = np.zeros((num_parts, e_pad), np.int32)
    value = np.zeros((num_parts, e_pad), np.float32)
    for p in range(num_parts):
        sel = owner == p
        k = int(sel.sum())
        local_row[p, :k] = (edge_index[0][sel] - p * npp).astype(np.int32)
        global_col[p, :k] = edge_index[1][sel].astype(np.int32)
        value[p, :k] = edge_weight[sel]
    return EdgePartition(local_row, global_col, value, npp, num_parts, num_parts * npp)


def bandwidth_reduction_order(edge_index, num_nodes: int) -> np.ndarray:
    """Reverse Cuthill-McKee node permutation, ``perm[old_id] = new_id``."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    edge_index = convert_union_to_numpy(edge_index, np.int64)
    data = np.ones(edge_index.shape[1], np.int8)
    adj = sp.csr_matrix((data, (edge_index[0], edge_index[1])), shape=(num_nodes, num_nodes))
    order = reverse_cuthill_mckee(adj + adj.T, symmetric_mode=True)  # new_id -> old_id
    perm = np.empty(num_nodes, np.int64)
    perm[order] = np.arange(num_nodes)
    return perm


def community_order(edge_index, num_nodes: int, num_iters: int = 8,
                    seed: int = 0) -> np.ndarray:
    """Label-propagation communities laid out contiguously, largest first
    (``perm[old] = new``)."""
    return _labels_to_order(_community_labels(edge_index, num_nodes, num_iters, seed),
                            num_nodes)


def _community_labels(edge_index, num_nodes: int, num_iters: int = 8,
                      seed: int = 0) -> np.ndarray:
    """Majority-vote label propagation: natively (ties to the smallest
    label) when the library is built, else in numpy with ties broken by a
    seeded jitter."""
    edge_index = convert_union_to_numpy(edge_index, np.int64)
    row, col = edge_index[0], edge_index[1]
    if native.available():
        order = native.sort_by_row(row, num_nodes)
        labels = native.lpa_labels(native.build_row_ptr(row, num_nodes),
                                   col[order].astype(np.int32), num_nodes, num_iters)
        if labels is not None:
            return labels
    labels = np.arange(num_nodes, dtype=np.int64)
    rng = np.random.default_rng(seed)
    for _ in range(num_iters):
        pair = row * num_nodes + labels[col]
        uniq, counts = np.unique(pair, return_counts=True)
        u_row, u_lab = uniq // num_nodes, uniq % num_nodes
        jitter = rng.random(len(uniq)) * 0.5
        order = np.lexsort((-(counts + jitter), u_row))
        sorted_rows = u_row[order]
        first = np.ones(len(order), bool)
        first[1:] = sorted_rows[1:] != sorted_rows[:-1]
        new_labels = labels.copy()
        new_labels[sorted_rows[first]] = u_lab[order][first]
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
    return labels


def partition_order(edge_index, num_nodes: int, num_parts: int,
                    num_iters: int = 8, refine_iters: int = 8,
                    seed: int = 0) -> np.ndarray:
    """Balanced, block-aligned partition as a node permutation
    (``perm[old_id] = new_id``): label-propagation communities,
    first-fit-decreasing packing into ``num_parts`` bins of exactly the
    blocks ``partition_edges_by_row`` uses, refinement sweeps that move a
    node to the part holding most of its neighbours while that part has
    slack, then a repair back to the exact block sizes. The sweeps and the
    repair run in C++ over the symmetric CSR when the native library is
    built; the numpy branch walks the movers in a Python loop
    (O(E · refine_iters) host time)."""
    edge_index = convert_union_to_numpy(edge_index, np.int64)
    P, N = int(num_parts), int(num_nodes)
    if P <= 1 or N == 0:
        return np.arange(N, dtype=np.int64)
    npp = nodes_per_part(N, P)
    caps = np.array([max(0, min(npp, N - p * npp)) for p in range(P)], np.int64)
    labels = _community_labels(edge_index, N, num_iters, seed)

    # pack communities, largest first, into the part with most room
    comm_ids, comm_inv, comm_sizes = np.unique(labels, return_inverse=True, return_counts=True)
    node_by_comm = np.argsort(comm_inv, kind="stable")
    starts = np.zeros(len(comm_ids) + 1, np.int64)
    np.cumsum(comm_sizes, out=starts[1:])
    part = np.full(N, -1, np.int64)
    room = caps.copy()
    for c in np.argsort(-comm_sizes):
        members = node_by_comm[starts[c]:starts[c + 1]]
        off = 0
        while off < len(members):
            p = int(np.argmax(room))
            take = min(int(room[p]), len(members) - off)
            if take <= 0:
                break
            part[members[off:off + take]] = p
            room[p] -= take
            off += take

    # symmetric edge list without self-loops, for the gains
    row = np.concatenate([edge_index[0], edge_index[1]])
    col = np.concatenate([edge_index[1], edge_index[0]])
    keep = row != col
    row, col = row[keep], col[keep]
    slack = max(8, npp // 64)

    if native.available():
        row32 = row.astype(np.int32)
        order_e = native.sort_by_row(row32, N)
        part32 = np.ascontiguousarray(part, np.int32)
        moved = native.partition_refine(native.build_row_ptr(row32, N),
                                        col[order_e].astype(np.int32), part32, caps, slack,
                                        refine_iters)
        if moved is not None:
            return _part_order(part32)

    def neighbor_part_counts(assign):
        cnt = np.zeros((N, P), np.int32)
        np.add.at(cnt.reshape(-1), row * P + assign[col], 1)
        return cnt

    fill = np.bincount(part, minlength=P)
    for _ in range(refine_iters):
        cnt = neighbor_part_counts(part)
        cur = cnt[np.arange(N), part]
        best = cnt.argmax(axis=1)
        gain = cnt.max(axis=1) - cur
        movers = np.nonzero((best != part) & (gain > 0))[0]
        if len(movers) == 0:
            break
        moved = 0
        for n in movers[np.argsort(-gain[movers])]:
            b = best[n]
            if fill[b] < caps[b] + slack:
                fill[part[n]] -= 1
                fill[b] += 1
                part[n] = b
                moved += 1
        if moved == 0:
            break

    # repair: drain overfull parts into underfull ones, evicting the nodes
    # that lose the least locality
    cnt = neighbor_part_counts(part)
    for p in range(P):
        excess = int(fill[p] - caps[p])
        if excess <= 0:
            continue
        under = np.nonzero(fill < caps)[0]
        members = np.nonzero(part == p)[0]
        tgt_cnt = cnt[members][:, under]
        tgt_pick = tgt_cnt.argmax(axis=1)
        score = tgt_cnt[np.arange(len(members)), tgt_pick] - cnt[members, p]
        for i in np.argsort(-score):
            if excess == 0:
                break
            t = int(under[tgt_pick[i]])
            if fill[t] >= caps[t]:
                open_parts = np.nonzero(fill < caps)[0]
                if len(open_parts) == 0:
                    break
                t = int(open_parts[cnt[members[i]][open_parts].argmax()])
            fill[p] -= 1
            fill[t] += 1
            part[members[i]] = t
            excess -= 1

    return _part_order(part)


def _part_order(part: np.ndarray) -> np.ndarray:
    """``perm[old] = new`` laying the parts out in order, old ids ascending
    within a part."""
    n = len(part)
    order = np.lexsort((np.arange(n), part))
    perm = np.empty(n, np.int64)
    perm[order] = np.arange(n)
    return perm


def _labels_to_order(labels: np.ndarray, num_nodes: int) -> np.ndarray:
    """Communities contiguous, large communities first."""
    _, comm_inverse, comm_sizes = np.unique(labels, return_inverse=True, return_counts=True)
    comm_rank = np.argsort(np.argsort(-comm_sizes))
    order = np.lexsort((np.arange(num_nodes), comm_rank[comm_inverse]))
    perm = np.empty(num_nodes, np.int64)
    perm[order] = np.arange(num_nodes)
    return perm


def apply_node_permutation(graph, perm):
    """Relabel a ``Graph``'s nodes by ``perm[old] = new`` (host-side);
    returns the new graph and the inverse permutation."""
    from ..data.graph import Graph
    x = convert_union_to_numpy(graph.x)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    ei = convert_union_to_numpy(graph.edge_index, np.int64)
    y = convert_union_to_numpy(graph.y)
    new_y = None if y is None else (y[inv] if y.shape[:1] == x.shape[:1] else y)
    return Graph(x[inv], perm[ei].astype(np.int32), new_y,
                 convert_union_to_numpy(graph.edge_weight)), inv
