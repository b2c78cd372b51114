"""Edge transforms, splits and samplers (JAX counterpart:
``tf_geometric_tpu/utils/graph_utils.py``).

Host-side transforms (dedup, canonicalization, self-loop removal, the dense
adjacency's edges, sampled-edge reindexing, negative sampling, the
link-prediction split, the neighbour samplers) return numpy arrays, as the
JAX module does; ``add_self_loop_edge`` keeps its input's kind: a tensor in
gives tensors on the same device, anything else gives numpy arrays. The
dense assignment's edges and the subgraph edge mask are tensors.

Where the JAX module draws from a numpy ``Generator`` (or sklearn from a
``RandomState``), these functions make the same calls in the same order,
so the same seed gives the same arrays bit for bit. The samplers' fixed-k
draw runs in the native library (``native.sample_fixed_k``) when it is
built, as JAX's does, and in numpy otherwise.
"""
from __future__ import annotations

import numbers
from math import ceil, floor

import numpy as np
import torch

from .. import _segment_core as _seg
from .. import native
from .union_utils import convert_union_to_numpy

# per-source Python loops (the without-replacement sampler modes) are a trap
# past this many sources; the fixed-k modes are vectorized
_SLOW_PATH_WARN_THRESHOLD = 100_000

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
    "convert_dense_adj_to_edge",
    "convert_dense_assign_to_edge",
    "compute_edge_mask_by_node_index",
    "reindex_sampled_edge_index",
    "convert_edge_to_nx_graph",
    "to_scipy_sparse_matrix",
    "negative_sampling",
    "negative_sampling_with_start_node",
    "extract_unique_edge",
    "edge_train_test_split",
    "convert_x_to_3d",
    "RandomNeighborSampler",
    "UniformNeighborSampler",
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


def convert_dense_adj_to_edge(dense_adj, threshold: float = 0.0):
    """The entries of a dense adjacency whose magnitude exceeds
    ``threshold`` as ``(edge_index [2, E] int32, edge_weight [E] float32)``,
    numpy, row-major order. Host-side."""
    dense_adj = convert_union_to_numpy(dense_adj)
    row, col = np.nonzero(np.abs(dense_adj) > threshold)
    return (np.stack([row, col], axis=0).astype(np.int32),
            dense_adj[row, col].astype(np.float32))


def convert_dense_assign_to_edge(dense_assign, node_graph_index=None, num_nodes=None,
                                 num_clusters=None):
    """A dense soft assignment [N, C] as N·C node → cluster edges (every
    pair), the cluster ids offset by ``node_graph_index · C`` when given.
    Tensors on ``dense_assign``'s device; the weights keep its gradient."""
    dense_assign = torch.as_tensor(dense_assign)
    n, c = dense_assign.shape
    device = dense_assign.device
    node_idx = torch.arange(n, device=device).repeat_interleave(c)
    cluster_idx = torch.arange(c, device=device).repeat(n)
    if node_graph_index is not None:
        offsets = torch.as_tensor(node_graph_index, device=device).long() * c
        cluster_idx = cluster_idx + offsets.repeat_interleave(c)
    return torch.stack([node_idx, cluster_idx]), dense_assign.reshape(-1)


def compute_edge_mask_by_node_index(edge_index, node_index, num_nodes=None):
    """Boolean [E] mask of the edges whose two ends both lie in
    ``node_index``, on ``edge_index``'s device (the CPU for numpy input).
    As in JAX, ends are clipped to ``[0, num_nodes)`` for the lookup and an
    out-of-range end masks its edge; a node id out of range selects nothing
    (it writes a spare entry)."""
    if not isinstance(edge_index, torch.Tensor):
        edge_index = torch.as_tensor(convert_union_to_numpy(edge_index, np.int64))
    edge_index = edge_index.long()
    device = edge_index.device
    node_index = torch.as_tensor(convert_union_to_numpy(node_index, np.int64)
                                 if not isinstance(node_index, torch.Tensor) else node_index,
                                 device=device).long()
    if num_nodes is None:
        num_nodes = max(int(edge_index.max()) if edge_index.numel() else 0,
                        int(node_index.max()) if node_index.numel() else 0) + 1
    node_mask = torch.zeros(num_nodes + 1, dtype=torch.bool, device=device)
    in_nodes = (node_index >= 0) & (node_index < num_nodes)
    node_mask[torch.where(in_nodes, node_index, num_nodes)] = True
    node_mask = node_mask[:num_nodes]
    in_range = (edge_index >= 0) & (edge_index < num_nodes)
    ends_ok = node_mask[edge_index.clamp(0, num_nodes - 1)] & in_range
    return ends_ok[0] & ends_ok[1]


def reindex_sampled_edge_index(sampled_edge_index, sampled_node_index):
    """Relabel edge ends into the sampled nodes' local ids (an end outside
    the sample reads -1), int32 numpy. Host-side."""
    sampled_edge_index = convert_union_to_numpy(sampled_edge_index, np.int64)
    sampled_node_index = convert_union_to_numpy(sampled_node_index, np.int64)
    max_id = int(max(sampled_edge_index.max(initial=0),
                     sampled_node_index.max(initial=0))) + 1
    lookup = np.full(max_id, -1, np.int64)
    lookup[sampled_node_index] = np.arange(len(sampled_node_index))
    return lookup[sampled_edge_index].astype(np.int32)


def convert_edge_to_nx_graph(edge_index, edge_properties=None, convert_to_directed=False):
    """A networkx ``Graph`` of the edges (imported here: no card path needs
    networkx); edge properties attach as ``p_{j}`` attributes, and
    ``convert_to_directed`` returns ``g.to_directed()``."""
    import networkx as nx
    edge_index = convert_union_to_numpy(edge_index, np.int32)
    props = [] if edge_properties is None else [
        None if p is None else convert_union_to_numpy(p) for p in edge_properties]
    g = nx.Graph()
    for i in range(edge_index.shape[1]):
        g.add_edge(int(edge_index[0, i]), int(edge_index[1, i]),
                   **{f"p_{j}": p[i] for j, p in enumerate(props) if p is not None})
    return g.to_directed() if convert_to_directed else g


def to_scipy_sparse_matrix(edge_index, edge_weight=None, num_nodes=None):
    """A scipy CSR matrix [N, N] of the edges (weights default to one;
    duplicates add up)."""
    import scipy.sparse as sp
    edge_index = convert_union_to_numpy(edge_index, np.int32)
    if num_nodes is None:
        num_nodes = int(edge_index.max()) + 1 if edge_index.size else 0
    edge_weight = (np.ones(edge_index.shape[1], np.float32) if edge_weight is None
                   else convert_union_to_numpy(edge_weight, np.float32))
    return sp.csr_matrix((edge_weight, (edge_index[0], edge_index[1])),
                         shape=(num_nodes, num_nodes))


class _IntegerStream:
    """The integers in ``[0, high)`` that ``rng.integers(0, high)`` would
    give one call at a time, drawn in blocks and handed out in order.

    numpy's ``Generator.integers`` gives the same values for ``size=m`` as for
    m scalar calls (the bit generator keeps any spare 32-bit half in its own
    state), so a block reads the scalar loop's stream. ``close`` rewinds the
    generator to where that loop would have left it: the state before the
    block holding the first value not handed out, advanced by the values
    of that block that were."""

    _MIN_BLOCK = 1024

    def __init__(self, rng: np.random.Generator, high: int):
        self.rng, self.high = rng, high
        self.buf = np.empty(0, np.int64)
        self.pos = 0                # next value, as an index into buf
        self.buf_start = 0          # stream offset of buf[0]
        self.blocks = []            # (bit generator state before, stream offset) per block

    def peek(self, m: int) -> np.ndarray:
        """The next m values, without handing them out."""
        short = self.pos + m - len(self.buf)
        if short > 0:
            self.blocks.append((self.rng.bit_generator.state, self.buf_start + len(self.buf)))
            block = self.rng.integers(0, self.high, size=max(short, self._MIN_BLOCK))
            self.buf_start += self.pos
            self.buf = np.concatenate([self.buf[self.pos:], block])
            self.pos = 0
        return self.buf[self.pos:self.pos + m]

    def advance(self, m: int):
        self.pos += m

    def close(self):
        used = self.buf_start + self.pos
        for state, offset in reversed(self.blocks):
            if offset <= used:
                if used < self.buf_start + len(self.buf):
                    self.rng.bit_generator.state = state
                    if used > offset:
                        self.rng.integers(0, self.high, size=used - offset)
                return


class _PairSet:
    """A set of (a, b) integer pairs, tested a vector at a time: each pair
    keyed ``(a - lo)·width + (b - lo)`` over a range that holds every id
    this set and its queries meet, so two pairs share a key only when they
    are equal."""

    def __init__(self, a, b, query_ids=()):
        ids = [np.asarray(a, np.int64), np.asarray(b, np.int64)]
        ids += [np.asarray(q, np.int64) for q in query_ids]
        lo = min((int(x.min()) for x in ids if x.size), default=0)
        hi = max((int(x.max()) for x in ids if x.size), default=0)
        self.lo, self.width = lo, hi - lo + 1
        self.keys = np.unique(self.key(ids[0], ids[1]))

    def key(self, a, b):
        return (a - self.lo) * self.width + (b - self.lo)

    def contains(self, a, b) -> np.ndarray:
        return _in_sorted(self.key(a, b), self.keys)


def _in_sorted(values: np.ndarray, sorted_keys: np.ndarray) -> np.ndarray:
    """values ∈ sorted_keys, elementwise. The values are searched in sorted
    order: random probes into a large key array cost several times more."""
    if sorted_keys.size == 0:
        return np.zeros(values.shape, bool)
    order = np.argsort(values)
    pos = np.empty(values.shape, np.int64)
    pos[order] = np.searchsorted(sorted_keys, values[order])
    return sorted_keys[np.minimum(pos, sorted_keys.size - 1)] == values


def negative_sampling(num_samples, num_nodes, edge_index=None, replace=True,
                      mode="undirected", rng=None):
    """``num_samples`` node pairs absent from the graph, [2, S] int32.

    The JAX function's rejection loop, drawn in blocks: each try draws a row
    then a column (``rng.integers(0, num_nodes)`` twice), and rejects a
    self-loop or a taken pair (``edge_index``'s pairs, and their mirrors in
    ``"undirected"`` mode), and with ``replace=False`` a pair whose key (the
    pair in ``"directed"`` mode, else its (min, max)) was accepted before;
    at most ``200·num_samples + 1000`` tries. ``rng`` is a seed or a
    ``Generator``; a passed ``Generator`` is left where the loop leaves it."""
    rng = np.random.default_rng(rng)
    n = int(num_nodes)
    taken = None
    if edge_index is not None:
        ei = convert_union_to_numpy(edge_index, np.int64)
        a, b = ei[0], ei[1]
        if mode == "undirected":
            a, b = np.concatenate([a, ei[1]]), np.concatenate([b, ei[0]])
        taken = _PairSet(a, b, ([0, n - 1],))
    max_tries = num_samples * 200 + 1000
    stream = _IntegerStream(rng, n)
    rows, cols = [], []
    seen = np.empty(0, np.int64)
    count = tries = 0
    while count < num_samples and tries < max_tries:
        block = min(max_tries - tries, 2 * (num_samples - count) + 64)
        drawn = stream.peek(2 * block)
        r, c = drawn[0::2], drawn[1::2]
        ok = r != c
        if taken is not None:
            ok &= ~taken.contains(r, c)
        if not replace:
            key = (r * n + c if mode == "directed"
                   else np.minimum(r, c) * n + np.maximum(r, c))
            ok &= ~_in_sorted(key, seen)
            cand = np.nonzero(ok)[0]
            _, first = np.unique(key[cand], return_index=True)
            ok = np.zeros(block, bool)
            ok[cand[first]] = True
        accepted = np.nonzero(ok)[0][:num_samples - count]
        used = block if count + len(accepted) < num_samples else int(accepted[-1]) + 1
        stream.advance(2 * used)
        tries += used
        count += len(accepted)
        rows.append(r[accepted])
        cols.append(c[accepted])
        if not replace:
            seen = np.union1d(seen, key[accepted])
    stream.close()
    if not rows:
        return np.zeros((2, 0), np.int32)
    return np.stack([np.concatenate(rows), np.concatenate(cols)]).astype(np.int32)


def negative_sampling_with_start_node(start_node_index, num_nodes, edge_index=None, rng=None):
    """For each start node, an end that is not the node itself nor one of
    its neighbours (either direction of ``edge_index``): [2, S] int32.
    Each node draws ``rng.integers(0, num_nodes)`` until one is accepted, in
    the order of the start nodes, as the JAX loop does; a node that finds
    none in ``max(100, 20·num_nodes)`` tries raises ``ValueError``."""
    rng = np.random.default_rng(rng)
    start = convert_union_to_numpy(start_node_index, np.int64)
    n = int(num_nodes)
    taken = None
    if edge_index is not None:
        ei = convert_union_to_numpy(edge_index, np.int64)
        taken = _PairSet(np.concatenate([ei[0], ei[1]]), np.concatenate([ei[1], ei[0]]),
                         (start, [0, n - 1]))
    ends = np.empty(len(start), np.int32)
    max_tries = max(100, 20 * n)
    stream = _IntegerStream(rng, n)
    i = tries = 0  # the node drawing next, and the tries it has made
    while i < len(start):
        # one try for each node left, accepted up to the first rejection
        c = stream.peek(len(start) - i)
        s = start[i:i + len(c)]
        ok = c != s
        if taken is not None:
            ok &= ~taken.contains(s, c)
        rejected = np.nonzero(~ok)[0]
        p = int(rejected[0]) if rejected.size else len(c)
        ends[i:i + p] = c[:p]
        if p:
            i, tries = i + p, 0
        if p < len(c):
            tries += 1
            p += 1
        stream.advance(p)
        if tries >= max_tries:
            stream.close()
            raise ValueError(
                f"negative_sampling_with_start_node: no non-neighbor exists "
                f"for start node {int(start[i])} (node is adjacent to all others)")
    stream.close()
    return np.stack([start.astype(np.int32), ends], axis=0)


def extract_unique_edge(edge_index, edge_weight=None, mode="undirected"):
    """One edge per pair: the (min, max) form deduplicated in
    ``"undirected"`` mode, duplicates merged otherwise; the weight of each
    pair's first edge. Returns (edge_index, edge_weight or None)."""
    edge_index = convert_union_to_numpy(edge_index, np.int32)
    props = None if edge_weight is None else [convert_union_to_numpy(edge_weight)]
    merge = convert_edge_to_upper if mode == "undirected" else merge_duplicated_edge
    new_index, new_props = merge(edge_index, props, None if props is None else ["first"])
    return new_index, None if new_props is None else new_props[0]


def _validate_split_sizes(n_samples, test_size, train_size, default_test_size=None):
    """(n_train, n_test) as ``sklearn.model_selection``'s
    ``_validate_shuffle_split`` gives them, with its errors."""
    if test_size is None and train_size is None:
        test_size = default_test_size
    test_kind = np.asarray(test_size).dtype.kind
    train_kind = np.asarray(train_size).dtype.kind
    for name, size, kind in (("test_size", test_size, test_kind),
                             ("train_size", train_size, train_kind)):
        if (kind == "i" and (size >= n_samples or size <= 0)) or (
                kind == "f" and (size <= 0 or size >= 1)):
            raise ValueError(f"{name}={size} should be either positive and smaller than the "
                             f"number of samples {n_samples} or a float in the (0, 1) range")
    for name, size, kind in (("train_size", train_size, train_kind),
                             ("test_size", test_size, test_kind)):
        if size is not None and kind not in ("i", "f"):
            raise ValueError(f"Invalid value for {name}: {size}")
    if train_kind == "f" and test_kind == "f" and train_size + test_size > 1:
        raise ValueError(f"The sum of test_size and train_size = {train_size + test_size}, "
                         "should be in the (0, 1) range. Reduce test_size and/or train_size.")
    n_test = ceil(test_size * n_samples) if test_kind == "f" else (
        float(test_size) if test_kind == "i" else None)
    n_train = floor(train_size * n_samples) if train_kind == "f" else (
        float(train_size) if train_kind == "i" else None)
    if train_size is None:
        n_train = n_samples - n_test
    elif test_size is None:
        n_test = n_samples - n_train
    if n_train + n_test > n_samples:
        raise ValueError(f"The sum of train_size and test_size = {int(n_train + n_test)}, "
                         f"should be smaller than the number of samples {n_samples}. "
                         "Reduce test_size and/or train_size.")
    n_train, n_test = int(n_train), int(n_test)
    if n_train == 0:
        raise ValueError(f"With n_samples={n_samples}, test_size={test_size} and "
                         f"train_size={train_size}, the resulting train set will be empty. "
                         "Adjust any of the aforementioned parameters.")
    return n_train, n_test


def _random_state(random_state) -> np.random.RandomState:
    """sklearn's ``check_random_state``: None is numpy's global
    ``RandomState``, an int seeds a new one, a ``RandomState`` is used as is."""
    if random_state is None or random_state is np.random:
        return np.random.mtrand._rand
    if isinstance(random_state, numbers.Integral):
        return np.random.RandomState(random_state)
    if isinstance(random_state, np.random.RandomState):
        return random_state
    raise ValueError(f"{random_state!r} cannot be used to seed a numpy.random.RandomState "
                     "instance")


def _split_ids(n, test_size, train_size, random_state, shuffle, stratify):
    """(train ids, test ids) of ``arange(n)`` as ``sklearn``'s
    ``train_test_split(arange(n), ...)`` gives them: with ``shuffle``, the
    test ids are the first ``n_test`` entries of
    ``random_state.permutation(n)`` and the train ids the next ``n_train``."""
    if stratify is not None:
        raise ValueError("edge_train_test_split: stratify is not supported")
    n_train, n_test = _validate_split_sizes(n, test_size, train_size, default_test_size=0.25)
    if not shuffle:
        return np.arange(n_train), np.arange(n_train, n_train + n_test)
    n_train, n_test = _validate_split_sizes(n, n_test, n_train)  # ShuffleSplit's own check
    permutation = _random_state(random_state).permutation(n)
    return permutation[n_test:n_test + n_train], permutation[:n_test]


def edge_train_test_split(edge_index, test_size, edge_weight=None, mode="undirected", *,
                          train_size=None, random_state=None, shuffle=True, stratify=None):
    """Link-prediction split of the unique edges (``extract_unique_edge``):
    (train_index, test_index, train_weight, test_weight), the weights None
    without ``edge_weight``. The ids are split as
    ``sklearn.model_selection.train_test_split`` splits them (``test_size``,
    ``train_size``, ``random_state``, ``shuffle``), without sklearn;
    ``stratify`` raises."""
    unique_index, unique_weight = extract_unique_edge(edge_index, edge_weight, mode=mode)
    train_ids, test_ids = _split_ids(unique_index.shape[1], test_size, train_size,
                                     random_state, shuffle, stratify)
    return (unique_index[:, train_ids], unique_index[:, test_ids],
            None if unique_weight is None else unique_weight[train_ids],
            None if unique_weight is None else unique_weight[test_ids])


def convert_x_to_3d(x, source_index, k=None, pad=True):
    """Rows of ``x`` grouped by ``source_index`` into [num_sources, k, F]
    float32, zero-padded, in input order within a group. ``k`` defaults
    to the largest group; with ``pad=False`` it is capped there."""
    x = convert_union_to_numpy(x, np.float32)
    source_index = convert_union_to_numpy(source_index, np.int64)
    num_sources = int(source_index.max()) + 1 if source_index.size else 0
    counts = np.bincount(source_index, minlength=num_sources)
    max_count = int(counts.max()) if counts.size else 0
    if k is None or (not pad and k > max_count):
        k = max_count
    order = np.argsort(source_index, kind="stable")
    pos_in_group = np.arange(len(source_index)) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    out = np.zeros((num_sources, k, x.shape[-1]), np.float32)
    keep = pos_in_group < k
    out[source_index[order][keep], pos_in_group[keep]] = x[order][keep]
    return out


def _local_ids(num_nodes: int, sources: np.ndarray) -> np.ndarray:
    """lookup[node] = its position in ``sources``, -1 outside them."""
    lookup = np.full(num_nodes, -1, np.int64)
    lookup[sources] = np.arange(len(sources))
    return lookup


class RandomNeighborSampler:
    """Neighbour sampling on the host over a CSR adjacency built once.

    ``sample`` takes ``k`` (with ``padding=True``: exactly k neighbours with
    replacement, vectorized; without: up to k without replacement, a
    ``rng.choice`` per source in order) or ``ratio`` (``max(1, int(deg ·
    ratio))`` without replacement) or neither (every edge), and
    ``sampled_node_index`` (rows by local id, neighbours outside the sample
    dropped). ``sample_dense`` is the fixed-k draw in the slot-major
    ``[k, S]`` form ``mean_graph_sage_fixed_k`` takes. A source without
    edges points at itself with weight 0 in the fixed-k modes.
    """

    def __init__(self, edge_index, edge_weight=None, rng=None):
        edge_index = convert_union_to_numpy(edge_index, np.int64)
        self.num_nodes = int(edge_index.max()) + 1 if edge_index.size else 0
        self.edge_weight = (np.ones(edge_index.shape[1], np.float32) if edge_weight is None
                            else convert_union_to_numpy(edge_weight, np.float32))
        self.rng = np.random.default_rng(rng)
        order = native.sort_by_row(edge_index[0], self.num_nodes)
        self.row_ptr = native.build_row_ptr(edge_index[0], self.num_nodes)
        self.sorted_col = edge_index[1][order].astype(np.int64)
        self.sorted_weight = self.edge_weight[order]
        self._sorted_col32 = None  # the native draw's int32 columns, made at its first use

    def _sources(self, sampled_node_index):
        if sampled_node_index is None:
            return np.arange(self.num_nodes, dtype=np.int64)
        return convert_union_to_numpy(sampled_node_index, np.int64)

    def sample(self, k=None, ratio=None, sampled_node_index=None, padding=False):
        """(edge_index [2, E] int32, edge_weight [E] float32), rows being the
        sources (their local ids with ``sampled_node_index``)."""
        sources = self._sources(sampled_node_index)
        virtual = sampled_node_index is not None
        if k is not None and padding:
            return self._sample_fixed_k(sources, k, virtual=virtual)
        if len(sources) > _SLOW_PATH_WARN_THRESHOLD:
            import warnings
            warnings.warn(
                f"RandomNeighborSampler.sample: without-replacement mode loops over "
                f"{len(sources)} sources in Python; use padding=True with a fixed k "
                "(vectorized, static shapes) at this scale", RuntimeWarning, stacklevel=2)
        rows, cols, weights = [], [], []
        for local_id, src in enumerate(sources):
            start, end = self.row_ptr[src], self.row_ptr[src + 1]
            deg = int(end - start)
            if deg == 0:
                continue
            if k is not None:
                pick = self.rng.choice(deg, size=min(k, deg), replace=False)
            elif ratio is not None:
                pick = self.rng.choice(deg, size=max(1, int(deg * ratio)), replace=False)
            else:
                pick = np.arange(deg)
            rows.append(np.full(len(pick), local_id if virtual else src, np.int64))
            cols.append(self.sorted_col[start + pick])
            weights.append(self.sorted_weight[start + pick])
        if not rows:
            return np.zeros((2, 0), np.int32), np.zeros(0, np.float32)
        row, col, weight = np.concatenate(rows), np.concatenate(cols), np.concatenate(weights)
        if virtual:
            col = _local_ids(self.num_nodes, sources)[col]
            keep = col >= 0
            row, col, weight = row[keep], col[keep], weight[keep]
        return np.stack([row, col], axis=0).astype(np.int32), weight.astype(np.float32)

    def sample_dense(self, k: int, sampled_node_index=None):
        """The fixed-k draw slot-major: ``(neighbor_idx [k, S] int32,
        neighbor_weight [k, S] float32)``, the draw of ``sample(k=k,
        padding=True)``. With ``sampled_node_index`` a neighbour outside the
        sample becomes a weight-0 slot on the source itself (the mean over
        the k slots counts it as 0), where ``sample`` drops it."""
        sources = self._sources(sampled_node_index)
        col, weight = self._draw_fixed_k(sources, k)
        if sampled_node_index is not None:
            new_col = _local_ids(self.num_nodes, sources)[col]
            dropped = new_col < 0
            new_col[dropped] = np.broadcast_to(np.arange(len(sources))[:, None],
                                               col.shape)[dropped]
            weight = np.where(dropped, 0.0, weight)
            col = new_col
        return (np.ascontiguousarray(col.T.astype(np.int32)),
                np.ascontiguousarray(weight.T.astype(np.float32)))

    def _draw_fixed_k(self, sources, k: int):
        """k neighbours per source with replacement: (col [S, k] int64,
        weight [S, k] float32). With the native library, one seed
        ``rng.integers(iinfo(int64).max)`` and ``native.sample_fixed_k``;
        without it, ``rng.random((S, k))`` scaled by each degree."""
        if native.available():
            seed = int(self.rng.integers(np.iinfo(np.int64).max))
            if self._sorted_col32 is None:
                self._sorted_col32 = self.sorted_col.astype(np.int32)
            drawn = native.sample_fixed_k(self.row_ptr, self._sorted_col32, self.sorted_weight,
                                          sources, k, seed)
            if drawn is not None:
                return drawn[0].astype(np.int64), drawn[1]
        deg = (self.row_ptr[sources + 1] - self.row_ptr[sources]).astype(np.int64)
        r = self.rng.random((len(sources), k))
        pick = self.row_ptr[sources][:, None] + np.floor(
            r * np.maximum(deg, 1)[:, None]).astype(np.int64)
        col = self.sorted_col[np.minimum(pick, len(self.sorted_col) - 1)]
        weight = self.sorted_weight[np.minimum(pick, len(self.sorted_weight) - 1)]
        isolated = deg == 0
        if isolated.any():
            col[isolated] = sources[isolated, None]
            weight[isolated] = 0.0
        return col, weight.astype(np.float32)

    def _sample_fixed_k(self, sources, k: int, virtual: bool):
        """The fixed-k draw as a flat edge list: k edges per source (rows by
        local id and out-of-sample neighbours dropped with ``virtual``)."""
        col, weight = self._draw_fixed_k(sources, k)
        row = np.repeat(np.arange(len(sources)) if virtual else sources, k)
        col, weight = col.reshape(-1), weight.reshape(-1).astype(np.float32)
        if virtual:
            col = _local_ids(self.num_nodes, sources)[col]
            keep = col >= 0
            row, col, weight = row[keep], col[keep], weight[keep]
        return np.stack([row, col], axis=0).astype(np.int32), weight


class UniformNeighborSampler:
    """Each edge kept with probability p (``rng.random(E) < p``); with
    ``sampled_node_index``, only edges with both ends in the sample, by
    local id."""

    def __init__(self, edge_index, edge_weight=None, rng=None):
        self.edge_index = convert_union_to_numpy(edge_index, np.int64)
        self.edge_weight = (np.ones(self.edge_index.shape[1], np.float32) if edge_weight is None
                            else convert_union_to_numpy(edge_weight, np.float32))
        self.num_nodes = int(self.edge_index.max()) + 1 if self.edge_index.size else 0
        self.rng = np.random.default_rng(rng)

    def sample(self, p: float, sampled_node_index=None):
        keep = self.rng.random(self.edge_index.shape[1]) < p
        edge_index, edge_weight = self.edge_index[:, keep], self.edge_weight[keep]
        if sampled_node_index is not None:
            sources = convert_union_to_numpy(sampled_node_index, np.int64)
            new_index = _local_ids(self.num_nodes, sources)[edge_index]
            ok = (new_index >= 0).all(axis=0)
            edge_index, edge_weight = new_index[:, ok], edge_weight[ok]
        return edge_index.astype(np.int32), edge_weight.astype(np.float32)
