"""DropEdge: random edge dropout at train time (JAX counterpart:
``tf_geometric_tpu/nn/sampling/drop_edge.py``).

As in the JAX function, dropped edges are masked, not filtered: their
indices move out of range (every segment op and SpMM drops them) and their
attributes become 0, so the edge count stays the same. ``force_undirected``
keeps or drops both directions of a pair together, keyed on the canonical
(min, max) pair by the JAX function's hash. The draws come from a
``torch.Generator``, or an explicit ``keep_mask`` (the JAX function draws
from a key; the tests hand both the same decisions).
"""
from __future__ import annotations

import torch

__all__ = ["drop_edge"]

_U32 = 0xFFFFFFFF


def _undirected_keep(row, col, base: int, rate: float):
    """The JAX function's per-pair coin: a 32-bit hash of (min, max) mixed
    with ``base`` (a draw in [0, 2**31 - 1)), kept when its uniform value is
    at least ``rate``. Arithmetic in int64, cut to 32 bits after each step."""
    lo, hi = torch.minimum(row, col).long(), torch.maximum(row, col).long()
    pair_hash = (lo * 2654435761 + hi) & _U32
    mixed = pair_hash ^ int(base)
    mixed = ((mixed ^ (mixed >> 16)) * 0x45d9f3b) & _U32
    mixed = ((mixed ^ (mixed >> 16)) * 0x45d9f3b) & _U32
    mixed = mixed ^ (mixed >> 16)
    return (mixed.float() / float(2 ** 32)) >= rate


def drop_edge(inputs, rate: float = 0.5, force_undirected: bool = False, training=None,
              generator=None, num_nodes=None, keep_mask=None):
    """``[edge_index, *edge_attrs]`` with ~``rate`` of the edges masked out
    (index ``num_nodes``, attributes 0) when training. ``num_nodes``, the
    out-of-range sentinel, defaults to ``max(edge_index) + 1``. The keep
    decisions come from ``keep_mask`` [E] if given, else from
    ``generator``; training with ``rate > 0`` and neither raises."""
    if rate < 0.0 or rate > 1.0:
        raise ValueError(f"Dropout probability has to be between 0 and 1, got {rate}")
    if not training or rate == 0.0:
        return inputs
    if generator is None and keep_mask is None:
        raise ValueError(
            "drop_edge requires a generator or keep_mask when training with rate > 0 "
            "(a silent no-op would train without edge dropout)")

    edge_index, *edge_attrs = inputs
    edge_index = torch.as_tensor(edge_index)
    if num_nodes is None:
        num_nodes = int(edge_index.max()) + 1
    row, col = edge_index[0], edge_index[1]
    if keep_mask is not None:
        keep = torch.as_tensor(keep_mask, dtype=torch.bool, device=edge_index.device)
    elif force_undirected:
        base = int(torch.randint(0, 2 ** 31 - 1, (), generator=generator,
                                 device=generator.device))
        keep = _undirected_keep(row, col, base, rate)
    else:
        keep = torch.rand(row.shape, generator=generator, device=edge_index.device) >= rate

    masked_index = torch.where(keep[None, :], edge_index,
                               torch.full_like(edge_index, num_nodes))
    out_attrs = []
    for attr in edge_attrs:
        attr = torch.as_tensor(attr, device=edge_index.device)
        mask = keep.reshape(keep.shape + (1,) * (attr.dim() - 1))
        out_attrs.append(torch.where(mask, attr, torch.zeros_like(attr)))
    return [masked_index] + out_attrs
