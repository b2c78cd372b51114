"""Per-source top-k selection (JAX counterpart: ``tf_geometric_tpu/nn/pool/topk_pool.py``).

``topk_pool`` is the host-side ragged selection (numpy; the indices are
data-dependent and not differentiated). ``topk_pool_fixed`` is the
fixed-k form on the tensors' device: a padded ``[num_sources·k]`` index
array and its validity mask.

Ties: the JAX function orders by ``jnp.lexsort((-score, source))``, a
stable sort, so tied scores keep node order. After a ReLU many scores are
exactly 0, so ties are the normal case, and another tie order would permute
SortPool's output rows. Here two stable sorts give the same order: by score
descending, then by source.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...utils.union_utils import convert_union_to_numpy

__all__ = ["topk_pool", "topk_pool_fixed"]


def topk_pool(source_index, score, k: Optional[int] = None,
              ratio: Optional[float] = None) -> np.ndarray:
    """Keep the top-k (or top-⌈ratio·n⌉) targets per source; returns indices
    into the original flat array, ordered by (source asc, rank asc)."""
    if k is None and ratio is None:
        raise ValueError("you should provide either k or ratio for topk_pool")
    if k is not None and ratio is not None:
        raise ValueError("provide either k or ratio for topk_pool, not both")
    source_index = convert_union_to_numpy(source_index, np.int64)
    score = convert_union_to_numpy(score, np.float32).reshape(-1)
    order = np.argsort(source_index, kind="stable")
    sorted_src = source_index[order]
    num_sources = int(sorted_src.max()) + 1 if sorted_src.size else 0
    counts = np.bincount(sorted_src, minlength=num_sources)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    keep = []
    for s in range(num_sources):
        group = order[starts[s]:starts[s] + counts[s]]
        if len(group) == 0:
            continue
        take = min(k, len(group)) if k is not None else max(int(np.ceil(len(group) * ratio)), 1)
        keep.append(group[np.argsort(-score[group], kind="stable")][:take])
    if not keep:
        return np.zeros(0, np.int32)
    return np.concatenate(keep).astype(np.int32)


def topk_pool_fixed(source_index, score, num_sources: int, k: int):
    """Fixed-k top-k per source: ``(indices [num_sources·k] int64, valid
    [num_sources·k] bool)``; a source with fewer than k targets fills its
    slots with index 0 and ``valid=False``. Out-of-range sources (padded
    entries) are dropped."""
    source_index = torch.as_tensor(source_index)
    score = torch.as_tensor(score).reshape(-1)
    device, n = score.device, score.shape[0]
    if n == 0:
        return (torch.zeros(num_sources * k, dtype=torch.long, device=device),
                torch.zeros(num_sources * k, dtype=torch.bool, device=device))
    src = source_index.to(device).long()
    safe_src = torch.where((src >= 0) & (src < num_sources), src, num_sources)
    # 0 - score is +0.0 for a zero score: -0.0 and +0.0 then sort as one key
    by_score = torch.sort(0.0 - score.detach(), stable=True).indices
    order = by_score[torch.sort(safe_src[by_score], stable=True).indices]
    counts = torch.bincount(safe_src, minlength=num_sources + 1)[:num_sources]
    starts = torch.cumsum(counts, 0) - counts
    slots = torch.arange(k, device=device)
    pos = (starts[:, None] + slots[None, :]).reshape(-1)
    valid = (slots[None, :] < counts[:, None]).reshape(-1)
    indices = torch.where(valid, order[pos.clamp(0, n - 1)], 0)
    return indices, valid
