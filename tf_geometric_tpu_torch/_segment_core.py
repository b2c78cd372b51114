"""Segment reduction primitives, the innermost compute layer.

PyTorch counterpart of ``tf_geometric_tpu/_segment_core.py``, with the same
semantics: max-subtracted segment softmax with eps=1e-8, segment counting,
and min/max reductions whose empty segments read 0.

Out-of-range segment ids (``>= num_segments`` or negative) are dropped, so
padded edges can use ``segment_id = num_segments``. XLA's scatter drops them
by itself; ``index_add_``/``scatter_reduce`` on a CUDA tensor raise a
device-side assert instead. So every op here routes them into one extra
trash segment, ``num_segments``, and slices it off: the mask is applied
before any indexing op sees the ids.
"""
from __future__ import annotations

import torch

__all__ = [
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_min",
    "segment_softmax",
    "segment_count",
    "segment_normalize",
    "segment_op_with_pad",
]


def _in_range(segment_ids, num_segments: int):
    return (segment_ids >= 0) & (segment_ids < num_segments)


def _trash_ids(segment_ids, num_segments: int):
    """int64 ids with every out-of-range id moved to the trash row ``num_segments``."""
    ids = segment_ids.long()
    return torch.where(_in_range(ids, num_segments), ids,
                       torch.full_like(ids, num_segments))


def _expand_ids(ids, data):
    return ids.reshape(ids.shape + (1,) * (data.dim() - 1)).expand_as(data)


def segment_sum(data, segment_ids, num_segments: int, indices_are_sorted: bool = False):
    """Sum ``data`` rows into ``num_segments`` buckets keyed by ``segment_ids``."""
    ids = _trash_ids(segment_ids, num_segments)
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    return out.index_add(0, ids, data)[:num_segments]


def segment_count(segment_ids, num_segments: int, weights=None):
    """Number of elements (or total weight) landing in each segment."""
    if weights is None:
        weights = torch.ones(segment_ids.shape, dtype=torch.float32,
                             device=segment_ids.device)
    return segment_sum(weights, segment_ids, num_segments)


def segment_mean(data, segment_ids, num_segments: int, indices_are_sorted: bool = False):
    """Per-segment mean; empty segments produce 0."""
    total = segment_sum(data, segment_ids, num_segments)
    count = torch.clamp_min(segment_count(segment_ids, num_segments), 1.0)
    return total / count.reshape(count.shape + (1,) * (total.dim() - count.dim()))


def _segment_extreme(data, segment_ids, num_segments: int, reduce: str):
    ids = _trash_ids(segment_ids, num_segments)
    # the JAX op's fill (-inf for max, +inf for min), mapped to 0 below.
    # include_self=False: a non-empty segment reduces over its members only.
    # The fill never equals a member, so the backward splits a segment's
    # cotangent evenly among its tied members alone, as JAX does (a fill of
    # 0 would take a share from a segment whose max is 0)
    fill = float("-inf") if reduce == "amax" else float("inf")
    out = data.new_full((num_segments + 1,) + tuple(data.shape[1:]), fill)
    out = out.scatter_reduce(0, _expand_ids(ids, data), data, reduce,
                             include_self=False)[:num_segments]
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def segment_max(data, segment_ids, num_segments: int, indices_are_sorted: bool = False):
    """Per-segment max; empty (and non-finite) segments produce 0."""
    return _segment_extreme(data, segment_ids, num_segments, "amax")


def segment_min(data, segment_ids, num_segments: int, indices_are_sorted: bool = False):
    """Per-segment min; empty (and non-finite) segments produce 0."""
    return _segment_extreme(data, segment_ids, num_segments, "amin")


def segment_softmax(data, segment_ids, num_segments: int, eps: float = 1e-8,
                    indices_are_sorted: bool = False):
    """Numerically stable softmax within each segment.

    Subtracts the per-segment max, exponentiates and divides by the
    per-segment sum plus ``eps``. Out-of-range entries are hard-zeroed.
    """
    seg_max = segment_max(data, segment_ids, num_segments)
    safe_ids = segment_ids.long().clamp(0, max(num_segments - 1, 0))
    in_range = _in_range(segment_ids, num_segments)
    in_range = in_range.reshape(in_range.shape + (1,) * (data.dim() - 1))
    shifted = torch.where(in_range, data - seg_max[safe_ids],
                          torch.full_like(data, float("-inf")))
    exped = torch.exp(shifted)
    seg_sum = segment_sum(exped, segment_ids, num_segments)
    return exped / (seg_sum[safe_ids] + eps)


def segment_op_with_pad(segment_op, data, segment_ids, num_segments: int):
    """Apply a segment reduction, zero-filling non-finite (empty) segments."""
    out = segment_op(data, segment_ids, num_segments=num_segments)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def segment_normalize(data, segment_ids, num_segments: int, eps: float = 1e-8):
    """Divide each element by its segment's sum (L1 normalization per segment)."""
    seg_sum = segment_sum(data, segment_ids, num_segments)
    safe_ids = segment_ids.long().clamp(0, max(num_segments - 1, 0))
    return data / (seg_sum[safe_ids] + eps)
