"""Array-kind-agnostic helpers (JAX counterpart: ``tf_geometric_tpu/utils/union_utils.py``).

The host-side data layer accepts numpy arrays, Python lists and torch tensors
interchangeably; these helpers normalize them to numpy.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["convert_union_to_numpy", "union_len"]


def convert_union_to_numpy(data, dtype=None):
    """numpy copy/view of a list / numpy array / torch tensor (None passes through)."""
    if data is None:
        return None
    if isinstance(data, torch.Tensor):
        out = data.detach().cpu().numpy()
    else:
        out = np.asarray(data)
    if dtype is not None:
        out = out.astype(dtype)
    return out


def union_len(data) -> int:
    """Length of a list or first-dim size of an array."""
    if isinstance(data, (list, tuple)):
        return len(data)
    return int(data.shape[0])
