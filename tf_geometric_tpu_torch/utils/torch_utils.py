"""Counterparts of ``tf_geometric_tpu/utils/jax_utils.py``.

``function`` is the JAX module's compile decorator (``jax.jit`` with the
layer-call keywords ``training``/``cache`` static). PyTorch runs eagerly
and those keywords are plain arguments here already, so it returns the
function unchanged. ``split_hybrid_constants`` splits a nested structure
into its floating-point leaves and a ``rebuild``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["function", "split_hybrid_constants"]


def function(fn=None, *, static_argnums=None, static_argnames=None):
    """``@function`` or ``@function(static_argnums=..., static_argnames=...)``:
    the function itself. The static arguments have no meaning in eager
    PyTorch and are accepted so that code written for the JAX decorator
    runs; any other keyword raises ``TypeError``."""
    if fn is not None and callable(fn):
        return fn
    return lambda f: f


def _is_float_leaf(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point()
    return hasattr(leaf, "dtype") and np.issubdtype(np.dtype(leaf.dtype), np.floating)


def _flatten(tree, leaves):
    """Leaves of nested dicts (by sorted key), lists and tuples (named too)
    in JAX's pytree order; returns the structure with each leaf replaced by
    its index. None is an empty node, as in JAX."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _flatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        items = [_flatten(t, leaves) for t in tree]
        if isinstance(tree, list):
            return items
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    leaves.append(tree)
    return _Leaf(len(leaves) - 1)


class _Leaf(int):
    """A leaf's index in a flattened structure."""


def _unflatten(skeleton, leaves):
    if isinstance(skeleton, _Leaf):
        return leaves[skeleton]
    if skeleton is None:
        return None
    if isinstance(skeleton, dict):
        return {k: _unflatten(v, leaves) for k, v in skeleton.items()}
    items = [_unflatten(t, leaves) for t in skeleton]
    if isinstance(skeleton, list):
        return items
    return type(skeleton)(*items) if hasattr(skeleton, "_fields") else type(skeleton)(items)


def split_hybrid_constants(tree):
    """``(val_leaves, rebuild)``: the floating-point leaves (tensors or numpy
    arrays) of ``tree`` in JAX's pytree order, and a function mapping such a
    list back to the whole structure, the other leaves (index arrays,
    scalars) captured by closure. Only the non-float leaves are kept, so
    the caller's float originals can be freed."""
    leaves = []
    skeleton = _flatten(tree, leaves)
    is_val = [_is_float_leaf(leaf) for leaf in leaves]
    val_leaves = [leaf for leaf, f in zip(leaves, is_val) if f]
    const_leaves = [None if f else leaf for leaf, f in zip(leaves, is_val)]

    def rebuild(vals):
        it = iter(vals)
        return _unflatten(skeleton, [next(it) if f else leaf
                                     for leaf, f in zip(const_leaves, is_val)])

    return val_leaves, rebuild
