"""Shared plumbing for the layer modules (JAX counterpart:
``tf_geometric_tpu/layers/base.py``).

Layers keep the reference's input contract: ``[x, SparseMatrix]``,
``[x, edge_index]`` or ``[x, edge_index, edge_weight]``. Kernels keep the
JAX layout ``[in, units]`` (``x @ kernel``).
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch

from ..sparse.matrix import SparseMatrix

__all__ = ["unpack_inputs", "unpack_edge_inputs", "glorot_uniform", "l2_loss", "dropout"]


def unpack_inputs(inputs) -> Tuple[Any, SparseMatrix]:
    """Normalize layer inputs to (x, sparse_adj); edge arrays follow x's device."""
    if isinstance(inputs, (list, tuple)):
        if len(inputs) == 2:
            x, adj = inputs
            if not isinstance(adj, SparseMatrix):
                n = x.shape[0]
                adj = SparseMatrix(adj, None, (n, n), device=x.device)
            return x, adj
        if len(inputs) == 3:
            x, edge_index, edge_weight = inputs
            n = x.shape[0]
            return x, SparseMatrix(edge_index, edge_weight, (n, n), device=x.device)
    raise ValueError(
        "layer inputs must be [x, SparseMatrix] or [x, edge_index(, edge_weight)]")


def unpack_edge_inputs(inputs):
    """Normalize layer inputs to (x, edge_index, edge_weight) for ops that
    work on raw edge lists; a SparseMatrix gives its index and value, and
    ``[x, edge_index]`` gives a None weight."""
    if isinstance(inputs, (list, tuple)):
        if len(inputs) == 2:
            x, second = inputs
            if isinstance(second, SparseMatrix):
                return x, second.index, second.value
            return x, second, None
        if len(inputs) == 3:
            return inputs[0], inputs[1], inputs[2]
    raise ValueError(
        "layer inputs must be [x, edge_index(, edge_weight)] or [x, SparseMatrix]")


def glorot_uniform(shape, generator=None, dtype=torch.float32):
    """Glorot/Xavier uniform draw on the CPU (flax's ``glorot_uniform``:
    U(-l, l) with l = sqrt(6 / (fan_in + fan_out)) for a [fan_in, fan_out]
    kernel); the caller moves it to its device."""
    fan_in, fan_out = shape[-2], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=dtype).uniform_(-limit, limit, generator=generator)


def l2_loss(params, weight: float, key_filter: str = "kernel"):
    """Sum of 0.5·‖w‖² over the parameters whose name has a dotted part
    containing ``key_filter``, times ``weight``: the JAX function's rule
    over a flax params tree, here over a module's ``named_parameters()`` or
    a {name: tensor} dict (the reference demos' L2 on kernels)."""
    items = params.named_parameters() if isinstance(params, torch.nn.Module) else params.items()
    total = 0.0
    for name, leaf in items:
        if any(key_filter in part for part in name.split(".")):
            total = total + 0.5 * torch.sum(leaf ** 2)
    return total * weight


def dropout(h, rate: float, training: bool, generator=None, keep_mask=None):
    """flax's ``Dropout(rate)``: in training mode ``h / (1 - rate)`` where
    kept, else 0; the keep decisions from ``keep_mask`` (bool, h's shape)
    if given, else drawn with ``generator``, one of which is required."""
    if not training or rate <= 0.0:
        return h
    if keep_mask is None:
        if generator is None:
            raise ValueError("dropout in training mode needs a generator or keep_mask")
        keep_mask = torch.rand(h.shape, generator=generator, device=h.device) < (1.0 - rate)
    keep_mask = torch.as_tensor(keep_mask, dtype=torch.bool, device=h.device)
    return torch.where(keep_mask, h / (1.0 - rate), torch.zeros_like(h))
