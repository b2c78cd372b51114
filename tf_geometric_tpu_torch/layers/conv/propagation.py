"""Propagation-family layers (JAX counterpart:
``tf_geometric_tpu/layers/conv/propagation.py``); GIN so far."""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ...nn.conv.gin import gin
from ..base import unpack_edge_inputs

__all__ = ["GIN"]


class GIN(nn.Module):
    """GIN layer around a user MLP (a module, registered as ``mlp_model``).
    With ``train_eps`` the ε of ``(1 + ε)·x`` is a parameter ``eps`` [1]
    starting at ``eps``, as the flax layer's; else the constant ``eps``.
    ``layer([x, edge_index(, edge_weight)])`` or ``layer([x, sparse_adj])``;
    edge weights are not used (the adjacency is binary)."""

    def __init__(self, mlp_model: Callable, eps: float = 0.0, train_eps: bool = False,
                 device="cuda"):
        super().__init__()
        self.mlp_model = mlp_model
        if train_eps:
            self.eps = nn.Parameter(torch.full((1,), float(eps), device=device))
        else:
            self.eps = float(eps)

    def forward(self, inputs):
        x, edge_index, _ = unpack_edge_inputs(inputs)
        eps = self.eps[0] if isinstance(self.eps, torch.Tensor) else self.eps
        return gin(x, edge_index, self.mlp_model, eps=eps)
