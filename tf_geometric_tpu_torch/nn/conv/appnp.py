"""APPNP: an MLP encoder and personalized-PageRank propagation (JAX
counterpart: ``tf_geometric_tpu/nn/conv/appnp.py``).

Dropout: ``jax.random`` keys become a ``torch.Generator``, or explicit keep
masks (``edge_keep_mask`` [E], ``dense_keep_masks`` one [N, units] mask or
None per dense layer), so that a test can hand both packages the same
draws. With a generator the edge mask is drawn first, then the dense masks
layer by layer, as the JAX key splits order them.
"""
from __future__ import annotations

import torch

from ...sparse.matrix import SparseMatrix
from .gcn import compile_and_dropout, compute_cache_key, gcn_norm_adj

__all__ = ["appnp", "mlp_encode"]


def _dropout(h, rate: float, generator=None, keep_mask=None):
    """Inverted dropout; a no-op without a generator or a mask, as the JAX
    function is without a key."""
    if rate <= 0.0 or (generator is None and keep_mask is None):
        return h
    if keep_mask is None:
        keep_mask = torch.rand(h.shape, generator=generator, device=h.device) < (1.0 - rate)
    keep_mask = torch.as_tensor(keep_mask, dtype=torch.bool, device=h.device)
    return torch.where(keep_mask, h / (1.0 - rate), torch.zeros_like(h))


def mlp_encode(x, kernels, biases, dense_activation, dense_drop_rate, last_dense_drop_rate,
               training, generator=None, keep_masks=None):
    """The shared MLP encoder with the reference's per-layer dropout
    schedule: activation and dropout after every layer but the last, which
    gets only ``last_dense_drop_rate``. ``keep_masks``: one mask or None per
    layer, used in place of a draw."""
    h = x
    if kernels is None:
        return h
    num_dense_layers = len(kernels)
    if keep_masks is None:
        keep_masks = [None] * num_dense_layers
    for i, (kernel, bias) in enumerate(zip(kernels, biases)):
        h = h.matmul(kernel) if isinstance(h, SparseMatrix) else h @ kernel
        if bias is not None:
            h = h + bias
        if i < num_dense_layers - 1:
            if dense_activation is not None:
                h = dense_activation(h)
            if training:
                h = _dropout(h, dense_drop_rate, generator, keep_masks[i])
        elif training:
            h = _dropout(h, last_dense_drop_rate, generator, keep_masks[i])
    return h


def appnp(x, edge_index, edge_weight, kernels, biases, dense_activation=torch.relu,
          activation=None, k: int = 10, alpha: float = 0.1, dense_drop_rate: float = 0.0,
          last_dense_drop_rate: float = 0.0, edge_drop_rate: float = 0.0, cache=None,
          training: bool = False, generator=None, edge_keep_mask=None, dense_keep_masks=None):
    """h = MLP(x); out_{t+1} = (1-α)·Â·out_t + α·h for k iterations. The
    hops run over the CSR twin of the cached normalized adjacency, its
    values dropped per step when training with ``edge_drop_rate``."""
    num_nodes = x.shape[0]
    normed_adj = gcn_norm_adj(
        SparseMatrix(edge_index, edge_weight, (num_nodes, num_nodes), device=x.device),
        cache=cache)
    normed_adj = compile_and_dropout(
        normed_adj, cache, compute_cache_key("both", True, True, True, False),
        edge_drop_rate, training, generator=generator, keep_mask=edge_keep_mask)

    h = mlp_encode(x, kernels, biases, dense_activation, dense_drop_rate,
                   last_dense_drop_rate, training, generator, dense_keep_masks)

    output = h
    for _ in range(k):
        output = normed_adj @ output
        output = output * (1.0 - alpha) + h * alpha

    if activation is not None:
        output = activation(output)
    return output
