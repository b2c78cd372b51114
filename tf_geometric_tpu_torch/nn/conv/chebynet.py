"""ChebyNet: Chebyshev spectral convolution (JAX counterpart:
``tf_geometric_tpu/nn/conv/chebynet.py``).

T0 = x; T1 = L̂x; T_k = 2·L̂·T_{k-1} − T_{k-2}; out = Σ_k T_k W_k, with
L̂ = 2·L/λ_max (λ_max = 2.0, or scipy's ``eigsh`` on the host when
``use_dynamic_lambda_max``). The scaled Laplacian is built on the host once
and cached; each ``L̂ @ T`` is ``SparseMatrix @``, the COO SpMM (X6).
"""
from __future__ import annotations

import numpy as np

from ...sparse.matrix import SparseMatrix
from ...utils.graph_utils import LaplacianMaxEigenvalue, get_laplacian, remove_self_loop_edge

__all__ = ["chebynet", "chebynet_norm_edge", "chebynet_cache_normed_edge", "compute_cache_key"]

CACHE_KEY_CHEBYNET_NORMED_EDGE_TEMPLATE = "chebynet_normed_edge_{}_{}"


def compute_cache_key(normalization_type, use_dynamic_lambda_max=False):
    """The JAX key: the normalization and the λ_max mode."""
    return CACHE_KEY_CHEBYNET_NORMED_EDGE_TEMPLATE.format(normalization_type,
                                                          use_dynamic_lambda_max)


def chebynet_norm_edge(edge_index, num_nodes: int, edge_weight=None,
                       normalization_type: str = "sym", use_dynamic_lambda_max: bool = False,
                       cache=None, device="cuda"):
    """The scaled Laplacian's edges (index [2, E' + N], weight), self-loops
    removed first, computed on the host and returned (and cached) on
    ``device``."""
    key = compute_cache_key(normalization_type, use_dynamic_lambda_max)
    if cache is not None:
        cached = cache.get(key, None)
        if cached is not None:
            return cached

    edge_index, edge_weight = remove_self_loop_edge(edge_index, edge_weight)
    if edge_weight is None:
        edge_weight = np.ones(edge_index.shape[1], np.float32)
    lap_index, lap_weight = get_laplacian(edge_index, num_nodes, edge_weight,
                                          normalization_type)
    if use_dynamic_lambda_max:
        lambda_max = LaplacianMaxEigenvalue(edge_index, num_nodes, edge_weight)(
            normalization_type=normalization_type)
    else:
        lambda_max = 2.0
    result = (lap_index.to(device), ((2.0 * lap_weight) / lambda_max).to(device))
    if cache is not None:
        cache[key] = result
    return result


def chebynet_cache_normed_edge(graph, normalization_type="sym", use_dynamic_lambda_max=False,
                               override=False, device="cuda"):
    """Build the scaled-Laplacian cache entry on a Graph, on ``device``."""
    if override:
        graph.cache[compute_cache_key(normalization_type, use_dynamic_lambda_max)] = None
    chebynet_norm_edge(graph.edge_index, graph.num_nodes, graph.edge_weight,
                       normalization_type, use_dynamic_lambda_max=use_dynamic_lambda_max,
                       cache=graph.cache, device=device)


def chebynet(x, edge_index, edge_weight, k: int, kernels, bias=None, activation=None,
             normalization_type: str = "sym", use_dynamic_lambda_max: bool = False, cache=None):
    """The Chebyshev recurrence over the scaled Laplacian (on ``x``'s device)."""
    num_nodes = x.shape[0]
    lap_index, lap_weight = chebynet_norm_edge(
        edge_index, num_nodes, edge_weight, normalization_type,
        use_dynamic_lambda_max=use_dynamic_lambda_max, cache=cache, device=x.device)
    lap = SparseMatrix(lap_index, lap_weight, (num_nodes, num_nodes))

    if isinstance(x, SparseMatrix):
        x = x.to_dense()

    T0_x = x
    out = T0_x @ kernels[0]
    if k > 1:
        T1_x = lap @ x
        out = out + T1_x @ kernels[1]
    for i in range(2, k):
        T2_x = lap @ T1_x * 2.0 - T0_x
        out = out + T2_x @ kernels[i]
        T0_x, T1_x = T1_x, T2_x

    if bias is not None:
        out = out + bias
    if activation is not None:
        out = activation(out)
    return out
