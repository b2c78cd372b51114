"""The "elegant API" tour (JAX counterpart: ``demo/demo_elegant_api.py``):
one ``Graph`` of 5 nodes (features from numpy's global stream, unseeded as
in the script) made directed; the functional ``nn.gcn`` with the graph's
cache and a kernel from ``default_rng(0)``; the module ``layers.GAT(units=4,
num_heads=2)`` (flax's initializers, ``init_like_flax``); and the same GCN
under ``utils.torch_utils.function``, the counterpart of the JAX compile
decorator. Returns True.

    python -m tf_geometric_tpu_torch.demos.demo_elegant_api            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_elegant_api --cpu

On the card each GCN launches Kernel A (``csrc/csr_spmm.cu``) at F = 4, and
the GAT, whose query and value heads are both 2 wide, the fused attention
forward (``csrc/gat_attention.cu``, X4) at (H, d) = (2, 2) on a layout
built for the call.
"""
from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from ..data.graph import Graph
from ..layers.conv.gat import GAT
from ..nn.conv.gcn import gcn
from ..utils.torch_utils import function
from .demo_utils import init_like_flax

__all__ = ["tour_graph", "gat_layer", "main"]

TOUR_EDGES = [[0, 0, 1, 3], [1, 2, 2, 1]]


def tour_graph() -> Graph:
    """The tours' graph: 5 nodes of 20 features drawn from numpy's global
    stream (``np.random.randn``), 4 undirected pairs made directed."""
    return Graph(x=np.random.randn(5, 20).astype(np.float32),
                 edge_index=TOUR_EDGES).to_directed()


def gat_layer(in_features: int, device="cuda") -> GAT:
    """``GAT(units=4, num_heads=2)`` with flax's initializers from seed 0."""
    return init_like_flax(GAT(in_features, 4, num_heads=2, device=device), seed=0)


def main(device="cuda", stats: Optional[dict] = None):
    """The tour; ``stats``, when given, receives ``graph``, ``kernel``,
    ``gcn`` (the functional GCN's output), ``gat`` (the layer's output),
    ``layer`` and ``jitted`` (the decorated GCN's output)."""
    graph = tour_graph()
    print(graph)

    # functional API
    rng = np.random.default_rng(0)
    kernel = torch.as_tensor(rng.normal(size=(20, 4)), dtype=torch.float32, device=device)
    x = torch.as_tensor(graph.x, device=device)
    h = gcn(x, graph.adj(device=device), kernel, activation=torch.relu, cache=graph.cache)
    print("functional gcn:", tuple(h.shape))

    # module API
    layer = gat_layer(graph.num_features, device)
    h_gat = layer([x, torch.as_tensor(graph.edge_index, device=device)])
    print("oop gat:", tuple(h_gat.shape))

    # the compile decorator's counterpart
    @function
    def fast_forward(x):
        return gcn(x, graph.adj(device=device), kernel, cache=graph.cache)

    h_fast = fast_forward(x)
    print("jitted:", tuple(h_fast.shape))
    if stats is not None:
        stats.update(graph=graph, kernel=kernel, gcn=h, gat=h_gat, layer=layer, jitted=h_fast,
                     steps=0, evals=0)
    return True


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
