"""The introductory tutorial (JAX counterpart: ``tutorial_intro.py`` at the
repository's root): the tour graph, the functional ``nn.gcn``, the
``nn.mean_pool`` readout and ``layers.GAT(units=4, num_heads=2)``
(``demo_elegant_api``'s pieces), then a two-layer GCN (kernels only, drawn
from the tour's ``default_rng(0)`` after its GCN kernel, scale 0.05, as the
script draws them) trained 100 steps with Adam 1e-2 on the mean softmax
cross-entropy of ``FakePlanetoidDataset("cora")``'s training nodes (2,708
nodes, 1,433 features, 7 classes). Returns the test accuracy.

    python -m tf_geometric_tpu_torch.demos.tutorial_intro            # on the card
    python -m tf_geometric_tpu_torch.demos.tutorial_intro --cpu

On the card the tour launches Kernel A (``csrc/csr_spmm.cu``) once and the
fused attention forward (X4) once at (H, d) = (2, 2); each training step
launches Kernel A four times (forward and ``dh`` of each layer, at F = 16
and F = 7), the evaluation twice.
"""
from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..datasets.synthetic_citation import FakePlanetoidDataset
from ..nn.conv.gcn import gcn, gcn_build_cache_for_graph
from ..nn.pool.common_pool import mean_pool
from .demo_elegant_api import gat_layer, tour_graph

__all__ = ["TutorialGCN", "load_cora", "main", "NUM_STEPS", "LEARNING_RATE"]

NUM_STEPS = 100
LEARNING_RATE = 1e-2
HIDDEN = 16


class TutorialGCN(nn.Module):
    """The tutorial's two GCN kernels ``w0`` [F, 16] and ``w1`` [16, C]
    (no biases), normals of scale 0.05 drawn from ``rng`` in that order."""

    def __init__(self, in_features: int, num_classes: int, rng: np.random.Generator,
                 device="cuda"):
        super().__init__()
        for name, shape in (("w0", (in_features, HIDDEN)), ("w1", (HIDDEN, num_classes))):
            value = rng.normal(scale=0.05, size=shape)
            self.register_parameter(name, nn.Parameter(
                torch.tensor(value, dtype=torch.float32, device=device)))

    def forward(self, x, adj, cache: dict):
        h = gcn(x, adj, self.w0, activation=torch.relu, cache=cache)
        return gcn(h, adj, self.w1, cache=cache)


def load_cora(device="cuda"):
    """``FakePlanetoidDataset("cora")`` on ``device`` with its GCN cache
    built: ``(graph, (train, valid, test))``, index tensors int64."""
    cora, splits = FakePlanetoidDataset("cora").load_data()
    cora.convert_data_to_tensor(device=device)
    gcn_build_cache_for_graph(cora, device=device)
    return cora, tuple(torch.as_tensor(np.asarray(s, np.int64), device=device) for s in splits)


def main(device="cuda", stats: Optional[dict] = None, num_steps: int = NUM_STEPS):
    """The tutorial; returns the test accuracy. ``stats``, when given,
    receives the tour's ``graph``, ``gcn``, ``readout``, ``gat``, then
    ``losses`` (each step's, tensors), ``steps``, ``evals`` and ``model``."""
    # 1. a graph
    graph = tour_graph()
    print(graph)

    # 2. the functional API
    rng = np.random.default_rng(0)
    kernel = torch.as_tensor(rng.normal(size=(20, 4)), dtype=torch.float32, device=device)
    x = torch.as_tensor(graph.x, device=device)
    h = gcn(x, graph.adj(device=device), kernel, activation=torch.relu, cache=graph.cache)
    print("gcn output:", tuple(h.shape))
    readout = mean_pool(h, torch.zeros(5, dtype=torch.int64, device=device), num_graphs=1)
    print("graph readout:", tuple(readout.shape))

    # 3. the module API
    h_gat = gat_layer(graph.num_features, device)(
        [x, torch.as_tensor(graph.edge_index, device=device)])
    print("gat output:", tuple(h_gat.shape))

    # 4. a two-layer GCN on the synthetic Cora
    cora, (train_idx, _, test_idx) = load_cora(device)
    num_classes = int(cora.y.max()) + 1
    model = TutorialGCN(cora.num_features, num_classes, rng, device)
    adj, cache, y = cora.adj(device=device), cora.cache, cora.y.long()
    optimizer = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)
    losses = []
    for _ in range(num_steps):
        optimizer.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(cora.x, adj, cache)[train_idx], y[train_idx])
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
    with torch.no_grad():
        preds = model(cora.x, adj, cache).argmax(dim=-1)
    acc = float((preds[test_idx] == y[test_idx]).float().mean())
    print(f"tutorial GCN test accuracy: {acc:.4f}")
    if stats is not None:
        stats.update(graph=graph, gcn=h, readout=readout, gat=h_gat, losses=losses,
                     steps=num_steps, evals=1, model=model)
    return acc


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
