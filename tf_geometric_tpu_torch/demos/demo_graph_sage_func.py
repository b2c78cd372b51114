"""The functional GraphSAGE with host sampling outside the step (JAX
counterpart: ``demo/demo_graph_sage_func.py``): ``mean_graph_sage`` twice
(self and neighbour kernels of 64, concatenated to 128, relu) and a dense
head, numpy-initialized (normals of scale √(2 / fan_in) from
``default_rng(0)``); the fixed-k host draws, the graphs, the loss and the
metric of ``demo_graph_sage``; Adam 1e-2, 8 epochs.

    python -m tf_geometric_tpu_torch.demos.demo_graph_sage_func            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_graph_sage_func --cpu

The layers run the segment core on the COO edge lists, as the JAX demo's
do: no hand-written kernel is on this path.
"""
from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.conv.graph_sage import mean_graph_sage
from ..utils.metrics import micro_f1
from .demo_graph_sage import attach_samplers, load_graphs, sample_edges
from .demo_utils import demo_steps

__all__ = ["SageParams", "forward", "main", "UNITS", "LEARNING_RATE"]

UNITS, LEARNING_RATE = 128, 1e-2


class SageParams(nn.Module):
    """The demo's parameters, drawn as the JAX demo draws them: normals of
    scale √(2 / shape[0]) from ``default_rng(seed)`` in the order
    ``sage0_self sage0_neigh sage1_self sage1_neigh fc_w``, ``fc_b`` zeros."""

    def __init__(self, in_features: int, num_classes: int, seed: int = 0, device="cuda"):
        super().__init__()
        rng = np.random.default_rng(seed)
        half = UNITS // 2
        shapes = {"sage0_self": (in_features, half), "sage0_neigh": (in_features, half),
                  "sage1_self": (UNITS, half), "sage1_neigh": (UNITS, half),
                  "fc_w": (UNITS, num_classes)}
        for name, shape in shapes.items():
            value = rng.normal(scale=np.sqrt(2.0 / shape[0]), size=shape)
            self.register_parameter(name, nn.Parameter(
                torch.tensor(value, dtype=torch.float32, device=device)))
        self.fc_b = nn.Parameter(torch.zeros(num_classes, device=device))


def forward(p: SageParams, x, edge_lists):
    """The two functional layers and the head on the given draws."""
    (ei0, ew0), (ei1, ew1) = edge_lists
    h = mean_graph_sage(x, ei0, ew0, p.sage0_self, p.sage0_neigh, activation=torch.relu)
    h = mean_graph_sage(h, ei1, ew1, p.sage1_self, p.sage1_neigh, activation=torch.relu)
    return h @ p.fc_w + p.fc_b


def main(device="cuda", num_epochs: int = 8, stats: Optional[dict] = None):
    """Train on ``load_graphs``; returns the mean test micro-F1 (``stats``
    as ``demo_graph_sage.main``'s)."""
    train_graphs, valid_graphs, test_graphs = load_graphs()
    attach_samplers(train_graphs + valid_graphs + test_graphs)
    num_classes = np.asarray(train_graphs[0].y).shape[1]
    p = SageParams(np.asarray(train_graphs[0].x).shape[1], num_classes, device=device)
    optimizer = torch.optim.Adam(p.parameters(), lr=LEARNING_RATE)
    losses = []

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    for epoch in range(demo_steps(num_epochs)):
        epoch_losses = []
        for g in train_graphs:
            optimizer.zero_grad(set_to_none=True)
            loss = F.binary_cross_entropy_with_logits(
                forward(p, tensor(g.x), sample_edges(g, device)), tensor(g.y))
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
            epoch_losses.append(float(losses[-1]))
        print(f"epoch {epoch}: loss={np.mean(epoch_losses):.4f}")
    f1s = []
    with torch.no_grad():
        for g in test_graphs:
            preds = (forward(p, tensor(g.x), sample_edges(g, device)) > 0).cpu().numpy()
            f1s.append(micro_f1(preds, np.asarray(g.y)))
    f1 = float(np.mean(f1s))
    print(f"test micro-F1: {f1:.4f}")
    if stats is not None:
        stats.update(steps=len(losses), losses=losses, evals=len(test_graphs))
    return f1


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
