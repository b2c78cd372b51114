"""Mini-batch GraphSAGE with host neighbour sampling (JAX counterpart:
``demo/demo_graph_sage.py``): per graph, a ``RandomNeighborSampler(rng=0)``
draws fixed-k edge lists (``sample(k, padding=True)``, k = 10 then 5) on
the host; ``SageNet`` is two ``MeanGraphSage(128, relu)``, dropout 0.3 and a
dense head; the mean sigmoid cross-entropy of the multi-label targets, Adam
1e-2, 8 epochs over the training graphs; the test micro-F1
(``utils.metrics.micro_f1``), averaged over the test graphs.

    python -m tf_geometric_tpu_torch.demos.demo_graph_sage            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_graph_sage --cpu

``load_graphs`` reads PPI from its files, or builds five synthetic
multi-label graphs where they are not on disk, as the JAX demo does. The
host draws are bit for bit with the JAX sampler's. The layers run the
segment core on the COO edge lists (gather, ``segment_mean``), as the JAX
demo does: no hand-written kernel is on this path.
"""
from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.graph import Graph
from ..layers.base import dropout
from ..layers.conv.graph_sage import MeanGraphSage
from ..utils.graph_utils import RandomNeighborSampler
from ..utils.metrics import micro_f1
from .demo_utils import demo_steps, dropout_generator, init_like_flax

__all__ = ["load_graphs", "attach_samplers", "sample_edges", "SageNet", "main",
           "NUM_SAMPLED_NEIGHBORS", "UNITS", "DROP_RATE", "LEARNING_RATE"]

NUM_SAMPLED_NEIGHBORS = [10, 5]
UNITS, DROP_RATE, LEARNING_RATE = 128, 0.3, 1e-2
# the synthetic fallback: graph shape, label width, and the seeds of the
# training, validation and test graphs
SYNTH_NODES, SYNTH_FEATURES, SYNTH_CLASSES = 300, 50, 4
SYNTH_SEEDS = ((0, 1, 2), (10,), (20,))


def _synthetic_graph(seed: int) -> Graph:
    from ..datasets.synthetic_citation import synthetic_citation_graph
    g = synthetic_citation_graph(num_nodes=SYNTH_NODES, num_features=SYNTH_FEATURES,
                                 num_classes=SYNTH_CLASSES, seed=seed)
    y = np.zeros((SYNTH_NODES, 2 * SYNTH_CLASSES), np.int32)
    y[np.arange(SYNTH_NODES), g.y] = 1
    y[np.arange(SYNTH_NODES), SYNTH_CLASSES + (np.asarray(g.y) + 1) % SYNTH_CLASSES] = 1
    return Graph(x=g.x, edge_index=g.edge_index, y=y)


def load_graphs():
    """``(train, valid, test)`` lists of host graphs: PPI from its files, or
    the synthetic multi-label graphs (300 nodes, 50 features, 8 labels; numpy
    seeds 0-2, 10 and 20) where they are not on disk."""
    from ..datasets.ppi import PPIDataset
    try:
        return PPIDataset().load_data()
    except OSError:
        print("PPI unavailable: using synthetic multi-label graphs")
        return tuple([_synthetic_graph(s) for s in seeds] for seeds in SYNTH_SEEDS)


def attach_samplers(graphs) -> None:
    """A ``RandomNeighborSampler(rng=0)`` in each graph's cache."""
    for g in graphs:
        g.cache["sampler"] = RandomNeighborSampler(g.edge_index, rng=0)


def sample_edges(graph, device="cuda"):
    """One host draw per layer, ``((edge_index, edge_weight), ...)`` for
    k = 10 then 5, exactly k neighbours per node, on ``device``."""
    sampler = graph.cache["sampler"]
    return tuple(tuple(torch.as_tensor(a, device=device)
                       for a in sampler.sample(k=k, padding=True))
                 for k in NUM_SAMPLED_NEIGHBORS)


class SageNet(nn.Module):
    """The demo's model; its layers carry the flax names
    (``MeanGraphSage_0``, ``MeanGraphSage_1``, ``Dense_0``:
    ``convert.pool_model_state_dict_from_flax``). Draws its dropout from a
    generator of its own unless ``keep_mask`` is given."""

    def __init__(self, in_features: int, num_classes: int, seed: int = 0, device="cuda"):
        super().__init__()
        self.MeanGraphSage_0 = MeanGraphSage(in_features, UNITS, device=device)
        self.MeanGraphSage_1 = MeanGraphSage(UNITS, UNITS, device=device)
        self.Dense_0 = nn.Linear(UNITS, num_classes, device=device)
        self.generator = dropout_generator(seed, device)
        init_like_flax(self, seed)

    def forward(self, x, edge_lists, keep_mask=None):
        h = x
        for i, (ei, ew) in enumerate(edge_lists):
            h = getattr(self, f"MeanGraphSage_{i}")([h, ei, ew])
        h = dropout(h, DROP_RATE, self.training, self.generator, keep_mask)
        return self.Dense_0(h)


def _tensors(graph, device):
    return (torch.as_tensor(np.asarray(graph.x, np.float32), device=device),
            torch.as_tensor(np.asarray(graph.y, np.float32), device=device))


def main(device="cuda", num_epochs: int = 8, stats: Optional[dict] = None):
    """Train on ``load_graphs``; returns the mean test micro-F1. ``stats``
    receives ``steps`` (one a training graph a epoch), ``losses`` and
    ``evals`` (the test graphs)."""
    train_graphs, valid_graphs, test_graphs = load_graphs()
    attach_samplers(train_graphs + valid_graphs + test_graphs)
    num_classes = np.asarray(train_graphs[0].y).shape[1]
    model = SageNet(np.asarray(train_graphs[0].x).shape[1], num_classes, device=device)
    # the flax model is initialized on a draw of the first graph: take it
    sample_edges(train_graphs[0], device)
    optimizer = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)
    losses = []
    for epoch in range(demo_steps(num_epochs)):
        epoch_losses = []
        for g in train_graphs:
            x, y = _tensors(g, device)
            model.train()
            optimizer.zero_grad(set_to_none=True)
            loss = F.binary_cross_entropy_with_logits(model(x, sample_edges(g, device)), y)
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
            epoch_losses.append(float(losses[-1]))
        print(f"epoch {epoch}: loss={np.mean(epoch_losses):.4f}")
    model.eval()
    f1s = []
    with torch.no_grad():
        for g in test_graphs:
            x, _ = _tensors(g, device)
            preds = (model(x, sample_edges(g, device)) > 0).cpu().numpy()
            f1s.append(micro_f1(preds, np.asarray(g.y)))
    f1 = float(np.mean(f1s))
    print(f"test micro-F1: {f1:.4f}")
    if stats is not None:
        stats.update(steps=len(losses), losses=losses, evals=len(test_graphs))
    return f1


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
