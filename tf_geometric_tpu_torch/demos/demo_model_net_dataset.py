"""Mesh-graph classification on ModelNet10 (JAX counterpart:
``demo/demo_model_net_dataset.py``): ``datasets.ModelNet10Dataset`` with its
official train/test split where its files are on disk, else 300 synthetic
meshes (chain or fan triangulations of 12-23 vertices with 3 normal
features, 2 classes, drawn from ``default_rng(0)`` as the script draws
them); ``demo_mean_pool.MeanPoolNetwork`` trained through
``demo_utils.run_graph_classification`` in padded batches of 16 graphs,
Adam 5e-3, 200 steps. Returns the test accuracy.

    python -m tf_geometric_tpu_torch.demos.demo_model_net_dataset            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_model_net_dataset --cpu

The fallback is taken on ``OSError`` (no files) only; the JAX script takes
it on any exception, which would also hide a broken file. The graphs are
handed to the loop as its ``data`` argument, where the script swaps
``demo_utils``' loader for the run. On the card each step launches the COO
SpMM (``csrc/spmm_heads.cu``, X6) for the forward and ``dh`` of both GCNs
(F = 64 and 32), two launches a call.
"""
from __future__ import annotations

import sys
from typing import Optional

import numpy as np

from ..data.graph import Graph
from .demo_mean_pool import MeanPoolNetwork
from .demo_utils import run_graph_classification

__all__ = ["load_model_net_graphs", "synthetic_meshes", "main", "BATCH_SIZE", "NUM_STEPS"]

BATCH_SIZE = 16
NUM_STEPS = 200


def synthetic_meshes(num_graphs: int = 300, seed: int = 0):
    """The script's fallback meshes: per graph a label (0: a chain of
    triangles, 1: a fan around vertex 0), 12-23 vertices, the triangles'
    edges both ways, normal features [n, 3]; all drawn from
    ``default_rng(seed)`` in the script's order."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(num_graphs):
        label = int(rng.integers(0, 2))
        n = int(rng.integers(12, 24))
        first = np.arange(n - 2) if label == 0 else np.zeros(n - 2, np.int64)
        tri = np.stack([first, np.arange(1, n - 1), np.arange(2, n)], axis=1)
        edges = np.concatenate([tri[:, :2], tri[:, 1:], tri[:, ::2]], axis=0)
        ei = np.concatenate([edges.T, edges.T[::-1]], axis=1).astype(np.int32)
        x = rng.normal(size=(n, 3)).astype(np.float32)
        graphs.append(Graph(x=x, edge_index=ei, y=[label]))
    return graphs


def load_model_net_graphs():
    """``(graphs, num_classes, split)``: ModelNet10's graphs (features as
    float32) with its official ``(train, test)`` split, or the synthetic
    meshes and None (a 90/10 split is drawn by the loop)."""
    from ..datasets.model_net import ModelNet10Dataset
    try:
        train_graphs, test_graphs, label_names = ModelNet10Dataset().load_data()
    except OSError:
        print("ModelNet10 unavailable — synthesizing mesh-like graphs")
        return synthetic_meshes(), 2, None
    for g in train_graphs + test_graphs:
        g.x = np.asarray(g.x, np.float32)
    return train_graphs + test_graphs, len(label_names), (train_graphs, test_graphs)


def main(num_steps: int = NUM_STEPS, device="cuda", stats: Optional[dict] = None):
    """Train on the meshes; returns the test accuracy (``stats`` as
    ``run_graph_classification``'s)."""
    graphs, num_classes, split = load_model_net_graphs()
    in_features = graphs[0].x.shape[1]
    return run_graph_classification(
        lambda c, g: MeanPoolNetwork(in_features, c, g, device=device), batch_size=BATCH_SIZE,
        num_steps=num_steps, split=split, device=device, stats=stats,
        data=(graphs, num_classes))


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
