"""Two-layer GCN node classification (JAX counterpart: ``demo/demo_gcn.py``):
dropout 0.5, ``GCN(16, relu)``, dropout 0.5, ``GCN(num_classes)`` on the
cached normalized adjacency, masked softmax cross-entropy plus L2 5e-4 on
the kernels, Adam 1e-2; then the forward latency.

    python -m tf_geometric_tpu_torch.demos.demo_gcn            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_gcn --cpu

Each step launches Kernel A (``csrc/csr_spmm.cu``) four times on the card:
the forward and ``dh`` of each layer, at F = 16 and F = num_classes.
"""
from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..layers.base import dropout
from ..layers.conv.gcn import GCN
from .demo_utils import demo_steps, load_planetoid, train_node_classifier

__all__ = ["GCNModel", "build_model", "load_cora", "main"]

HIDDEN = 16
DROP_RATE = 0.5
LEARNING_RATE = 1e-2
L2_COEF = 5e-4


class GCNModel(nn.Module):
    """The demo's model; its layers carry the flax model's names (``GCN_0``,
    ``GCN_1``), so ``convert.gcn_state_dict_from_flax`` of the flax
    variables loads into it. ``keep_masks``: the two dropout masks (bool, x's
    and the hidden layer's shape) in place of draws."""

    def __init__(self, in_features: int, num_classes: int, drop_rate: float = DROP_RATE,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.drop_rate = drop_rate
        self.GCN_0 = GCN(in_features, HIDDEN, activation=torch.relu, generator=generator,
                         device=device)
        self.GCN_1 = GCN(HIDDEN, num_classes, generator=generator, device=device)

    def forward(self, x, adj, cache: dict, generator: Optional[torch.Generator] = None,
                keep_masks=(None, None)):
        x = dropout(x, self.drop_rate, self.training, generator, keep_masks[0])
        h = self.GCN_0([x, adj], cache=cache)
        h = dropout(h, self.drop_rate, self.training, generator, keep_masks[1])
        return self.GCN_1([h, adj], cache=cache)


def build_model(graph, num_classes: int, seed: int = 0, device="cuda"):
    """The model (glorot weights from ``seed``), the graph's adjacency on
    ``device`` and its normalization cache, built once."""
    model = GCNModel(graph.num_features, num_classes,
                     generator=torch.Generator().manual_seed(seed), device=device)
    model.GCN_0.build_cache_for_graph(graph, device=device)
    return model, graph.adj(device=device), graph.cache


def load_cora(device="cuda"):
    """Cora from its files, or the synthetic Cora-shaped set where they are
    not on disk. As the JAX demo's own loader, it reads no environment
    (``demo_utils.load_cora`` honours ``TFG_HARD_PROTOCOL`` and
    ``BENCH_DATASET``)."""
    return load_planetoid("cora", device=device, read_env=False)


def main(device="cuda", num_steps: int = 201, patience: Optional[int] = None):
    """Train on ``load_cora`` (real files or the synthetic fallback) and
    time the forward; returns the test accuracy."""
    graph, splits = load_cora(device=device)
    num_classes = int(graph.y.max()) + 1
    model, adj, cache = build_model(graph, num_classes, device=device)
    acc = train_node_classifier(
        lambda training, generator: model(graph.x, adj, cache, generator),
        model, graph.y, splits, num_steps=num_steps, learning_rate=LEARNING_RATE,
        l2_coef=L2_COEF, patience=patience)

    model.eval()
    iters = demo_steps(100)
    with torch.no_grad():
        model(graph.x, adj, cache)
        if graph.x.is_cuda:
            torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(iters):
            out = model(graph.x, adj, cache)
        float(out[0, 0])
    print(f"mean forward latency: {(time.perf_counter() - start) / iters * 1e3:.3f} ms "
          f"({np.prod(out.shape)} logits on {graph.x.device})")
    return acc


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
