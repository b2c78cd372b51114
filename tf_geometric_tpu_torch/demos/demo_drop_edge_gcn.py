"""DropEdge and a deep GCN (JAX counterpart: ``demo/demo_drop_edge_gcn.py``):
``DropEdge(rate=0.5, num_nodes)``, then seven ``GCN(128, relu)`` each
followed by dropout 0.5, then ``GCN(C)``; the masked loss with L2 5e-4,
Adam 1e-2, 400 steps; then the forward latency in eval mode.

    python -m tf_geometric_tpu_torch.demos.demo_drop_edge_gcn            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_drop_edge_gcn --cpu

There is no cache: every GCN normalizes the graph it is given, the dropped
edges pointing at the sink row ``num_nodes`` (out of range, so every
segment op and SpMM drops them), and multiplies by the COO SpMM
(``csrc/spmm_heads.cu``, X6), whose views are sorted anew each call: a
training step runs the forward and ``dh`` of each of the eight layers, at
F = 128 and F = C.
"""
from __future__ import annotations

import sys
import time
from typing import Optional

import torch
from torch import nn

from ..layers.base import dropout
from ..layers.conv.gcn import GCN
from ..layers.sampling.drop_edge import DropEdge
from .demo_utils import demo_steps, load_cora, train_node_classifier

__all__ = ["DropEdgeGCNModel", "build_model", "forward_latency", "main", "NUM_LAYERS",
           "HIDDEN", "DROP_RATE", "LATENCY_ITERS"]

NUM_LAYERS, HIDDEN = 8, 128
DROP_RATE = 0.5
LATENCY_ITERS = 100


class DropEdgeGCNModel(nn.Module):
    """The demo's model; its layers carry the flax names (``GCN_0`` to
    ``GCN_7``: ``convert.gcn_state_dict_from_flax``). ``keep_masks``: the
    edge keep mask (bool [E]) and the seven dropout masks (bool [N, 128]),
    in place of draws, in the order the flax model draws them."""

    def __init__(self, in_features: int, num_classes: int, num_nodes: int,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.DropEdge_0 = DropEdge(rate=DROP_RATE, num_nodes=num_nodes)
        widths = [in_features] + [HIDDEN] * (NUM_LAYERS - 1)
        for i, width in enumerate(widths):
            last = i == NUM_LAYERS - 1
            self.add_module(f"GCN_{i}", GCN(width, num_classes if last else HIDDEN,
                                            activation=None if last else torch.relu,
                                            generator=generator, device=device))

    def forward(self, x, edge_index, edge_weight, generator=None, keep_masks=None):
        edge_mask, masks = keep_masks if keep_masks is not None else (None, None)
        masks = masks if masks is not None else [None] * (NUM_LAYERS - 1)
        edge_index, edge_weight = self.DropEdge_0([edge_index, edge_weight], generator=generator,
                                                 keep_mask=edge_mask)
        h = x
        for i in range(NUM_LAYERS - 1):
            h = getattr(self, f"GCN_{i}")([h, edge_index, edge_weight])
            h = dropout(h, DROP_RATE, self.training, generator, masks[i])
        return getattr(self, f"GCN_{NUM_LAYERS - 1}")([h, edge_index, edge_weight])


def build_model(graph, num_classes: int, seed: int = 0, device="cuda"):
    """The model (glorot kernels from ``seed``) and its ``forward(training,
    generator, masks=None)`` on ``graph``."""
    model = DropEdgeGCNModel(graph.num_features, num_classes, graph.num_nodes,
                             generator=torch.Generator().manual_seed(seed), device=device)
    return model, (lambda training, generator, masks=None:
                   model(graph.x, graph.edge_index, graph.edge_weight, generator, masks))


def forward_latency(model, graph, iters: int) -> float:
    """Mean ms of an eval-mode forward over ``iters`` calls after one
    warm-up call: CUDA events on the card, the host clock on the CPU."""
    model.eval()
    with torch.no_grad():
        model(graph.x, graph.edge_index, graph.edge_weight)
        if graph.x.is_cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            for _ in range(iters):
                model(graph.x, graph.edge_index, graph.edge_weight)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            model(graph.x, graph.edge_index, graph.edge_weight)
        return (time.perf_counter() - t0) / iters * 1e3


def _device_label(device) -> str:
    if str(device).startswith("cuda"):
        from ..benchmarks.node_classification.head_to_head_port import card_label
        return card_label(device)
    return str(device)


def main(device="cuda", num_steps: int = 400, stats: Optional[dict] = None):
    """Train on ``load_cora``, then time the eval-mode forward
    (``forward_latency``, ``demo_steps(100)`` calls); returns the test
    accuracy. ``stats`` also receives ``latency_ms`` and, in ``evals``, the
    latency test's forwards."""
    graph, splits = load_cora(device=device)
    model, forward = build_model(graph, int(graph.y.max()) + 1, device=device)
    stats = {} if stats is None else stats
    acc = train_node_classifier(forward, model, graph.y, splits, num_steps=num_steps,
                                stats=stats)
    iters = demo_steps(LATENCY_ITERS)
    ms = forward_latency(model, graph, iters)
    stats.update(latency_ms=ms, evals=stats["evals"] + iters + 1)
    print(f"mean forward latency ({NUM_LAYERS}x{HIDDEN} GCN): {ms:.3f} ms "
          f"({_device_label(device)})")
    return acc


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
