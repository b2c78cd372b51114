"""Early-stop GCN node classification (JAX counterpart:
``benchmarks/node_classification/bench_node_cls_early_stop_gcn.py``):
dropout 0.5, ``GCN(HIDDEN, relu)``, dropout 0.5, ``GCN(C)``; Adam 1e-2,
L2 5e-4, patience 100; HIDDEN 16 and at most 400 steps with an evaluation
a step, or on arxiv 64 hidden units and 100 steps evaluated every 2.

Each training step launches Kernel A (``csrc/csr_spmm.cu``) four times on
the card (each layer's forward and ``dh``), an evaluation twice.
"""
from __future__ import annotations

import sys
from typing import Optional

import torch
from torch import nn

from ...layers.base import dropout
from ...layers.conv.gcn import GCN
from .early_stop import bench_dataset, main, run_twin

__all__ = ["protocol", "GCNModel", "build", "run"]

DROP_RATE = 0.5
LEARNING_RATE = 1e-2
L2_COEF = 5e-4


def protocol(dataset: Optional[str] = None) -> dict:
    """The script's constants for ``dataset`` (default ``BENCH_DATASET``)."""
    dataset = bench_dataset(dataset)
    return dict(max_steps=100 if dataset == "arxiv" else 400,
                eval_every=2 if dataset == "arxiv" else 1,
                hidden={"arxiv": 64}.get(dataset, 16), l2=L2_COEF)


class GCNModel(nn.Module):
    """The script's model; its layers carry the flax names (``GCN_0``,
    ``GCN_1``: ``convert.gcn_state_dict_from_flax``). ``masks``: x's and the
    hidden layer's dropout masks (bool), in place of draws."""

    def __init__(self, in_features: int, num_classes: int, hidden: int,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.GCN_0 = GCN(in_features, hidden, activation=torch.relu, generator=generator,
                         device=device)
        self.GCN_1 = GCN(hidden, num_classes, generator=generator, device=device)

    def forward(self, x, adj, cache: dict, generator=None, masks=None):
        masks = masks or (None, None)
        x = dropout(x, DROP_RATE, self.training, generator, masks[0])
        h = self.GCN_0([x, adj], cache=cache)
        h = dropout(h, DROP_RATE, self.training, generator, masks[1])
        return self.GCN_1([h, adj], cache=cache)


def build(graph, seed: int = 0, dataset: Optional[str] = None, device="cuda"):
    """``(model, forward(training, generator, masks=None))`` on ``graph``,
    the weights drawn from ``seed``."""
    model = GCNModel(graph.num_features, int(graph.y.max()) + 1, protocol(dataset)["hidden"],
                     generator=torch.Generator().manual_seed(seed), device=device)
    model.GCN_0.build_cache_for_graph(graph, device=device)
    adj, cache = graph.adj(device=device), graph.cache
    return model, (lambda training, gen, masks=None: model(graph.x, adj, cache, gen, masks))


def run(seed: int = 0, device="cuda", **kwargs) -> float:
    """One seed (``early_stop.run_twin``: ``dataset``, ``data``,
    ``state_dict``, ``keep_masks``, ``stats``); returns test@best."""
    return run_twin(sys.modules[__name__], seed, device, **kwargs)


if __name__ == "__main__":
    main(run, __file__)
