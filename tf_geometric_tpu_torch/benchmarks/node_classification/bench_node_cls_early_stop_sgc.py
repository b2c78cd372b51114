"""Early-stop SGC node classification (JAX counterpart:
``benchmarks/node_classification/bench_node_cls_early_stop_sgc.py``):
``SGC(C, k=2)``, no dropout; Adam 0.2, patience 100; at most 60 steps on
pubmed, 100 on arxiv (evaluated every 2), else 200; L2 per dataset.

The two hops run on ``x W`` every step, as the JAX layer's do (nothing to
cache across steps): each training step launches Kernel A
(``csrc/csr_spmm.cu``) four times on the card (two forward hops, two
``dh``), an evaluation twice.
"""
from __future__ import annotations

import sys
from typing import Optional

import torch
from torch import nn

from ...layers.conv.propagation import SGC
from .early_stop import bench_dataset, main, run_twin

__all__ = ["protocol", "SGCModel", "build", "run"]

LEARNING_RATE = 0.2
K = 2


def protocol(dataset: Optional[str] = None) -> dict:
    """The script's constants for ``dataset`` (default ``BENCH_DATASET``)."""
    dataset = bench_dataset(dataset)
    return dict(max_steps={"pubmed": 60, "arxiv": 100}.get(dataset, 200),
                eval_every=2 if dataset == "arxiv" else 1,
                l2={"cora": 5e-6, "citeseer": 1e-4, "pubmed": 5e-5}.get(dataset, 5e-6))


class SGCModel(nn.Module):
    """The script's model; its layer carries the flax name (``SGC_0``:
    ``convert.propagation_state_dict_from_flax``)."""

    def __init__(self, in_features: int, num_classes: int,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.SGC_0 = SGC(in_features, num_classes, k=K, generator=generator, device=device)

    def forward(self, x, edge_index, edge_weight, cache: dict):
        return self.SGC_0([x, edge_index, edge_weight], cache=cache)


def build(graph, seed: int = 0, dataset: Optional[str] = None, device="cuda"):
    """``(model, forward(training, generator, masks=None))`` on ``graph``,
    the weights drawn from ``seed``."""
    model = SGCModel(graph.num_features, int(graph.y.max()) + 1,
                     generator=torch.Generator().manual_seed(seed), device=device)
    return model, (lambda training, gen, masks=None:
                   model(graph.x, graph.edge_index, graph.edge_weight, graph.cache))


def run(seed: int = 0, device="cuda", **kwargs) -> float:
    """One seed (``early_stop.run_twin``: ``dataset``, ``data``,
    ``state_dict``, ``keep_masks``, ``stats``); returns test@best."""
    return run_twin(sys.modules[__name__], seed, device, **kwargs)


if __name__ == "__main__":
    main(run, __file__)
