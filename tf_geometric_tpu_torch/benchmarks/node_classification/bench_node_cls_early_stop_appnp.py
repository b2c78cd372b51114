"""Early-stop APPNP node classification (JAX counterpart:
``benchmarks/node_classification/bench_node_cls_early_stop_appnp.py``):
``APPNP([64, C], k=10, alpha=0.1, dense_drop_rate=0.5,
edge_drop_rate=0.5)``; Adam 5e-3, patience 100; L2 3e-3 and 200 steps on
pubmed, else 1e-3 and 400.

The edge dropout drops the cached CSR's values every step
(``nn.conv.gcn.compile_and_dropout``), so each of the ten hops runs Kernel
A (``csrc/csr_spmm.cu``) forward and ``dh``: twenty launches a training
step on the card, ten an evaluation.
"""
from __future__ import annotations

import sys
from typing import Optional

import torch
from torch import nn

from ...layers.conv.propagation import APPNP
from .early_stop import bench_dataset, main, run_twin

__all__ = ["protocol", "APPNPModel", "build", "run", "UNITS", "K", "ALPHA", "DROP_RATE"]

UNITS = 64
K, ALPHA, DROP_RATE = 10, 0.1, 0.5
LEARNING_RATE = 5e-3


def protocol(dataset: Optional[str] = None) -> dict:
    """The script's constants for ``dataset`` (default ``BENCH_DATASET``)."""
    dataset = bench_dataset(dataset)
    return dict(max_steps=200 if dataset == "pubmed" else 400, eval_every=1,
                l2=3e-3 if dataset == "pubmed" else 1e-3)


class APPNPModel(nn.Module):
    """The script's model; its layer carries the flax name (``APPNP_0``:
    ``convert.propagation_state_dict_from_flax``). ``masks``: the edge keep
    mask over the normalized adjacency's values (bool [E + N]) and the
    first dense layer's mask (bool [N, 64]), in place of draws."""

    def __init__(self, in_features: int, num_classes: int,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.APPNP_0 = APPNP(in_features, [UNITS, num_classes], k=K, alpha=ALPHA,
                             dense_drop_rate=DROP_RATE, edge_drop_rate=DROP_RATE,
                             generator=generator, device=device)

    def forward(self, x, edge_index, edge_weight, cache: dict, generator=None, masks=None):
        edge, dense = masks if masks is not None else (None, None)
        return self.APPNP_0([x, edge_index, edge_weight], cache=cache, generator=generator,
                            edge_keep_mask=edge,
                            dense_keep_masks=None if dense is None else [dense, None])


def build(graph, seed: int = 0, dataset: Optional[str] = None, device="cuda"):
    """``(model, forward(training, generator, masks=None))`` on ``graph``,
    the weights drawn from ``seed``."""
    model = APPNPModel(graph.num_features, int(graph.y.max()) + 1,
                     generator=torch.Generator().manual_seed(seed), device=device)
    return model, (lambda training, gen, masks=None:
                   model(graph.x, graph.edge_index, graph.edge_weight, graph.cache, gen, masks))


def run(seed: int = 0, device="cuda", **kwargs) -> float:
    """One seed (``early_stop.run_twin``: ``dataset``, ``data``,
    ``state_dict``, ``keep_masks``, ``stats``); returns test@best."""
    return run_twin(sys.modules[__name__], seed, device, **kwargs)


if __name__ == "__main__":
    main(run, __file__)
