"""Early-stop GAT node classification (JAX counterpart:
``benchmarks/node_classification/bench_node_cls_early_stop_gat.py``):
Adam 5e-3, patience 100, at most 400 steps; dropout DROP and L2 per
dataset. Two architectures, with input dropout DROP before the first layer
and dropout DROP between the two:

- off pubmed: ``GAT(64, attention_units=8, heads=8, relu,
  edge_drop_rate=DROP)``, then ``GAT(C, attention_units=1,
  edge_drop_rate=DROP)``;
- on pubmed (DROP 0): a single-head encoder ``GAT(64, attention_units=1,
  relu)``, then an 8-head decoder ``GAT(C, attention_units=8, heads=8,
  split_value_heads=False)`` averaging its heads.

Every layer has a query head width (1) other than its value head width, so
each runs the merged-head branch of ``nn.conv.gat``: the scores and the
softmax in PyTorch, then the multi-head SpMM over the cached layout
(``csrc/spmm_heads.cu``). A training step launches, a layer, the SpMM for
the forward and for ``dV`` (two kernels each, ``spmm_heads_launches``) and
the SDDMM for the scores' gradient once; an evaluation, the forward SpMM.
"""
from __future__ import annotations

import sys
from typing import Optional

import torch
from torch import nn

from ...layers.base import dropout
from ...layers.conv.gat import GAT
from .early_stop import bench_dataset, main, run_twin

__all__ = ["protocol", "GATModel", "build", "run"]

LEARNING_RATE = 5e-3
MAX_STEPS = 400
UNITS = 64


def protocol(dataset: Optional[str] = None) -> dict:
    """The script's constants for ``dataset`` (default ``BENCH_DATASET``)."""
    dataset = bench_dataset(dataset)
    return dict(max_steps=MAX_STEPS, eval_every=1,
                drop={"cora": 0.7, "citeseer": 0.6, "pubmed": 0.0}.get(dataset, 0.6),
                l2={"cora": 1e-3, "citeseer": 2e-3, "pubmed": 2e-3}.get(dataset, 1e-3),
                single_head_encoder=dataset == "pubmed")


class GATModel(nn.Module):
    """The script's model (``single_head_encoder``: the pubmed
    architecture); its layers carry the flax names (``GAT_0``, ``GAT_1``:
    ``convert.gat_state_dict_from_flax``). ``masks``: x's dropout mask
    (bool), the first layer's attention keep mask ([E, H] float, scaled,
    in the cached layout's edge order), the hidden layer's mask (bool) and
    the second layer's attention mask, in place of draws."""

    def __init__(self, in_features: int, num_classes: int, drop: float,
                 single_head_encoder: bool, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.drop = drop
        if single_head_encoder:
            self.GAT_0 = GAT(in_features, UNITS, attention_units=1, num_heads=1,
                             activation=torch.relu, edge_drop_rate=drop, generator=generator,
                             device=device)
            self.GAT_1 = GAT(UNITS, num_classes, attention_units=8, num_heads=8,
                             split_value_heads=False, edge_drop_rate=drop, generator=generator,
                             device=device)
        else:
            self.GAT_0 = GAT(in_features, UNITS, attention_units=8, num_heads=8,
                             activation=torch.relu, edge_drop_rate=drop, generator=generator,
                             device=device)
            self.GAT_1 = GAT(UNITS, num_classes, attention_units=1, edge_drop_rate=drop,
                             generator=generator, device=device)

    def forward(self, x, edge_index, cache: dict, generator=None, masks=None):
        masks = masks or (None,) * 4
        x = dropout(x, self.drop, self.training, generator, masks[0])
        h = self.GAT_0([x, edge_index], cache=cache, generator=generator, keep_mask=masks[1])
        h = dropout(h, self.drop, self.training, generator, masks[2])
        return self.GAT_1([h, edge_index], cache=cache, generator=generator,
                          keep_mask=masks[3])


def build(graph, seed: int = 0, dataset: Optional[str] = None, device="cuda"):
    """``(model, forward(training, generator, masks=None))`` on ``graph``,
    the weights drawn from ``seed``."""
    proto = protocol(dataset)
    model = GATModel(graph.num_features, int(graph.y.max()) + 1, proto["drop"],
                     proto["single_head_encoder"],
                     generator=torch.Generator().manual_seed(seed), device=device)
    return model, (lambda training, gen, masks=None:
                   model(graph.x, graph.edge_index, graph.cache, gen, masks))


def run(seed: int = 0, device="cuda", **kwargs) -> float:
    """One seed (``early_stop.run_twin``: ``dataset``, ``data``,
    ``state_dict``, ``keep_masks``, ``stats``); returns test@best."""
    return run_twin(sys.modules[__name__], seed, device, **kwargs)


if __name__ == "__main__":
    main(run, __file__)
