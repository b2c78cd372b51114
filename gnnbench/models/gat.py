"""The port's GAT configuration, built from its public API: two
``layers.GAT`` over the graph's cache (the attention layout is built at the
first forward and shared by both layers), ``layers.base.dropout`` on the
features and the hidden layer, and the first layer's attention dropout, all
by the step's keep masks; the attention in the configuration's dtype
(``ops.config.set_ell_compute_dtype``)."""
from __future__ import annotations

import torch
from torch import nn

from tf_geometric_tpu_torch import layers, ops
from tf_geometric_tpu_torch.layers.base import dropout

DTYPES = {"bfloat16": torch.bfloat16, "float32": None}
ACTIVATIONS = {"relu": torch.relu, None: None}


class Gat(nn.Module):
    def __init__(self, cfg: dict, graph: dict):
        super().__init__()
        x, c = graph["x"], graph["num_classes"]
        dev, out = x.device, cfg["output"]
        self.gat0 = layers.GAT(x.shape[1], cfg["units"], attention_units=cfg["attention_units"],
                               activation=ACTIVATIONS[cfg["activation"]],
                               num_heads=cfg["num_heads"], edge_drop_rate=cfg["edge_dropout"],
                               device=dev)
        self.gat1 = layers.GAT(cfg["units"], c, attention_units=c, num_heads=out["num_heads"],
                               edge_drop_rate=out["edge_dropout"], device=dev)
        self.input_rate, self.rate = cfg["input_dropout"], cfg["dropout"]
        self.edge_rates = (cfg["edge_dropout"], out["edge_dropout"])
        self.edge_index = graph["edge_index"]
        self.cache = {}

    def _edge_keep(self, masks, i):
        """The layer's attention keep mask as the port takes it: float, the
        1 / (1 - rate) scale included, rows in the layout's edge order."""
        keep = masks.get(f"edges{i}")
        return None if keep is None else keep.float() / (1.0 - self.edge_rates[i])

    def forward(self, x, masks):
        h = dropout(x, self.input_rate, True, keep_mask=masks.get("x"))
        h = self.gat0([h, self.edge_index], cache=self.cache, keep_mask=self._edge_keep(masks, 0))
        h = dropout(h, self.rate, True, keep_mask=masks.get("h0"))
        return self.gat1([h, self.edge_index], cache=self.cache,
                         keep_mask=self._edge_keep(masks, 1))


def build(cfg: dict, graph: dict, weights: dict):
    """The model with ``weights`` loaded, and its parameters by the
    reference's names."""
    ops.config.set_ell_compute_dtype(DTYPES[cfg["precision"]["aggregation"]])
    model = Gat(cfg, graph)
    leaves = {f"gat{i}.{name}": getattr(layer, name)
              for i, layer in enumerate((model.gat0, model.gat1))
              for name in ("query_kernel", "query_bias", "key_kernel", "key_bias", "kernel",
                           "bias")}
    with torch.no_grad():
        for name, p in leaves.items():
            p.copy_(weights[name])
    return model, leaves
