"""The port's GCN configuration, built from its public API: ``layers.GCN``
over the graph's normalization cache (the normalized adjacency is built at
set-up, its CSR layout at the first forward), ``torch.nn.BatchNorm1d``, ReLU
and ``layers.base.dropout`` by the step's keep masks after each hidden
layer; the aggregation in the configuration's dtype
(``ops.config.set_ell_compute_dtype``)."""
from __future__ import annotations

import torch
from torch import nn

from tf_geometric_tpu_torch import SparseMatrix, layers, ops
from tf_geometric_tpu_torch.layers.base import dropout

DTYPES = {"bfloat16": torch.bfloat16, "float32": None}


class Gcn(nn.Module):
    def __init__(self, cfg: dict, graph: dict):
        super().__init__()
        x, n = graph["x"], graph["num_nodes"]
        dev = x.device
        dims = [x.shape[1]] + [cfg["hidden"]] * (cfg["num_layers"] - 1) + [graph["num_classes"]]
        self.convs = nn.ModuleList(layers.GCN(a, b, device=dev) for a, b in zip(dims, dims[1:]))
        self.bns = nn.ModuleList(nn.BatchNorm1d(b, device=dev) for b in dims[1:-1]) \
            if cfg["batch_norm"] else None
        self.input_rate, self.rate = cfg["input_dropout"], cfg["dropout"]
        self.adj = SparseMatrix(graph["edge_index"], None, (n, n), device=dev)
        self.cache = {}
        self.convs[0].build_cache_by_adj(self.adj, cache=self.cache)

    def forward(self, x, masks):
        h = dropout(x, self.input_rate, True, keep_mask=masks.get("x"))
        for i, conv in enumerate(self.convs[:-1]):
            h = conv([h, self.adj], cache=self.cache)
            if self.bns is not None:
                h = self.bns[i](h)
            h = dropout(torch.relu(h), self.rate, True, keep_mask=masks.get(f"h{i}"))
        return self.convs[-1]([h, self.adj], cache=self.cache)


def build(cfg: dict, graph: dict, weights: dict):
    """The model with ``weights`` loaded, and its parameters by the
    reference's names."""
    ops.config.set_ell_compute_dtype(DTYPES[cfg["precision"]["aggregation"]])
    model = Gcn(cfg, graph)
    leaves = {}
    for i, conv in enumerate(model.convs):
        leaves[f"gcn{i}.kernel"], leaves[f"gcn{i}.bias"] = conv.kernel, conv.bias
        if model.bns is not None and i < len(model.bns):
            leaves[f"bn{i}.weight"], leaves[f"bn{i}.bias"] = model.bns[i].weight, model.bns[i].bias
    with torch.no_grad():
        for name, p in leaves.items():
            p.copy_(weights[name])
    return model, leaves
