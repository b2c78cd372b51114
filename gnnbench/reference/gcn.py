"""Plain reference of the GCN configuration (OGB's ogbn-arxiv GCN baseline):
for each hidden layer ``h = dropout(relu(bn(Â·h W + b)))``, then
``logits = Â·h W + b``, with ``Â = D^-1/2 (A + I) D^-1/2``, where A counts
every entry of the edge list (repeated entries add up, an existing self-loop
stays beside the added one) and D is the row sum of ``A + I``. Batch
normalization in training mode; dropout by the keep masks the harness drew.
"""
from __future__ import annotations

import torch

from gnnbench.reference._common import EdgeSum, Precision, batch_norm, dropout


def _dims(cfg: dict, num_features: int, num_classes: int) -> list:
    return [num_features] + [cfg["hidden"]] * (cfg["num_layers"] - 1) + [num_classes]


def param_shapes(cfg: dict, num_features: int, num_classes: int) -> dict:
    dims, shapes = _dims(cfg, num_features, num_classes), {}
    for i, (a, b) in enumerate(zip(dims, dims[1:])):
        shapes[f"gcn{i}.kernel"], shapes[f"gcn{i}.bias"] = (a, b), (b,)
        if cfg["batch_norm"] and i < cfg["num_layers"] - 1:
            shapes[f"bn{i}.weight"], shapes[f"bn{i}.bias"] = (b,), (b,)
    return shapes


def initial_values(name: str):
    """A leaf that does not start glorot-uniform or zero: batch norm's scale."""
    return 1.0 if name.startswith("bn") and name.endswith(".weight") else None


def dropouts(cfg: dict, num_nodes: int, num_features: int, num_classes: int,
             num_entries: int) -> dict:
    """The keep masks one step draws: name -> (shape, rate)."""
    out = {}
    if cfg["input_dropout"] > 0:
        out["x"] = ((num_nodes, num_features), cfg["input_dropout"])
    if cfg["dropout"] > 0:
        for i in range(cfg["num_layers"] - 1):
            out[f"h{i}"] = ((num_nodes, cfg["hidden"]), cfg["dropout"])
    return out


def prepare(cfg: dict, edge_index, num_nodes: int) -> dict:
    """Â as an edge list with the self-loops appended, and its values."""
    loops = torch.arange(num_nodes, device=edge_index.device)
    dst = torch.cat([edge_index[0], loops])
    src = torch.cat([edge_index[1], loops])
    deg = torch.bincount(dst, minlength=num_nodes).float()
    inv_sqrt = deg.rsqrt()
    return {"dst": dst, "src": src, "w": (inv_sqrt[dst] * inv_sqrt[src])[:, None],
            "num_nodes": num_nodes}


def forward(cfg: dict, graph: dict, x, params: dict, masks: dict, prec: Precision):
    def aggregate(h):
        w = graph["w"].to(h.dtype)
        out = EdgeSum.apply(prec.sparse_io(h), w, graph["dst"], graph["src"], graph["num_nodes"])
        return prec.sparse_io(out)

    h = dropout(x, masks.get("x"), cfg["input_dropout"])
    last = cfg["num_layers"] - 1
    for i in range(last):
        h = aggregate(prec.mm(h, params[f"gcn{i}.kernel"])) + params[f"gcn{i}.bias"]
        if cfg["batch_norm"]:
            h = batch_norm(h, params[f"bn{i}.weight"], params[f"bn{i}.bias"])
        h = dropout(torch.relu(h), masks.get(f"h{i}"), cfg["dropout"])
    return aggregate(prec.mm(h, params[f"gcn{last}.kernel"])) + params[f"gcn{last}.bias"]
