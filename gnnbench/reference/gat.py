"""Plain reference of the GAT configuration (tf_geometric's GAT demo): two
multi-head graph attention layers with the library's dot-product scores,
dropout on the features, the hidden layer and the first layer's attention.

One layer with H heads, query width d_q and value width d_v per head:
``Q = relu(x Wq + bq)``, ``K = relu(x Wk + bk)``, ``V = x Wv``; the score of
edge ``r <- c`` is ``<Q[r], K[c]>_h / √d_q``; a softmax over the entries of
each destination row, every node's self-loop appended to the edge list (an
existing self-loop stays beside it, repeated edges stay apart); the weights
dropped by the keep mask; ``out[r] = Σ a·V[c]``, heads concatenated, plus
the layer's bias, then the layer's activation. The entries are ordered by
destination (a stable sort of the edge list with the loops appended), the
order of the attention keep mask's rows.
"""
from __future__ import annotations

import math

import torch

from gnnbench.reference._common import EdgeDot, EdgeSum, Precision, dropout, segment_softmax


def _layers(cfg: dict, num_features: int, num_classes: int) -> list:
    """Per layer: (input width, heads, attention units, units, edge dropout)."""
    out = cfg["output"]
    return [(num_features, cfg["num_heads"], cfg["attention_units"], cfg["units"],
             cfg["edge_dropout"]),
            (cfg["units"], out["num_heads"], num_classes, num_classes, out["edge_dropout"])]


def param_shapes(cfg: dict, num_features: int, num_classes: int) -> dict:
    shapes = {}
    for i, (fin, _, att, units, _) in enumerate(_layers(cfg, num_features, num_classes)):
        shapes.update({f"gat{i}.query_kernel": (fin, att), f"gat{i}.query_bias": (att,),
                       f"gat{i}.key_kernel": (fin, att), f"gat{i}.key_bias": (att,),
                       f"gat{i}.kernel": (fin, units), f"gat{i}.bias": (units,)})
    return shapes


def initial_values(name: str):
    return None


def dropouts(cfg: dict, num_nodes: int, num_features: int, num_classes: int,
             num_entries: int) -> dict:
    """The keep masks one step draws: name -> (shape, rate). ``num_entries``
    counts the edge list with the self-loops appended."""
    out = {}
    if cfg["input_dropout"] > 0:
        out["x"] = ((num_nodes, num_features), cfg["input_dropout"])
    for i, (_, heads, _, units, edge_rate) in enumerate(
            _layers(cfg, num_features, num_classes)):
        if edge_rate > 0:
            out[f"edges{i}"] = ((num_entries, heads), edge_rate)
        if i == 0 and cfg["dropout"] > 0:
            out["h0"] = ((num_nodes, units), cfg["dropout"])
    return out


def prepare(cfg: dict, edge_index, num_nodes: int) -> dict:
    loops = torch.arange(num_nodes, device=edge_index.device)
    dst = torch.cat([edge_index[0], loops])
    src = torch.cat([edge_index[1], loops])
    order = torch.sort(dst, stable=True).indices
    return {"dst": dst[order], "src": src[order], "num_nodes": num_nodes}


def _layer(graph, x, params, prefix, heads, att_units, keep, rate, activation, prec):
    dst, src, n = graph["dst"], graph["src"], graph["num_nodes"]
    q = prec.sparse_io(torch.relu(prec.mm(x, params[f"{prefix}.query_kernel"])
                                  + params[f"{prefix}.query_bias"]))
    k = prec.sparse_io(torch.relu(prec.mm(x, params[f"{prefix}.key_kernel"])
                                  + params[f"{prefix}.key_bias"]))
    v = prec.sparse_io(prec.mm(x, params[f"{prefix}.kernel"]))
    scores = EdgeDot.apply(q, k, dst, src, heads) / math.sqrt(att_units // heads)
    att = dropout(segment_softmax(scores, dst, n), keep, rate)
    h = prec.sparse_io(EdgeSum.apply(v, att, dst, src, n)) + params[f"{prefix}.bias"]
    return activation(h) if activation is not None else h


def forward(cfg: dict, graph: dict, x, params: dict, masks: dict, prec: Precision):
    layers = _layers(cfg, x.shape[1], params["gat1.bias"].shape[0])
    h = dropout(x, masks.get("x"), cfg["input_dropout"])
    (_, heads, att, _, rate), (_, heads1, att1, _, rate1) = layers
    h = _layer(graph, h, params, "gat0", heads, att, masks.get("edges0"), rate, torch.relu, prec)
    h = dropout(h, masks.get("h0"), cfg["dropout"])
    return _layer(graph, h, params, "gat1", heads1, att1, masks.get("edges1"), rate1, None, prec)
