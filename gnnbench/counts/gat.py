"""The least work of one step of the GAT configuration.

Attention (kind ``attention``), per layer of H heads at query width d_q and
value width d_v: the edge list with every node's self-loop appended, each
entry scored and weighted (repeated edges are entries of their own in the
softmax). Forward: Q, K and V rows read once, the output written once,
2·d_q + 2·d_v flops per entry and head; where the layer drops attention
weights, its keep mask (float32, an entry per edge and head) read once.
Backward: Q, K, V and the output's gradient read once, dQ, dK and dV written
once, twice the forward's flops, the keep mask read once. Each direction
reads a source index per entry and a row pointer per row. Dense products:
Q, K and V forward, their ``dW``, and ``dh`` into all but the first layer.
Dropout, activations and the masks' draws are left out: the count stays a
lower bound.
"""
from __future__ import annotations

from gnnbench.harness.counts import ELEMENT_BYTES, adam, cross_entropy, gemm, op


def step_ops(cfg: dict, stats: dict, num_features: int, num_classes: int) -> list:
    n = stats["num_nodes"]
    att = cfg["precision"]["aggregation"]
    e = ELEMENT_BYTES[att]
    entries = stats["num_edges"] + n
    index_bytes = 4 * entries + 4 * (n + 1)
    out = cfg["output"]
    layers = [(num_features, cfg["num_heads"], cfg["attention_units"], cfg["units"],
               cfg["edge_dropout"]),
              (cfg["units"], out["num_heads"], num_classes, num_classes, out["edge_dropout"])]
    ops, params = [], 0
    for i, (fin, heads, qw, vw, rate) in enumerate(layers):
        keep = 4 * entries * heads if rate > 0 else 0
        qk_rows, v_rows = n * qw * e, n * vw * e
        ops += [gemm(f"x_w{p}{i}", n, fin, w) for p, w in (("q", qw), ("k", qw), ("v", vw))]
        ops += [op(f"attention_fwd{i}", "attention", 2 * entries * (qw + vw),
                   2 * qk_rows + 2 * v_rows + keep + index_bytes, att),
                op(f"attention_bwd{i}", "attention", 4 * entries * (qw + vw),
                   4 * qk_rows + 3 * v_rows + keep + index_bytes, att)]
        ops += [gemm(f"d_w{p}{i}", fin, n, w) for p, w in (("q", qw), ("k", qw), ("v", vw))]
        if i > 0:
            ops += [gemm(f"d_h{p}{i}", n, w, fin) for p, w in (("q", qw), ("k", qw), ("v", vw))]
        params += fin * (2 * qw + vw) + 2 * qw + vw
    return ops + [cross_entropy(n, num_classes), adam(params)]
