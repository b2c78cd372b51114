"""The least work of one step of the GraphSAGE configuration.

Per layer of input width F, fanout k and half width u (self and neighbour
projections of u each, concatenated): dense products ``h Ws`` and ``h Wn``
forward, their ``dW``, and ``dh`` of both into all but the first layer
(whose input needs no gradient); the head ``h Wd``, its ``dW`` and ``dh``.
Fixed-k aggregation (kind ``fixed_k``), forward and backward: the table of
N rows at the gathered width (u where the neighbour kernel narrows the
features, the layer's F otherwise) read once and N rows written once, in
the aggregation dtype, plus an index and a weight per slot (k·N·(4 + 4)
bytes); a multiply-add per slot and feature. The draw (kind ``sampling``):
k·N random int32 read, k·N indices and weights written, each row's degree
and start read, and one column entry read per slot. Every count comes from
the node count and the configuration, never from a layout of the program.
"""
from __future__ import annotations

from gnnbench.harness.counts import ELEMENT_BYTES, adam, cross_entropy, gemm, op


def step_ops(cfg: dict, stats: dict, num_features: int, num_classes: int) -> list:
    n = stats["num_nodes"]
    agg = cfg["precision"]["aggregation"]
    half = cfg["units"] // 2
    dims = [num_features] + [cfg["units"]] * len(cfg["fanouts"])

    def fixed_k(name, k, width):
        return op(name, "fixed_k", 2 * k * n * width,
                  2 * n * width * ELEMENT_BYTES[agg] + 8 * k * n, agg)

    ops, params = [], 0
    for i, (fin, k) in enumerate(zip(dims, cfg["fanouts"])):
        width = min(half, fin)
        ops += [op(f"draw{i}", "sampling", 0, 16 * k * n + 8 * n, "float32"),
                gemm(f"h_ws{i}", n, fin, half), gemm(f"h_wn{i}", n, fin, half),
                fixed_k(f"gather{i}", k, width), fixed_k(f"gather{i}_dsrc", k, width),
                gemm(f"d_ws{i}", fin, n, half), gemm(f"d_wn{i}", fin, n, half)]
        if i > 0:
            ops += [gemm(f"d_hs{i}", n, half, fin), gemm(f"d_hn{i}", n, half, fin)]
        params += 2 * fin * half
    units = dims[-1]
    ops += [gemm("h_wd", n, units, num_classes), gemm("d_wd", units, n, num_classes),
            gemm("d_hd", n, num_classes, units)]
    params += units * num_classes
    return ops + [cross_entropy(n, num_classes), adam(params)]
