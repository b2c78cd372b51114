"""The least work of one step of the GCN configuration.

Aggregation passes (kind ``aggregation``): ``Â·h`` forward and ``Âᵀ·dy``
backward at each layer's width. ``Â`` has the distinct off-diagonal pairs of
the edge list and a full diagonal, so every row is read as a source and
written as an output; per pass the rows in the aggregation dtype, a column
index and a value per off-diagonal entry, a value per diagonal entry and a
row pointer per row. Dense products: ``h W`` forward, ``dh`` (all but the
first layer, whose input needs no gradient) and ``dW``. Batch
normalization, ReLU, dropout and the masks' draws are left out: the count
stays a lower bound.
"""
from __future__ import annotations

from gnnbench.harness.counts import ELEMENT_BYTES, adam, cross_entropy, gemm, op


def step_ops(cfg: dict, stats: dict, num_features: int, num_classes: int) -> list:
    n = stats["num_nodes"]
    agg = cfg["precision"]["aggregation"]
    nnz = stats["offdiag_pairs"] + n
    index_bytes = 8 * stats["offdiag_pairs"] + 4 * n + 4 * (n + 1)
    dims = [num_features] + [cfg["hidden"]] * (cfg["num_layers"] - 1) + [num_classes]

    def aggregation(name, width):
        rows = 2 * n * width * ELEMENT_BYTES[agg]
        return op(name, "aggregation", 2 * nnz * width, rows + index_bytes, agg)

    ops, params = [], 0
    for i, (a, b) in enumerate(zip(dims, dims[1:])):
        ops += [gemm(f"h_w{i}", n, a, b), aggregation(f"agg{i}", b),
                aggregation(f"agg{i}_dh", b), gemm(f"d_w{i}", a, n, b)]
        if i > 0:
            ops.append(gemm(f"d_h{i}", n, b, a))
        params += a * b + b + (2 * b if cfg["batch_norm"] and i < len(dims) - 2 else 0)
    return ops + [cross_entropy(n, num_classes), adam(params)]
