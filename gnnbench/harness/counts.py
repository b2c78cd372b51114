"""The table of peaks and the arithmetic of a step's least work.

Peaks are NVIDIA's data-sheet figures for one H100 SXM at its 700 W limit
(dense, no sparsity). Each operation is charged at the peak of the dtype that
the configuration states for it. Bytes count each input row read once and
each output row written once, whatever a kernel reads again; for a sparse
pass they come from the graph's edge list (``graph_stats``), never from a
layout of the program, so the yardstick does not move when a layout does.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12, "float32": 67e12}
ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def op(name: str, kind: str, flops: float, bytes_: float, dtype: str) -> dict:
    return {"name": name, "kind": kind, "flops": float(flops), "bytes": float(bytes_),
            "dtype": dtype}


def gemm(name: str, m: int, k: int, n: int, dtype: str = "float32") -> dict:
    """``[m, k] @ [k, n]``: both operands read once, the product written once."""
    e = ELEMENT_BYTES[dtype]
    return op(name, "dense", 2 * m * k * n, e * (m * k + k * n + m * n), dtype)


def cross_entropy(num_rows: int, num_classes: int) -> dict:
    """Loss and its gradient fused: logits and labels read, the gradient written."""
    return op("cross_entropy", "loss", 8 * num_rows * num_classes,
              4 * 2 * num_rows * num_classes + 8 * num_rows, "float32")


def adam(num_params: int) -> dict:
    """Weight, gradient and both moments read; weight and moments written."""
    return op("adam", "optimizer", 12 * num_params, 28 * num_params, "float32")


def least_seconds(ops) -> float:
    """The least time of ``ops``: the larger of the operations' flops, each
    at its dtype's peak, and their bytes at the memory's rate."""
    flop_s = sum(o["flops"] / PEAK_FLOPS[o["dtype"]] for o in ops)
    byte_s = sum(o["bytes"] for o in ops) / HBM_BYTES_PER_S
    return max(flop_s, byte_s)


def graph_stats(edge_index, num_nodes: int) -> dict:
    """Counts of the edge list: its entries and its distinct off-diagonal
    (destination, source) pairs."""
    import torch
    dst, src = edge_index[0], edge_index[1]
    pairs = torch.unique(dst * num_nodes + src)
    offdiag = int(((pairs // num_nodes) != (pairs % num_nodes)).sum())
    return {"num_nodes": num_nodes, "num_edges": int(dst.shape[0]), "offdiag_pairs": offdiag}
