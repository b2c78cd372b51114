"""The work counts against a hand count on a 6-node graph."""
import pytest
import torch

from gnnbench.harness import counts, registry

# destination row 0, source row 1; a repeated edge (2 <- 0), a self-loop (3 <- 3)
EDGES = torch.tensor([[2, 2, 3, 4, 5, 0, 1],
                      [0, 0, 3, 1, 2, 5, 4]])
N, F, C = 6, 4, 3


def test_graph_stats():
    s = counts.graph_stats(EDGES, N)
    # distinct off-diagonal pairs: (2,0) (4,1) (5,2) (0,5) (1,4)
    assert s == {"num_nodes": 6, "num_edges": 7, "offdiag_pairs": 5}


def _by_name(ops):
    return {o["name"]: o for o in ops}


def test_gcn_counts_by_hand():
    cfg = {"hidden": 8, "num_layers": 3, "batch_norm": True,
           "precision": {"aggregation": "bfloat16"}}
    ops = _by_name(registry.load_module("counts", "gcn").step_ops(
        cfg, counts.graph_stats(EDGES, N), F, C))
    # Â: 5 off-diagonal entries and 6 diagonal ones
    index = 5 * 8 + 6 * 4 + 7 * 4
    assert ops["agg0"]["flops"] == 2 * 11 * 8
    assert ops["agg0"]["bytes"] == 2 * 6 * 8 * 2 + index
    assert ops["agg2_dh"]["bytes"] == 2 * 6 * 3 * 2 + index
    assert ops["h_w0"]["flops"] == 2 * 6 * 4 * 8
    assert ops["h_w0"]["bytes"] == 4 * (6 * 4 + 4 * 8 + 6 * 8)
    assert ops["d_w0"]["bytes"] == 4 * (4 * 6 + 6 * 8 + 4 * 8)
    assert ops["d_h2"]["bytes"] == 4 * (6 * 3 + 3 * 8 + 6 * 8)
    assert "d_h0" not in ops  # the features need no gradient
    # kernels and biases 4x8+8, 8x8+8, 8x3+3; batch norm's scale and shift 2x8 twice
    assert ops["adam"]["bytes"] == 28 * (40 + 72 + 27 + 2 * 16)
    assert ops["cross_entropy"]["bytes"] == 4 * 2 * 6 * 3 + 8 * 6
    assert len(ops) == 16


def test_gat_counts_by_hand():
    cfg = {"units": 8, "num_heads": 2, "attention_units": 8, "edge_dropout": 0.5,
           "output": {"num_heads": 1, "edge_dropout": 0.0},
           "precision": {"aggregation": "bfloat16"}}
    ops = _by_name(registry.load_module("counts", "gat").step_ops(
        cfg, counts.graph_stats(EDGES, N), F, C))
    entries = 7 + 6  # every edge, repeats too, and a self-loop per node
    index = 4 * entries + 4 * 7
    rows0, rows1 = 6 * 8 * 2, 6 * 3 * 2
    keep0 = 4 * entries * 2  # the first layer's float keep mask, an entry per edge and head
    assert ops["attention_fwd0"]["flops"] == 4 * entries * 8
    assert ops["attention_fwd0"]["bytes"] == 4 * rows0 + keep0 + index
    assert ops["attention_bwd0"]["flops"] == 8 * entries * 8
    assert ops["attention_bwd0"]["bytes"] == 7 * rows0 + keep0 + index
    assert ops["attention_fwd1"]["bytes"] == 4 * rows1 + index
    assert ops["attention_bwd1"]["bytes"] == 7 * rows1 + index
    assert "d_hq0" not in ops and ops["d_hv1"]["flops"] == 2 * 6 * 3 * 8
    assert ops["adam"]["bytes"] == 28 * ((3 * (4 * 8) + 3 * 8) + (3 * (8 * 3) + 3 * 3))


def test_least_seconds_is_the_larger_bound():
    flop_bound = counts.op("a", "dense", 67e12, 0, "float32")
    byte_bound = counts.op("b", "aggregation", 0, 3.35e12 * 2, "bfloat16")
    assert counts.least_seconds([flop_bound]) == pytest.approx(1.0)
    assert counts.least_seconds([flop_bound, byte_bound]) == pytest.approx(2.0)
