"""The graph generator, at each traffic mix's stated shape: the same seed gives
the same graph bit for bit, another seed another graph, every drawn edge is
listed in both directions, and the in-degrees have the stated statistics
(mean 2E / N; the top row near E / √N, the share of ``u² < 1 / N``, plus the
E / N reverses of the edges it sends)."""
import math

import pytest
import torch

from gnnbench.harness import registry

SEED = 2 ** 31 + 12345  # larger than 32 signed bits hold


def _make(traffic, seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return registry.load_module("graphs", traffic["generator"]).make(traffic, gen, "cpu")


def _digest(graph):
    x = graph.pop("x")
    return graph, (x.shape, float(x.double().sum()), x[::997, ::7].clone())


@pytest.mark.parametrize("name", ["arxiv-full", "reddit-full"])
def test_generator_is_bit_for_bit_and_has_the_stated_shape(name):
    traffic = registry.load_json("traffic", name)
    n, e = traffic["num_nodes"], traffic["num_edges"]
    a, xa = _digest(_make(traffic, SEED))
    b, xb = _digest(_make(traffic, SEED))
    assert torch.equal(a["edge_index"], b["edge_index"]) and torch.equal(a["y"], b["y"])
    assert xa[0] == xb[0] == (n, traffic["num_features"]) and xa[1] == xb[1]
    assert torch.equal(xa[2], xb[2])
    assert traffic["symmetric"] is True
    assert a["edge_index"].shape == (2, 2 * e) and a["edge_index"].dtype == torch.int64
    assert torch.equal(a["edge_index"][:, e:], a["edge_index"][:, :e].flip(0))
    assert int(a["edge_index"].min()) >= 0 and int(a["edge_index"].max()) < n
    assert a["y"].shape == (n,) and int(a["y"].max()) < traffic["num_classes"]
    deg = torch.bincount(a["edge_index"][0], minlength=n)
    assert float(deg.float().mean()) == pytest.approx(2 * e / n)
    assert int(deg.max()) == int(deg[0]) == pytest.approx(e / math.sqrt(n) + e / n, rel=0.05)
    c = _make(traffic, SEED + 1)
    assert not torch.equal(c["edge_index"], a["edge_index"])
