"""Graph with squared-uniform destinations and uniform sources.

The rule of the port's ``synthetic_ogbn_arxiv_like`` (copied, not imported):
each drawn edge's destination is ``floor(u**2 · N)`` for a uniform ``u``, so
low node ids collect heavy in-degree (a few hub rows), and its source is
uniform. With ``"symmetric": true`` every drawn edge is listed in both
directions (the drawn ones first, then their reverses), as a graph made
symmetric for training is: ``num_edges`` counts the drawn (undirected) edges.
Repeated pairs stay entries of their own. Features are standard normal,
labels uniform over the classes. Everything is drawn on ``device`` from one
``torch.Generator``, in a few large calls, so the same seed on the same
device gives the same graph bit for bit.

Row 0 of ``edge_index`` is the destination, row 1 the source, as in the
port's ``Graph``: the aggregation sums sources into destinations.
"""
from __future__ import annotations

import torch


def make(params: dict, generator: torch.Generator, device) -> dict:
    n, e = int(params["num_nodes"]), int(params["num_edges"])
    f, c = int(params["num_features"]), int(params["num_classes"])
    u = torch.rand(e, generator=generator, device=device, dtype=torch.float64)
    dst = (u * u * n).long().clamp_(max=n - 1)
    del u
    src = torch.randint(0, n, (e,), generator=generator, device=device)
    x = torch.randn(n, f, generator=generator, device=device)
    y = torch.randint(0, c, (n,), generator=generator, device=device)
    if params.get("symmetric", False):
        dst, src = torch.cat([dst, src]), torch.cat([src, dst])
    return {"edge_index": torch.stack([dst, src]), "x": x, "y": y,
            "num_nodes": n, "num_classes": c}
