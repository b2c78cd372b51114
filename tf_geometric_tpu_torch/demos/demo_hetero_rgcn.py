"""Heterogeneous node classification, R-GCN style (JAX counterpart:
``demo/demo_hetero_rgcn.py``): two ``hetero_gcn_layer``s over a
``HeteroGraph`` (per relation and its reverse, a mean over the edge list
projected by the relation's kernel, added to each type's self projection,
relu), a head on the target type; numpy-initialized weights (normals of
scale 0.2 from ``default_rng(0)``), the softmax cross-entropy over the
training nodes, Adam 5e-3, 200 steps.

    python -m tf_geometric_tpu_torch.demos.demo_hetero_rgcn            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_hetero_rgcn --cpu

``load_data`` reads NARS ACM from its files, or synthesizes the academic
``HeteroGraph`` (600 papers, 300 authors, 30 fields) from
``default_rng(0)`` where they are not on disk, bit for bit with the JAX
demo's. The layers run the segment core (gather, ``segment_mean``): no
hand-written kernel is on this path.
"""
from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.graph import HeteroGraph
from ..nn.kernel.segment import segment_mean
from .demo_utils import demo_steps

__all__ = ["load_data", "hetero_gcn_layer", "HeteroParams", "HeteroProblem", "forward", "main",
           "HIDDEN", "LEARNING_RATE", "INIT_SCALE"]

HIDDEN, LEARNING_RATE, INIT_SCALE = 32, 5e-3, 0.2


def _synthetic_academic():
    rng = np.random.default_rng(0)
    n_paper, n_author, n_field = 600, 300, 30
    y = rng.integers(0, 3, n_paper)
    # papers fall into their class's cluster of fields
    pf_f = (y * 10 + rng.integers(0, 10, n_paper)).astype(np.int64)
    pf = np.stack([np.arange(n_paper), pf_f])
    pa = np.stack([rng.integers(0, n_paper, 1200),
                   rng.integers(0, n_author, 1200)]).astype(np.int64)
    x_paper = np.eye(3)[y] + rng.normal(scale=1.0, size=(n_paper, 3))
    hg = HeteroGraph(
        x_dict={"paper": x_paper.astype(np.float32),
                "author": np.zeros((n_author, 1), np.float32),
                "field": np.zeros((n_field, 1), np.float32)},
        edge_index_dict={("paper", "pa", "author"): pa, ("paper", "pf", "field"): pf},
        y_dict={"paper": y.astype(np.int64)})
    idx = rng.permutation(n_paper)
    return hg, "paper", (idx[:n_paper // 5], idx[n_paper // 5:n_paper // 3], idx[n_paper // 3:])


def load_data():
    """``(hetero_graph, target_type, (train, valid, test))``: NARS ACM from
    its files, or the synthetic academic graph where they are not on disk
    (the loader's ``OSError``; any other failure propagates)."""
    from ..datasets import NARSACMDataset
    try:
        return NARSACMDataset().load_data()
    except OSError:
        print("NARS ACM unavailable: synthesizing the academic HeteroGraph")
        return _synthetic_academic()


def hetero_gcn_layer(params, h_dict, edge_index_dict, num_nodes_dict, prefix: str):
    """One relational layer: for each edge type (src, rel, dst), the mean of
    the src rows over each dst (and of the dst rows over each src, the
    reverse), projected by ``{prefix}_rel_{rel}`` (``_rev_``) and added to
    the type's self projection ``{prefix}_self_{type}``; relu. ``params``
    maps names to tensors, ``edge_index_dict`` types to [2, E] long
    tensors."""
    out = {t: h_dict[t] @ params[f"{prefix}_self_{t}"] for t in h_dict}
    for (src, rel, dst), ei in edge_index_dict.items():
        msg = segment_mean(h_dict[src][ei[0].clamp(0, num_nodes_dict[src] - 1)], ei[1],
                           num_nodes_dict[dst])
        out[dst] = out[dst] + msg @ params[f"{prefix}_rel_{rel}"]
        rmsg = segment_mean(h_dict[dst][ei[1].clamp(0, num_nodes_dict[dst] - 1)], ei[0],
                            num_nodes_dict[src])
        out[src] = out[src] + rmsg @ params[f"{prefix}_rev_{rel}"]
    return {t: torch.relu(v) for t, v in out.items()}


class HeteroParams(nn.Module):
    """The demo's parameters, drawn in the JAX demo's order from
    ``default_rng(seed)``: per node type ``l0_self_*`` [F_t, 32] and
    ``l1_self_*`` [32, 32]; per edge type ``l0_rel_*`` [F_src, 32],
    ``l0_rev_*`` [F_dst, 32], ``l1_rel_*`` and ``l1_rev_*`` [32, 32]; then
    ``head`` [32, C]. ``self.params`` maps the names to the tensors."""

    def __init__(self, hg: HeteroGraph, num_classes: int, seed: int = 0, device="cuda"):
        super().__init__()
        rng = np.random.default_rng(seed)
        dims = {t: hg.x_dict[t].shape[1] for t in hg.node_types}
        shapes = {}
        for t in hg.node_types:
            shapes[f"l0_self_{t}"], shapes[f"l1_self_{t}"] = (dims[t], HIDDEN), (HIDDEN, HIDDEN)
        for (src, rel, dst) in hg.edge_types:
            shapes[f"l0_rel_{rel}"], shapes[f"l0_rev_{rel}"] = (dims[src], HIDDEN), (dims[dst],
                                                                                      HIDDEN)
            shapes[f"l1_rel_{rel}"], shapes[f"l1_rev_{rel}"] = (HIDDEN, HIDDEN), (HIDDEN, HIDDEN)
        shapes["head"] = (HIDDEN, num_classes)
        self.params = nn.ParameterDict({
            name: nn.Parameter(torch.tensor(rng.normal(scale=INIT_SCALE, size=shape),
                                            dtype=torch.float32, device=device))
            for name, shape in shapes.items()})


class HeteroProblem:
    """The graph's features, edge lists, labels and splits on ``device``."""

    def __init__(self, hg: HeteroGraph, target: str, splits, device="cuda"):
        self.target = target
        self.num_nodes = {t: hg.num_nodes_of(t) for t in hg.node_types}
        self.num_classes = int(np.max(hg.y_dict[target])) + 1
        self.x_dict = {t: torch.as_tensor(np.asarray(hg.x_dict[t], np.float32), device=device)
                       for t in hg.node_types}
        self.ei_dict = {t: torch.as_tensor(np.asarray(v, np.int64), device=device)
                        for t, v in hg.edge_index_dict.items()}
        self.y = torch.as_tensor(np.asarray(hg.y_dict[target], np.int64), device=device)
        self.train_index, self.valid_index, self.test_index = (
            torch.as_tensor(np.asarray(s, np.int64), device=device) for s in splits)


def forward(p: HeteroParams, problem: HeteroProblem):
    """The target type's logits."""
    h = hetero_gcn_layer(p.params, problem.x_dict, problem.ei_dict, problem.num_nodes, "l0")
    h = hetero_gcn_layer(p.params, h, problem.ei_dict, problem.num_nodes, "l1")
    return h[problem.target] @ p.params["head"]


def train_step(p, optimizer, problem: HeteroProblem):
    """One Adam step on the training nodes' mean cross-entropy; returns the
    loss (detached)."""
    optimizer.zero_grad(set_to_none=True)
    logits = forward(p, problem)
    loss = F.cross_entropy(logits[problem.train_index], problem.y[problem.train_index])
    loss.backward()
    optimizer.step()
    return loss.detach()


def main(device="cuda", num_steps: int = 200, stats: Optional[dict] = None):
    """Train on ``load_data``; returns the test accuracy on the target
    type. ``stats`` receives ``steps``, ``losses`` and ``evals`` (1)."""
    hg, target, splits = load_data()
    problem = HeteroProblem(hg, target, splits, device)
    p = HeteroParams(hg, problem.num_classes, device=device)
    optimizer = torch.optim.Adam(p.parameters(), lr=LEARNING_RATE)
    losses = []
    num_steps = demo_steps(num_steps)
    for i in range(num_steps):
        losses.append(train_step(p, optimizer, problem))
        if i % 50 == 0:
            print(f"step {i}: loss={float(losses[-1]):.4f}")
    with torch.no_grad():
        preds = forward(p, problem).argmax(-1)
    te = problem.test_index
    acc = float((preds[te] == problem.y[te]).float().mean())
    print(f"test accuracy ({target}): {acc:.4f}")
    if stats is not None:
        stats.update(steps=num_steps, losses=losses, evals=1)
    return acc


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
