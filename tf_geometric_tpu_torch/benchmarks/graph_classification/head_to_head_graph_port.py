"""Accuracy head-to-head of the port's graph-classification demo twins
against the JAX package on the hard-mode structural set (JAX counterpart:
``benchmarks/graph_classification/head_to_head_graph.py``).

Protocol, as the JAX harness's repo side: ``synthetic_graph_classification_hard(seed=0)``
split 90/10 with ``random_state=0``, ``flip_graph_labels`` on the training
part; padded batches of 32 graphs, 300 Adam steps at 5e-3 (GIN 3e-3), the
final test accuracy. Models: ``mean_pool``, ``gin``, ``sag_pool``,
``sort_pool``, ``diff_pool``, ``min_cut_pool`` (``demos.demo_*``). Seeds
0..n-1 run in this one process; n defaults to JAX's seed count. JAX's
per-seed results are read, as data, from the ``repo`` lists of
``benchmarks/graph_classification/head_to_head_graph.json``.

Output: ``head_to_head_graph_port.json`` beside this file, as the node
harness writes its cells; the gate is the node harness's ``gate`` with the
flat term 0.05 (one graph of the 40-graph test set is 0.025).

    python -m tf_geometric_tpu_torch.benchmarks.graph_classification.head_to_head_graph_port \
        [num_seeds] [model ...] [--device cuda|cpu] [--out PATH]
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

from ..node_classification.head_to_head_port import parse_command_line, run_harness

__all__ = ["MODELS", "BATCH", "STEPS", "FLAT_TOL", "JAX_JSON", "OUT_PATH", "jax_results",
           "shared_split", "make_model", "run", "main"]

MODELS = ("mean_pool", "gin", "sag_pool", "sort_pool", "diff_pool", "min_cut_pool")
BATCH, STEPS = 32, 300
FLAT_TOL = 0.05
JAX_JSON = (Path(__file__).resolve().parents[3] / "benchmarks" / "graph_classification"
            / "head_to_head_graph.json")
OUT_PATH = Path(__file__).resolve().parent / "head_to_head_graph_port.json"


def jax_results(model: str) -> list:
    """JAX's committed per-seed test accuracies of ``model`` (its ``repo``
    list)."""
    with open(JAX_JSON, encoding="utf-8") as f:
        return list(json.load(f)[model]["repo"])


def shared_split():
    """``(train, test)`` host graphs of the shared protocol."""
    from ...datasets.synthetic_citation import (flip_graph_labels,
                                                 synthetic_graph_classification_hard)
    from ...demos.demo_utils import train_test_split
    graphs, _ = synthetic_graph_classification_hard(seed=0)
    train, test = train_test_split(graphs, test_size=0.1, random_state=0)
    flip_graph_labels(train)
    return train, test


def make_model(model: str, in_features: int, seed: int, device="cuda"):
    """``(make_model(num_classes, num_graphs), learning rate, auxiliary
    loss or None)`` of demo twin ``model``."""
    from ...demos import (demo_diff_pool, demo_gin, demo_mean_pool, demo_min_cut_pool,
                          demo_sag_pool_h, demo_sort_pool)
    cls = {"mean_pool": demo_mean_pool.MeanPoolNetwork, "gin": demo_gin.GINModel,
           "sag_pool": demo_sag_pool_h.SAGPoolHModel, "sort_pool": demo_sort_pool.SortPoolModel,
           "diff_pool": demo_diff_pool.DiffPoolModel,
           "min_cut_pool": demo_min_cut_pool.MinCutPoolModel}[model]
    aux = demo_min_cut_pool._aux_loss if model == "min_cut_pool" else None
    return ((lambda c, g: cls(in_features, c, g, seed=seed, device=device)),
            3e-3 if model == "gin" else 5e-3, aux)


def run(model: str, seed: int, split, device="cuda", stats: Optional[dict] = None) -> float:
    """One seeded run of demo twin ``model`` on ``split``; returns the test
    accuracy."""
    from ...demos.demo_utils import run_graph_classification
    build, lr, aux = make_model(model, split[0][0].x.shape[1], seed, device)
    previous = os.environ.get("TFG_HARD_GRAPH_CLS")
    os.environ["TFG_HARD_GRAPH_CLS"] = "1"  # the class count of the hard set, as JAX's
    try:
        return float(run_graph_classification(build, batch_size=BATCH, num_steps=STEPS,
                                              learning_rate=lr, seed=seed, split=split,
                                              extra_loss_from_state=aux, device=device,
                                              stats=stats))
    finally:
        if previous is None:
            del os.environ["TFG_HARD_GRAPH_CLS"]
        else:
            os.environ["TFG_HARD_GRAPH_CLS"] = previous


def main(num_seeds: Optional[int] = None, models: Optional[Sequence[str]] = None,
         device="cuda", out_path: Path = OUT_PATH) -> Dict[str, dict]:
    """Run the missing seeds of each model (``head_to_head_port.run_harness``,
    flat term ``FLAT_TOL``) on the shared split."""
    models = list(models or MODELS)
    unknown = [m for m in models if m not in MODELS]
    if unknown:
        raise ValueError(f"unknown models {unknown}; models are {MODELS}")
    split = shared_split()
    return run_harness(models, jax_results, lambda model, seed: run(model, seed, split, device),
                       num_seeds, device, out_path, FLAT_TOL)


if __name__ == "__main__":
    n, only, opts = parse_command_line(sys.argv[1:], OUT_PATH)
    res = main(n, only, **opts)
    sys.exit(0 if all(e["gate_ok"] for m, e in res.items() if only is None or m in only) else 1)
