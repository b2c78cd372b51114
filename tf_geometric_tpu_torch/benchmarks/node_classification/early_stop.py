"""Shared scaffolding of the five early-stop bench twins: the data a run
trains on, the loop with the reference's dual-criterion early stop
(``demos.demo_utils.train_node_classifier``, patience 100) and the scripts'
command line.

Each twin keeps its JAX script's protocol per ``BENCH_DATASET`` (cora,
citeseer, pubmed or arxiv) and exposes ``protocol(dataset)``, its model,
``build(graph, seed, dataset, device) -> (model, forward)``, ``run(seed=0,
device="cuda") -> test@best`` (``run_twin``) and a ``__main__`` that
appends one accuracy a line to ``TFG_RESULTS_PATH``:

    python -m tf_geometric_tpu_torch.benchmarks.node_classification.\
bench_node_cls_early_stop_gcn 0 1 2              # seeds 0-2 on the card
    TFG_HARD_PROTOCOL=1 BENCH_DATASET=citeseer python -m ... 0 --cpu
"""
from __future__ import annotations

import os
import sys
from typing import Callable, Iterable, Optional

from ...demos.demo_utils import load_planetoid, train_node_classifier

__all__ = ["PATIENCE", "bench_dataset", "load_data", "train", "run_twin", "main"]

PATIENCE = 100


def bench_dataset(dataset: Optional[str] = None) -> str:
    """``dataset``, or ``BENCH_DATASET`` (default cora) when it is None."""
    return dataset or os.environ.get("BENCH_DATASET", "cora")


def load_data(dataset: str, device="cuda"):
    """``(graph, (train, valid, test))`` on ``device`` as the JAX scripts'
    ``load_cora`` gives them for ``dataset`` (the hard-mode set under
    ``TFG_HARD_PROTOCOL=1``, keyed by ``TFG_HARD_MODEL``)."""
    return load_planetoid(dataset, device=device)


def train(module, forward: Callable, graph, splits, *, seed: int, max_steps: int,
          learning_rate: float, l2_coef: float, eval_every: int = 1,
          keep_masks: Optional[Iterable] = None, stats: Optional[dict] = None) -> float:
    """``train_node_classifier`` with the scripts' early stop; returns
    test@best. ``forward(training, generator, masks)`` runs the model;
    ``masks`` is None (draw from ``generator``) unless ``keep_masks`` is
    given, whose next item each training forward takes in place of the
    draws."""
    masks = iter(keep_masks) if keep_masks is not None else None

    def step_forward(training, generator):
        return forward(training, generator,
                       next(masks) if (training and masks is not None) else None)

    return train_node_classifier(step_forward, module, graph.y, splits, num_steps=max_steps,
                                 learning_rate=learning_rate, l2_coef=l2_coef,
                                 patience=PATIENCE, seed=seed, eval_every=eval_every,
                                 stats=stats)


def run_twin(twin, seed: int = 0, device="cuda", dataset: Optional[str] = None, data=None,
             state_dict=None, keep_masks: Optional[Iterable] = None,
             stats: Optional[dict] = None) -> float:
    """One seed of twin module ``twin`` (its ``protocol``, ``build`` and
    ``LEARNING_RATE``): weights from ``seed`` (or ``state_dict``), dropout
    from ``dropout_seed(seed)`` (or ``keep_masks``, one item a step);
    ``data`` is a loaded ``(graph, splits)`` on ``device``, else the
    dataset is loaded. Returns test@best."""
    dataset = bench_dataset(dataset)
    proto = twin.protocol(dataset)
    graph, splits = data if data is not None else load_data(dataset, device)
    model, forward = twin.build(graph, seed, dataset, device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return train(model, forward, graph, splits, seed=seed, max_steps=proto["max_steps"],
                 learning_rate=twin.LEARNING_RATE, l2_coef=proto["l2"],
                 eval_every=proto["eval_every"], keep_masks=keep_masks, stats=stats)


def main(run: Callable, script: str, argv=None):
    """The scripts' command line: seeds (default 0), ``--cpu``; each
    seed's test@best is appended to ``TFG_RESULTS_PATH`` (default
    ``results.txt`` beside ``script``)."""
    argv = sys.argv[1:] if argv is None else argv
    seeds = [int(v) for v in argv if not v.startswith("--")] or [0]
    device = "cpu" if "--cpu" in argv else "cuda"
    results_path = os.environ.get(
        "TFG_RESULTS_PATH", os.path.join(os.path.dirname(os.path.abspath(script)),
                                         "results.txt"))
    for seed in seeds:
        test_acc = run(seed, device=device)
        with open(results_path, "a", encoding="utf-8") as f:
            f.write(f"{test_acc}\n")
        print(f"seed {seed}: test accuracy {test_acc:.4f}")
