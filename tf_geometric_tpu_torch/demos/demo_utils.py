"""Shared scaffolding of the demos (JAX counterpart: ``demo/demo_utils.py``):
the Planetoid loader with its synthetic fallback, the masked cross-entropy
plus L2 objective, the node-classification loop with the reference's
dual-criterion early stop, and the padded-batch graph-classification loop.

Environment, as in the JAX scripts: ``TFG_DEMO_SMOKE_STEPS`` caps every
loop, ``TFG_HARD_PROTOCOL=1`` (with ``TFG_HARD_SEED``) loads the hard-mode
citation set, ``BENCH_DATASET`` picks the Planetoid set of ``load_cora``,
``TFG_ADAM_EPS`` sets Adam's epsilon, ``TFG_HARD_GRAPH_CLS=1`` the hard
graph-classification set.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data.graph import BatchGraph, Graph
from ..data.padding import batch_padding_spec, padded_batch_generator
from ..layers.base import dropout, glorot_uniform, l2_loss
from ..utils.graph_utils import _split_ids

__all__ = ["demo_steps", "load_planetoid", "load_cora", "masked_softmax_loss",
           "dropout_seed", "train_step", "train_node_classifier",
           "load_graph_classification_data",
           "train_test_split", "batch_padding_spec", "padded_batch_generator",
           "run_graph_classification", "init_like_flax", "dropout_generator",
           "GraphClassifier", "run_node_demo"]


def demo_steps(n: int) -> int:
    """``n``, or at most ``TFG_DEMO_SMOKE_STEPS`` when that is set (smoke
    runs); unset, the demos train as long as the reference demos do."""
    cap = int(os.environ.get("TFG_DEMO_SMOKE_STEPS", "0"))
    return min(n, cap) if cap > 0 else n


def _index_tensors(splits, device):
    return tuple(torch.as_tensor(np.asarray(s, np.int64), device=device) for s in splits)


def load_planetoid(name: str = "cora", device="cuda", read_env: bool = True):
    """``(graph, (train, valid, test))`` of a Planetoid set (cora, citeseer or
    pubmed), the graph's fields and the index tensors on ``device``. With
    ``TFG_HARD_PROTOCOL=1`` (and ``read_env``), the hard-mode set of seed
    ``TFG_HARD_SEED``; else the files on disk (``datasets.planetoid``, which
    never downloads), or the synthetic set of the same shape where they are
    not there."""
    from ..datasets import planetoid
    from ..datasets.synthetic_citation import FakePlanetoidDataset, HardCitationDataset
    if read_env and os.environ.get("TFG_HARD_PROTOCOL") == "1":
        seed = int(os.environ.get("TFG_HARD_SEED", "0"))
        graph, splits = HardCitationDataset(name, seed=seed).load_data()
    else:
        cls = {"cora": planetoid.CoraDataset, "citeseer": planetoid.CiteseerDataset,
               "pubmed": planetoid.PubmedDataset}[name]
        try:
            graph, splits = cls().load_data()
        except OSError:
            print(f"real {name} unavailable: using the synthetic {name}-shaped graph")
            graph, splits = FakePlanetoidDataset(name).load_data()
    graph.convert_data_to_tensor(device=device)
    return graph, _index_tensors(splits, device)


def load_cora(device="cuda"):
    """``load_planetoid`` of ``BENCH_DATASET`` (default cora)."""
    return load_planetoid(os.environ.get("BENCH_DATASET", "cora"), device=device)


def masked_softmax_loss(params, logits, y, mask_index, l2_coef: float = 5e-4):
    """Mean softmax cross-entropy over ``mask_index`` plus ``l2_loss`` of the
    "kernel" parameters of ``params`` (a module or a {name: tensor} dict)."""
    ce = F.cross_entropy(logits[mask_index], y[mask_index].long())
    return ce + l2_loss(params, l2_coef)


def dropout_seed(seed: int) -> int:
    """The dropout stream's seed for training seed ``seed``, kept apart from
    the seed the weights are drawn from (JAX: ``fold_in(PRNGKey(seed), 1)``)."""
    return int(np.random.SeedSequence([seed, 1]).generate_state(1, np.uint64)[0] >> 1)


def train_step(module: torch.nn.Module, optimizer, forward: Callable, y, train_index,
               l2_coef: float, generator=None, keep_masks=None):
    """One Adam step of ``train_node_classifier`` on the masked loss; returns
    the loss (detached). ``keep_masks``, when given, is handed to
    ``forward`` as its third argument, in place of the draws."""
    module.train()
    optimizer.zero_grad(set_to_none=True)
    logits = (forward(True, generator) if keep_masks is None
              else forward(True, generator, keep_masks))
    loss = masked_softmax_loss(module, logits, y, train_index, l2_coef)
    loss.backward()
    optimizer.step()
    return loss.detach()


def train_node_classifier(forward: Callable, module: torch.nn.Module, y, splits,
                          num_steps: int = 200, learning_rate: float = 1e-2,
                          l2_coef: float = 5e-4, log_every: int = 20,
                          patience: Optional[int] = None, seed: int = 0, eval_every: int = 1,
                          stats: Optional[dict] = None):
    """Train ``module`` with Adam on the masked loss; ``forward(training,
    generator) -> logits`` runs it (the loop sets its train / eval mode and
    hands it the dropout generator, None when evaluating).

    With ``patience``, the reference's early stop: every ``eval_every``
    steps (and at the last) the patience counter resets when validation
    accuracy rises OR validation loss falls, the run stops after more than
    ``patience`` evaluations without either, and the test accuracy is kept
    where both improve; returns that test accuracy. Without it, returns the
    final test accuracy. ``seed`` seeds the dropout stream
    (``dropout_seed``). Adam's epsilon is ``TFG_ADAM_EPS`` (default 1e-8,
    optax's). ``stats``, when given, receives ``steps`` (steps run),
    ``stop_step`` (None without an early stop), ``best_valid``,
    ``test_at_best``, ``losses`` (each step's loss, a tensor) and ``evals``
    (the evaluations run, the final one included)."""
    num_steps = demo_steps(num_steps)
    train_index, valid_index, test_index = splits
    y = y.long()
    optimizer = torch.optim.Adam(module.parameters(), lr=learning_rate,
                                 eps=float(os.environ.get("TFG_ADAM_EPS", "1e-8")))
    generator = torch.Generator(device=y.device).manual_seed(dropout_seed(seed))
    evals = 0

    @torch.no_grad()
    def accuracy():
        nonlocal evals
        evals += 1
        module.eval()
        logits = forward(False, None)
        preds = logits.argmax(dim=-1)
        accs = [(preds[idx] == y[idx]).float().mean()
                for idx in (train_index, valid_index, test_index)]
        valid_loss = F.cross_entropy(logits[valid_index], y[valid_index])
        return torch.stack(accs + [valid_loss]).tolist()

    best_valid, min_val_loss = 0.0, 1000.0
    best_test, bad_steps = 0.0, 0
    losses, stop_step, step = [], None, -1
    for step in range(num_steps):
        loss = train_step(module, optimizer, forward, y, train_index, l2_coef, generator)
        losses.append(loss)
        do_eval = patience is not None and ((step + 1) % eval_every == 0
                                            or step == num_steps - 1)
        if do_eval or step % log_every == 0:
            train_acc, valid_acc, test_acc, valid_loss = accuracy()
            if step % log_every == 0:
                print(f"step {step}: loss={float(loss):.4f} train={train_acc:.4f} "
                      f"valid={valid_acc:.4f} test={test_acc:.4f}")
            # tracking only on the shared eval cadence: a log-print
            # evaluation adds no tracking point
            if do_eval:
                if valid_acc > best_valid or valid_loss < min_val_loss:
                    bad_steps = 0
                else:
                    bad_steps += 1
                    if bad_steps > patience:
                        print(f"early stop at step {step}")
                        stop_step = step
                        break
                if valid_acc > best_valid and valid_loss < min_val_loss:
                    best_test = test_acc
                    best_valid, min_val_loss = valid_acc, valid_loss
    if patience is not None:
        print(f"best valid={best_valid:.4f} test@best={best_test:.4f}")
        test_acc = best_test
    else:
        test_acc = accuracy()[2]
    if stats is not None:
        stats.update(steps=step + 1, stop_step=stop_step, best_valid=best_valid,
                     test_at_best=best_test, losses=losses, evals=evals)
    return test_acc


# ---------------------------------------------------------------------------
# graph classification: TU datasets with a synthetic fallback
# ---------------------------------------------------------------------------

def load_graph_classification_data(name: str = "NCI1", num_fallback_graphs: int = 600,
                                   seed: int = 0):
    """``(graphs, num_classes)``: the TU set's graphs with one-hot node-label
    features when its files are on disk (``datasets.tu``), else the
    synthetic set of ``num_fallback_graphs`` random graphs; with
    ``TFG_HARD_GRAPH_CLS=1`` the hard-mode structural set of seed
    ``TFG_HARD_SEED``. Host-side numpy graphs."""
    from ..datasets.synthetic_citation import (synthetic_graph_classification,
                                               synthetic_graph_classification_hard)
    if os.environ.get("TFG_HARD_GRAPH_CLS") == "1":
        return synthetic_graph_classification_hard(
            num_graphs=num_fallback_graphs, seed=int(os.environ.get("TFG_HARD_SEED", "0")))
    from ..datasets.tu import TUDataset
    try:
        graph_dicts = TUDataset(name).load_data()
    except OSError:
        print(f"TU dataset {name} unavailable: using synthetic graphs")
        return synthetic_graph_classification(num_fallback_graphs, seed=seed)
    num_node_labels = int(max(np.max(g["node_labels"]) for g in graph_dicts)) + 1
    graphs = []
    for gd in graph_dicts:
        x = np.zeros([gd["num_nodes"], num_node_labels], np.float32)
        x[range(gd["num_nodes"]), gd["node_labels"]] = 1.0
        graphs.append(Graph(x=x, edge_index=gd["edge_index"], y=gd["graph_label"]))
    return graphs, int(max(int(g.y[0]) for g in graphs)) + 1


def train_test_split(items, test_size: float = 0.1, random_state: int = 0):
    """``(train, test)`` lists as scikit-learn's ``train_test_split(items,
    test_size=..., random_state=...)`` gives them (``_split_ids``)."""
    train_ids, test_ids = _split_ids(len(items), test_size, None, random_state, True, None)
    return [items[i] for i in train_ids], [items[i] for i in test_ids]


def init_like_flax(module: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Redraw ``module``'s parameters as the flax demo models draw theirs,
    from a ``torch.Generator`` seeded ``seed``, in parameter order: a
    ``torch.nn.Linear`` weight as flax ``Dense``'s LeCun normal (truncated at
    two standard deviations, standard deviation √(1/fan_in) / 0.8796), every
    other matrix glorot-uniform (the GCN kernels), every vector zeros (the
    biases, GIN's ε). Returns ``module``."""
    gen = torch.Generator().manual_seed(seed)
    linear_weights = {id(m.weight) for m in module.modules() if isinstance(m, torch.nn.Linear)}
    with torch.no_grad():
        for p in module.parameters():
            if id(p) in linear_weights:
                std = (1.0 / p.shape[1]) ** 0.5 / 0.87962566103423978
                w = torch.empty(p.shape).normal_(generator=gen)
                while bool((w.abs() > 2.0).any()):
                    redraw = w.abs() > 2.0
                    w[redraw] = torch.empty(int(redraw.sum())).normal_(generator=gen)
                p.copy_(w * std)
            elif p.dim() == 2:
                p.copy_(glorot_uniform(tuple(p.shape), gen))
            else:
                p.zero_()
    return module


def dropout_generator(seed: int, device="cuda") -> torch.Generator:
    """A graph-classification model's own dropout generator on ``device``,
    seeded ``dropout_seed(seed)``."""
    return torch.Generator(device=device).manual_seed(dropout_seed(seed))


class GraphClassifier(torch.nn.Module):
    """Base of the graph-classification demo models: weights drawn by
    ``init_like_flax(self, seed)`` once the subclass built its layers
    (``_init``), and a dropout generator of its own seeded
    ``dropout_seed(seed)`` on ``device`` (``run_graph_classification``
    hands the model no generator). ``self.drop(h, i, keep_masks)``: dropout
    0.4 in training mode, keep mask ``keep_masks[i]`` in place of a draw
    when given."""

    DROP_RATE = 0.4

    def __init__(self, num_graphs: int, seed: int = 0, device="cuda"):
        super().__init__()
        self.num_graphs, self.seed = num_graphs, seed
        self.generator = dropout_generator(seed, device)

    def _init(self):
        init_like_flax(self, self.seed)

    def drop(self, h, i: int, keep_masks=None):
        return dropout(h, self.DROP_RATE, self.training, self.generator,
                       None if keep_masks is None else keep_masks[i])


def run_graph_classification(make_model: Callable, batch_size: int = 32, num_steps: int = 300,
                             learning_rate: float = 5e-3, dataset: str = "NCI1", seed: int = 0,
                             extra_loss_from_state: Optional[Callable] = None, split=None,
                             device="cuda", stats: Optional[dict] = None, data=None):
    """The padded-batch graph-classification loop; returns the test accuracy.

    ``make_model(num_classes, num_graphs)`` returns a module called as
    ``model(x, edge_index, edge_weight, node_graph_index) -> logits`` (or
    ``(logits, state)`` with ``extra_loss_from_state``, whose
    ``extra_loss_from_state(state)`` is added to the loss: MinCutPool's
    losses); the module draws its own dropout. ``split`` is a given
    ``(train_graphs, test_graphs)``; by default a 90/10 split
    (``train_test_split``). ``data``, a given ``(graphs, num_classes)``,
    stands in for ``load_graph_classification_data(dataset)`` (the JAX
    ModelNet demo swaps that loader out for the run). Batches of
    ``batch_size`` graphs are padded to one spec (``data.padding``), so
    every step has the same shapes.
    ``stats``, when given, receives ``losses`` (each step's loss, a
    tensor), ``steps`` and ``evals`` (the padded test batches evaluated)."""
    num_steps = demo_steps(num_steps)
    graphs, num_classes = (load_graph_classification_data(dataset, seed=seed) if data is None
                           else data)
    if split is not None:
        train_graphs, test_graphs = split
    else:
        train_graphs, test_graphs = train_test_split(graphs, test_size=0.1, random_state=0)
    model = make_model(num_classes, batch_size)
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate)

    def to_args(batch: BatchGraph):
        return tuple(torch.as_tensor(np.asarray(a), device=device)
                     for a in (batch.x, batch.edge_index, batch.edge_weight,
                               batch.node_graph_index))

    def logits_of(out):
        return out[0] if extra_loss_from_state is not None else out

    def batch_labels(batch, real):
        y = np.zeros(batch_size, np.int64)
        y[:real] = np.asarray(batch.y).flatten()[:real]
        mask = np.zeros(batch_size, np.float32)
        mask[:real] = 1.0
        return torch.as_tensor(y, device=device), torch.as_tensor(mask, device=device)

    gen = padded_batch_generator(train_graphs, batch_size, seed=seed)
    # the JAX loop initializes its model on the first batch: skip it, so
    # both loops train on the same batches
    next(gen)
    model.train()
    losses = []
    for step in range(num_steps):
        batch, real = next(gen)
        y, mask = batch_labels(batch, real)
        optimizer.zero_grad(set_to_none=True)
        out = model(*to_args(batch))
        ce = F.cross_entropy(logits_of(out), y.clamp_min(0), reduction="none")
        loss = (ce * mask).sum() / mask.sum().clamp_min(1.0)
        if extra_loss_from_state is not None:
            loss = loss + extra_loss_from_state(out[1])
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
        if step % 50 == 0:
            print(f"step {step}: loss={loss.item():.4f}")

    model.eval()
    correct = total = evals = 0
    with torch.no_grad():
        for batch, real in padded_batch_generator(test_graphs, batch_size, shuffle=False,
                                                  infinite=False):
            preds = logits_of(model(*to_args(batch))).argmax(dim=-1)[:real].cpu().numpy()
            correct += int((preds == np.asarray(batch.y).flatten()[:real]).sum())
            total += real
            evals += 1
    acc = correct / max(total, 1)
    if stats is not None:
        stats.update(steps=num_steps, losses=losses, evals=evals)
    print(f"test accuracy: {acc:.4f}")
    return acc


def run_node_demo(build: Callable, num_steps: int = 200, learning_rate: float = 1e-2,
                  l2_coef: float = 5e-4, device="cuda", stats: Optional[dict] = None):
    """A node-classification demo's ``main``: ``load_cora`` on ``device``,
    ``build(graph, num_classes, device=device) -> (model, forward)``, then
    ``train_node_classifier`` for ``num_steps`` steps without an early stop;
    returns the final test accuracy."""
    graph, splits = load_cora(device=device)
    model, forward = build(graph, int(graph.y.max()) + 1, device=device)
    return train_node_classifier(forward, model, graph.y, splits, num_steps=num_steps,
                                 learning_rate=learning_rate, l2_coef=l2_coef, stats=stats)
