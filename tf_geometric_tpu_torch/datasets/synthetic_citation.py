"""Synthetic graphs for offline tests, demos and benchmarks (JAX
counterpart: ``tf_geometric_tpu/datasets/synthetic_citation.py``, and the
offline graph set of ``load_graph_classification_data`` in
``demo/demo_utils.py``).

Pure numpy, with the same ``np.random.default_rng`` calls in the same
order: the same seed gives arrays bit-identical to the JAX package's, so
both packages train on identical inputs. Nothing here downloads. The graphs
stay on the host (numpy) until ``Graph.convert_data_to_tensor``.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..data.graph import Graph
from ..utils.graph_utils import convert_edge_to_directed, remove_self_loop_edge

__all__ = ["synthetic_citation_graph", "synthetic_ogbn_arxiv_like", "FakePlanetoidDataset",
           "HardCitationDataset", "synthetic_graph_classification",
           "synthetic_graph_classification_hard", "flip_graph_labels"]


def synthetic_citation_graph(num_nodes: int = 2708, num_features: int = 1433,
                             num_classes: int = 7, avg_degree: float = 4.0,
                             homophily: float = 0.83, feature_signal: float = 4.0,
                             class_overlap: float = 0.0, seed: int = 0) -> Graph:
    """Cora-shaped stochastic block model: homophilous edges and
    class-informative bag-of-words features.

    Each of ``num_nodes * avg_degree`` drawn edges keeps a uniform source;
    with probability ``homophily`` its destination is redrawn from the
    source's class. Self-loops go, the rest is made symmetric
    (``convert_edge_to_directed``). Each node adds ``feature_signal`` to
    ``max(5, F // 60)`` words of its class's block (with probability
    ``class_overlap`` another random class's block) and 1 to as many random
    words; rows are normalized to sum 1."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)

    num_edges = int(num_nodes * avg_degree / 2)
    src = rng.integers(0, num_nodes, size=num_edges * 2)
    same_class = rng.random(num_edges * 2) < homophily
    dst = rng.integers(0, num_nodes, size=num_edges * 2)
    for c in range(num_classes):
        pool = np.nonzero(y == c)[0]
        if len(pool) == 0:
            continue
        mask = same_class & (y[src] == c)
        dst[mask] = pool[rng.integers(0, len(pool), size=mask.sum())]
    edge_index, _ = remove_self_loop_edge(np.stack([src, dst], axis=0))
    edge_index, _ = convert_edge_to_directed(edge_index)

    words_per_class = max(1, num_features // num_classes)
    x = np.zeros((num_nodes, num_features), np.float32)
    n_active = max(5, num_features // 60)
    for i in range(num_nodes):
        if class_overlap > 0.0 and rng.random() < class_overlap:
            word_class = int(rng.integers(0, num_classes))
        else:
            word_class = int(y[i])
        signal_words = word_class * words_per_class + rng.integers(0, words_per_class,
                                                                   size=n_active)
        noise_words = rng.integers(0, num_features, size=n_active)
        x[i, signal_words % num_features] += feature_signal
        x[i, noise_words] += 1.0
    x /= np.maximum(x.sum(axis=-1, keepdims=True), 1e-8)
    return Graph(x=x, edge_index=edge_index, y=y)


def synthetic_ogbn_arxiv_like(
    num_nodes: int = 169_343,
    num_edges: int = 1_166_243,
    num_features: int = 128,
    num_classes: int = 40,
    seed: int = 0,
) -> Graph:
    """ogbn-arxiv-scale graph for throughput benchmarks (dense float features,
    directed citation edges with skewed in-degree)."""
    rng = np.random.default_rng(seed)
    # skewed destinations (preferential-attachment-ish via squared uniform)
    dst = (rng.random(num_edges) ** 2 * num_nodes).astype(np.int64)
    src = rng.integers(0, num_nodes, size=num_edges)
    edge_index = np.stack([dst, src], axis=0).astype(np.int32)
    x = rng.normal(size=(num_nodes, num_features)).astype(np.float32)
    y = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)
    return Graph(x=x, edge_index=edge_index, y=y)


class FakePlanetoidDataset:
    """Stands in for ``PlanetoidDataset`` where the files are not on disk:
    a ``synthetic_citation_graph`` of the dataset's shape and the same
    ``load_data`` contract, ``(graph, (train, valid, test))`` (20 labels a
    class, the next 500 nodes to validate, the last 1,000 to test)."""

    _SHAPES = {
        "cora": dict(num_nodes=2708, num_features=1433, num_classes=7),
        "citeseer": dict(num_nodes=3327, num_features=3703, num_classes=6),
        "pubmed": dict(num_nodes=19717, num_features=500, num_classes=3),
    }

    def __init__(self, dataset_name: str = "cora", seed: int = 0):
        self.dataset_name = dataset_name
        self.seed = seed

    def load_data(self):
        shape = self._SHAPES[self.dataset_name]
        graph = synthetic_citation_graph(seed=self.seed, **shape)
        n_train = shape["num_classes"] * 20
        train_index = list(range(n_train))
        valid_index = list(range(n_train, n_train + 500))
        test_index = list(range(shape["num_nodes"] - 1000, shape["num_nodes"]))
        return graph, (train_index, valid_index, test_index)


class HardCitationDataset:
    """The hard-mode protocol: ``FakePlanetoidDataset``'s shapes (and an
    ogbn-arxiv-shaped entry) made hard enough that a GCN lands near the
    published real-data accuracies instead of saturating.

    Harder than the easy set in four ways: ``class_overlap`` (signal words
    from a random class's block), lower ``homophily`` and
    ``feature_signal`` (``_DIFFICULTY``), 10 training labels a class, and
    ``LABEL_NOISE`` of the training labels flipped to another class, spread
    evenly over the classes (validation and test labels stay clean).
    ``model`` picks a per-(model, shape) override (``_MODEL_DIFFICULTY``);
    when it is None the environment's ``TFG_HARD_MODEL`` is read, as the
    JAX package does. Validation nodes come from ``default_rng(seed +
    10_000)``, which then draws the flips."""

    _SHAPES = {**FakePlanetoidDataset._SHAPES,
               "arxiv": dict(num_nodes=169_343, num_features=128, num_classes=40,
                             avg_degree=7.0)}
    _DIFFICULTY = {
        "cora": dict(homophily=0.62, feature_signal=1.2, class_overlap=0.45),
        "citeseer": dict(homophily=0.55, feature_signal=1.1, class_overlap=0.50),
        "pubmed": dict(homophily=0.60, feature_signal=1.1, class_overlap=0.48),
        "arxiv": dict(homophily=0.52, feature_signal=1.1, class_overlap=0.50),
    }
    _VAL_SIZE = {"arxiv": 2000}
    _TEST_SIZE = {"arxiv": 10_000}
    _MODEL_DIFFICULTY = {
        ("gat", "citeseer"): dict(homophily=0.72, feature_signal=2.5, class_overlap=0.20,
                                  train_per_class=20),
        ("gat", "pubmed"): dict(homophily=0.70, feature_signal=2.0, class_overlap=0.30),
        ("appnp", "citeseer"): dict(homophily=0.66, feature_signal=1.6, class_overlap=0.35),
        ("ssgc", "citeseer"): dict(homophily=0.66, feature_signal=1.6, class_overlap=0.35),
    }
    TRAIN_PER_CLASS = 10
    LABEL_NOISE = 0.10

    def __init__(self, dataset_name: str = "cora", seed: int = 0,
                 model: Optional[str] = None):
        self.dataset_name = dataset_name
        self.seed = seed
        if model is None:
            model = os.environ.get("TFG_HARD_MODEL") or None
        self.model = model

    def load_data(self):
        shape = self._SHAPES[self.dataset_name]
        diff = dict(self._DIFFICULTY[self.dataset_name])
        diff.update(self._MODEL_DIFFICULTY.get((self.model, self.dataset_name), {}))
        train_per_class = int(diff.pop("train_per_class", self.TRAIN_PER_CLASS))
        label_noise = float(diff.pop("label_noise", self.LABEL_NOISE))
        graph = synthetic_citation_graph(seed=self.seed, **shape, **diff)
        num_classes = shape["num_classes"]
        num_nodes = shape["num_nodes"]
        rng = np.random.default_rng(self.seed + 10_000)
        y = np.asarray(graph.y).copy()

        # balanced training labels from the front, validation drawn from the
        # rest of the head, test the tail: all disjoint
        n_val = self._VAL_SIZE.get(self.dataset_name, 500)
        n_test = self._TEST_SIZE.get(self.dataset_name, 1000)
        head = y[: num_nodes - n_test]
        train_index = np.sort(np.concatenate([np.nonzero(head == c)[0][:train_per_class]
                                              for c in range(num_classes)]))
        pool = np.setdiff1d(np.arange(num_nodes - n_test), train_index)
        valid_index = np.sort(rng.choice(pool, size=n_val, replace=False))
        test_index = np.arange(num_nodes - n_test, num_nodes)

        flips_per_class = int(round(label_noise * train_per_class))
        y_clean = np.asarray(graph.y)
        for c in range(num_classes):
            members = train_index[y_clean[train_index] == c]
            if len(members) == 0:
                continue
            victims = rng.choice(members, size=min(flips_per_class, len(members)),
                                 replace=False)
            for node in victims:
                y[node] = (y[node] + 1 + rng.integers(0, num_classes - 1)) % num_classes
        graph.y = y.astype(np.int32)
        return graph, (train_index.astype(np.int32), valid_index.astype(np.int32),
                       test_index.astype(np.int32))


def synthetic_graph_classification(num_graphs: int = 600, seed: int = 0):
    """The graph set ``load_graph_classification_data`` trains on when the
    TU files are not on disk (``demo/demo_utils.py``): ``num_graphs`` random
    graphs of 10-19 nodes with one-hot features over 4 node labels; class 0
    has 2 random directed edges per node, class 1 has 5. Returns
    ``(graphs, num_classes)``."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(num_graphs):
        label = int(rng.integers(0, 2))
        n = int(rng.integers(10, 20))
        num_edges = n * (2 if label == 0 else 5)
        ei = rng.integers(0, n, size=(2, num_edges)).astype(np.int32)
        x = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
        graphs.append(Graph(x=x, edge_index=ei, y=[label]))
    return graphs, 2


def synthetic_graph_classification_hard(num_graphs: int = 400, num_features: int = 4,
                                        hub_exponent: float = 4.5, seed: int = 0):
    """The hard-mode graph-classification set: two classes with the same
    node and edge counts and constant features; only the wiring differs
    (class 0 draws edge destinations uniformly, class 1 hub-biased,
    ``u ** hub_exponent``), with exactly ``3 n`` unique directed edges per
    graph. Returns ``(graphs, num_classes)``."""
    rng = np.random.default_rng(seed)

    def draw_unique(n, e, hubby):
        pairs = np.empty((0, 2), np.int64)
        for _ in range(64):
            need = e - len(pairs)
            if need <= 0:
                break
            src = rng.integers(0, n, size=need * 2)
            if hubby:
                dst = np.minimum((rng.random(need * 2) ** hub_exponent * n).astype(np.int64),
                                 n - 1)
            else:
                dst = rng.integers(0, n, size=need * 2)
            pairs = np.unique(np.concatenate([pairs, np.stack([dst, src], axis=1)]), axis=0)
        if len(pairs) < e:
            raise RuntimeError(f"drew {len(pairs)} unique edges of {e} for a {n}-node graph")
        return pairs[rng.permutation(len(pairs))[:e]].T

    graphs = []
    for g in range(num_graphs):
        label = int(g % 2)
        n = int(rng.integers(12, 28))
        ei = draw_unique(n, 3 * n, hubby=label == 1).astype(np.int32)
        x = np.full((n, num_features), 1.0 / num_features, np.float32)
        graphs.append(Graph(x=x, edge_index=ei, y=np.asarray([label])))
    order = rng.permutation(num_graphs)
    return [graphs[i] for i in order], 2


def flip_graph_labels(graphs, noise: float = 0.1, seed: int = 42):
    """Flip the binary labels of ``round(noise * len(graphs))`` of the given
    (training) graphs in place, chosen by ``default_rng(seed)``; returns the
    list."""
    rng = np.random.default_rng(seed)
    k = int(round(noise * len(graphs)))
    for i in rng.choice(len(graphs), size=k, replace=False):
        g = graphs[i]
        g.y = np.asarray([1 - int(np.asarray(g.y).flatten()[0])])
    return graphs
