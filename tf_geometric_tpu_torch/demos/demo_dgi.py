"""Deep Graph Infomax (JAX counterpart: ``demo/demo_dgi.py``): the encoder
``GCN(64)`` and a PReLU (α from 0.25) on x and on row-shuffled x, a bilinear
[64, 64] discriminator against the sigmoid of the positive embeddings'
mean, sigmoid cross-entropy, Adam 1e-3, 150 steps; then a logistic
regression fit on the embeddings of the training nodes and scored on the
test nodes.

    python -m tf_geometric_tpu_torch.demos.demo_dgi            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_dgi --cpu

The permutations come from a ``torch.Generator``. The encoder's GCN runs
uncached: a step runs the COO SpMM (``csrc/spmm_heads.cu``, X6) forward and
``dh`` at F = 64 twice (positive and shuffled). The logistic regression is
this module's own (``_logistic_regression``: scikit-learn's default
objective, solved by L-BFGS in float64), as the card's machine has no
scikit-learn.
"""
from __future__ import annotations

import sys
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..layers.base import glorot_uniform
from ..layers.conv.gcn import GCN
from .demo_utils import demo_steps, load_cora

__all__ = ["DGIEncoder", "Discriminator", "DGIModel", "build_model", "dgi_loss", "train_step",
           "embed", "main", "UNITS", "LEARNING_RATE", "PRELU_INIT"]

UNITS, LEARNING_RATE, PRELU_INIT = 64, 1e-3, 0.25
# scikit-learn's LogisticRegression defaults the demo uses (max_iter raised to 500)
LOGREG_C, LOGREG_TOL, LOGREG_MAX_ITER = 1.0, 1e-4, 500


class DGIEncoder(nn.Module):
    """``GCN(64)`` (flax name ``GCN_0``), then a PReLU whose slope
    ``prelu_alpha`` [1] starts at 0.25."""

    def __init__(self, in_features: int, units: int = UNITS, generator=None, device="cuda"):
        super().__init__()
        self.GCN_0 = GCN(in_features, units, generator=generator, device=device)
        self.prelu_alpha = nn.Parameter(torch.full((1,), PRELU_INIT, device=device))

    def forward(self, x, edge_index, edge_weight):
        h = self.GCN_0([x, edge_index, edge_weight])
        return torch.where(h >= 0, h, self.prelu_alpha * h)


class Discriminator(nn.Module):
    """``sum(h * (summary @ bilinear), -1)``, ``bilinear`` [64, 64]
    glorot-uniform."""

    def __init__(self, units: int = UNITS, generator=None, device="cuda"):
        super().__init__()
        self.bilinear = nn.Parameter(glorot_uniform((units, units), generator).to(device))

    def forward(self, summary, h):
        return (h * (summary @ self.bilinear)).sum(-1)


class DGIModel(nn.Module):
    """The encoder and the discriminator under the JAX demo's parameter
    keys ``enc`` and ``disc`` (``convert.dgi_state_dict_from_flax``)."""

    def __init__(self, in_features: int, generator=None, device="cuda"):
        super().__init__()
        self.enc = DGIEncoder(in_features, generator=generator, device=device)
        self.disc = Discriminator(generator=generator, device=device)


def build_model(in_features: int, seed: int = 0, device="cuda"):
    """The model (glorot kernels from ``seed``) and its Adam optimizer."""
    model = DGIModel(in_features, torch.Generator().manual_seed(seed), device)
    return model, torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)


def dgi_loss(model: DGIModel, x, edge_index, edge_weight, perm):
    """The positive embeddings scored 1 and those of ``x[perm]`` scored 0
    against their summary, the two mean sigmoid cross-entropies added."""
    pos = model.enc(x, edge_index, edge_weight)
    neg = model.enc(x[perm], edge_index, edge_weight)
    summary = torch.sigmoid(pos.mean(0, keepdim=True))
    pos_logits, neg_logits = model.disc(summary, pos), model.disc(summary, neg)
    return (F.binary_cross_entropy_with_logits(pos_logits, torch.ones_like(pos_logits))
            + F.binary_cross_entropy_with_logits(neg_logits, torch.zeros_like(neg_logits)))


def train_step(model, optimizer, graph, generator=None, perm=None):
    """One Adam step; the row permutation from ``generator`` unless
    ``perm`` is given. Returns the loss (detached)."""
    if perm is None:
        perm = torch.randperm(graph.x.shape[0], generator=generator, device=graph.x.device)
    optimizer.zero_grad(set_to_none=True)
    loss = dgi_loss(model, graph.x, graph.edge_index, graph.edge_weight, perm)
    loss.backward()
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def embed(model: DGIModel, graph):
    """The encoder's embeddings of every node."""
    return model.enc(graph.x, graph.edge_index, graph.edge_weight)


def _logistic_regression(x_train, y_train, x_test, c: float = LOGREG_C,
                         tol: float = LOGREG_TOL, max_iter: int = LOGREG_MAX_ITER):
    """Predicted classes of ``x_test`` by scikit-learn's default
    ``LogisticRegression`` fit on ``(x_train, y_train)``: multinomial (a
    single logistic vector for two classes), an L2 penalty of 1/(2C) on the
    weights, the intercept unpenalized, the mean loss minimized by
    full-batch L-BFGS in float64 until the gradient's largest entry is below
    ``tol`` or ``max_iter`` iterations."""
    x = torch.as_tensor(x_train, dtype=torch.float64)
    xt = torch.as_tensor(x_test, dtype=torch.float64, device=x.device)
    classes, y = torch.unique(torch.as_tensor(y_train, device=x.device), return_inverse=True)
    n, d = x.shape
    outputs = 1 if len(classes) == 2 else len(classes)
    w = torch.zeros(d + 1, outputs, dtype=torch.float64, device=x.device, requires_grad=True)
    optimizer = torch.optim.LBFGS([w], lr=1, max_iter=max_iter, tolerance_grad=tol,
                                  tolerance_change=0.0, history_size=10,
                                  line_search_fn="strong_wolfe")

    def objective():
        optimizer.zero_grad()
        logits = x @ w[:-1] + w[-1]
        if outputs == 1:
            loss = F.binary_cross_entropy_with_logits(logits[:, 0], y.double())
        else:
            loss = F.cross_entropy(logits, y)
        loss = loss + (w[:-1] ** 2).sum() / (2.0 * c * n)
        loss.backward()
        return loss

    optimizer.step(objective)
    with torch.no_grad():
        logits = xt @ w[:-1] + w[-1]
        picks = (logits[:, 0] > 0).long() if outputs == 1 else logits.argmax(-1)
    return classes[picks]


def main(device="cuda", num_steps: int = 150, stats: Optional[dict] = None, seed: int = 0):
    """Train on ``load_cora``'s graph, then score the logistic regression;
    returns its test accuracy. ``stats`` receives ``steps``, ``losses`` and
    ``evals`` (1: the embeddings' forward)."""
    graph, (train_index, _, test_index) = load_cora(device=device)
    model, optimizer = build_model(graph.num_features, seed, device)
    generator = torch.Generator(device=device).manual_seed(seed)
    losses = []
    num_steps = demo_steps(num_steps)
    for step in range(num_steps):
        losses.append(train_step(model, optimizer, graph, generator))
        if step % 30 == 0:
            print(f"step {step}: loss={float(losses[-1]):.4f}")
    h, y = embed(model, graph), graph.y.long()
    preds = _logistic_regression(h[train_index], y[train_index], h[test_index])
    acc = float((preds == y[test_index]).double().mean())
    print(f"test accuracy (logreg on DGI embeddings): {acc:.4f}")
    if stats is not None:
        stats.update(steps=num_steps, losses=losses, evals=1)
    return acc


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
