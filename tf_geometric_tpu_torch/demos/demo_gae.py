"""Graph auto-encoder link prediction (JAX counterpart: ``demo/demo_gae.py``):
the encoder ``GCN(32, relu)``, dropout 0.3, ``GCN(16)`` on the train split
of ``edge_train_test_split(test_size=0.15, random_state=0)``, the
inner-product decoder, sigmoid cross-entropy of the train pairs against as
many host-drawn negatives (``negative_sampling(rng=step)``), Adam 1e-2, 150
steps; the test AUC against ``negative_sampling(replace=False, rng=0)``.

    python -m tf_geometric_tpu_torch.demos.demo_gae            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_gae --cpu

The set-up, the loss and the AUC are the bench's (``bench.gae_problem``,
``gae_loss``, ``gae_test_auc``: ``utils.metrics.binary_auc`` where the JAX
demo calls scikit-learn). Both GCNs run uncached: a step runs the COO SpMM
(``csrc/spmm_heads.cu``, X6) forward and ``dh`` at F = 32 and F = 16.
"""
from __future__ import annotations

import sys
from typing import Optional

import torch

from .. import bench
from .demo_utils import demo_steps, dropout_seed, load_cora

__all__ = ["GAEEncoder", "load_problem", "build_model", "train_step", "main", "LEARNING_RATE"]

LEARNING_RATE = 1e-2


class GAEEncoder(bench.GaeEncoder):
    """The demo's encoder (``bench.GaeEncoder``: ``gcn0``, ``gcn1``;
    ``convert.gae_encoder_state_dict_from_flax`` loads the flax
    ``GCN_0``/``GCN_1``)."""


def load_problem(device="cuda") -> bench.GaeProblem:
    """``load_cora``'s graph (on the host) set up as the demo does
    (``bench.gae_problem``), its tensors on ``device``."""
    graph, _ = load_cora(device="cpu")
    return bench.gae_problem(graph.x.numpy(), graph.edge_index.numpy(), device)


def build_model(problem: bench.GaeProblem, seed: int = 0):
    """The encoder (glorot kernels from ``seed``) and its Adam optimizer;
    reseeds the problem's dropout generator from ``seed``."""
    problem.generator.manual_seed(dropout_seed(seed))
    model = GAEEncoder(problem.x.shape[1], torch.Generator().manual_seed(seed),
                       device=problem.x.device)
    return model, torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)


def train_step(model, optimizer, problem: bench.GaeProblem, step: int, keep_mask=None,
               negatives=None):
    """One Adam step on step ``step``'s negatives (``bench.gae_negatives``,
    or ``negatives`` when given); dropout from the problem's generator
    unless ``keep_mask`` is given. Returns the loss (detached)."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    if negatives is None:
        negatives = bench.gae_negatives(problem, step)
    loss = bench.gae_loss(model, problem, negatives, keep_mask)
    loss.backward()
    optimizer.step()
    return loss.detach()


def main(device="cuda", num_steps: int = 150, stats: Optional[dict] = None):
    """Train on ``load_cora``'s graph; returns the test AUC. ``stats``
    receives ``steps``, ``losses`` and ``evals`` (1: the AUC's forward)."""
    problem = load_problem(device)
    model, optimizer = build_model(problem)
    losses = []
    num_steps = demo_steps(num_steps)
    for step in range(num_steps):
        losses.append(train_step(model, optimizer, problem, step))
        if step % 30 == 0:
            print(f"step {step}: loss={float(losses[-1]):.4f}")
    auc = bench.gae_test_auc(model, problem)
    print(f"test AUC: {auc:.4f}")
    if stats is not None:
        stats.update(steps=num_steps, losses=losses, evals=1)
    return auc


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
