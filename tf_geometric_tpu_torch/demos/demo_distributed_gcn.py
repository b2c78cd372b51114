"""Graph-parallel GCN training (JAX counterpart:
``demo/demo_distributed_gcn.py``, a ``shard_map`` over every device): the
normalized Cora adjacency (``load_cora``) cut into contiguous row blocks by
``parallel.partition_edges_by_row``, one per rank, each rank training
``parallel.make_graph_parallel_gcn_step`` in its all-gather mode (hidden 16,
Adam 1e-2, weights from ``default_rng(0)`` at scale 0.1, zero biases) on
its block, as ``torch.distributed`` ranks through ``parallel.run_ranks``;
then the trained weights evaluated in this process through
``SparseMatrix.matmul``. Returns the test accuracy.

    python -m tf_geometric_tpu_torch.demos.demo_distributed_gcn            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_distributed_gcn --cpu 4

The ranks default to one per card (``torch.cuda.device_count()``, the
script's ``len(jax.devices())``) over gloo; on the CPU the count is given.
The step's aggregation is a gather and an ``index_add`` (the JAX step's
gather and ``segment_sum``: no custom kernel on TPU either); the evaluation
launches the COO SpMM (``csrc/spmm_heads.cu``, X6) twice on the card, at
F = 16 and F = C. The step keeps the true gradient of the global masked
mean; the JAX step hands Adam P times it (ROADMAP §3).
"""
from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from ..nn.conv.gcn import gcn_norm_adj
from ..parallel.partition import partition_edges_by_row
from ..parallel.runner import ShardJob, run_ranks
from ..sparse import SparseMatrix
from .demo_utils import demo_steps, load_cora

__all__ = ["normalized", "problem", "rank_jobs", "evaluate", "main", "HIDDEN", "LEARNING_RATE"]

HIDDEN = 16
LEARNING_RATE = 1e-2


def normalized(graph):
    """The GCN normalization of ``graph``'s adjacency, a CPU ``SparseMatrix``."""
    n = graph.num_nodes
    return gcn_norm_adj(SparseMatrix(graph.edge_index.cpu(), graph.edge_weight.cpu(), (n, n),
                                     device="cpu"))


def problem(graph, num_parts: int):
    """The host arrays of the run: ``(normed, part, x_pad, y_pad,
    params)``: the normalized adjacency (a CPU ``SparseMatrix``), its
    ``EdgePartition`` over ``num_parts`` ranks, the features and labels
    padded to the partition's rows, and the initial ``[(w0, b0), (w1, b1)]`` (numpy, the script's draws)."""
    n = graph.num_nodes
    x = graph.x.detach().cpu().numpy()
    y = graph.y.detach().cpu().numpy()
    num_classes = int(y.max()) + 1
    normed = normalized(graph)
    part = partition_edges_by_row(normed.index.numpy(), normed.value.numpy(), n, num_parts)
    n_pad = part.num_nodes_padded
    x_pad = np.zeros((n_pad, x.shape[1]), np.float32)
    x_pad[:n] = x
    y_pad = np.zeros(n_pad, np.int32)
    y_pad[:n] = y
    rng = np.random.default_rng(0)
    params = [(rng.normal(scale=0.1, size=(x.shape[1], HIDDEN)).astype(np.float32),
               np.zeros(HIDDEN, np.float32)),
              (rng.normal(scale=0.1, size=(HIDDEN, num_classes)).astype(np.float32),
               np.zeros(num_classes, np.float32))]
    return normed, part, x_pad, y_pad, params


def rank_jobs(part, x_pad, y_pad, train_mask, params, steps: int, **options):
    """One ``"gcn"`` ``ShardJob`` a rank (its row block and edge shard);
    ``options`` go to the job (``timed``, ``warmup``; the rest to the
    step)."""
    npp = part.nodes_per_part
    timed, warmup = options.pop("timed", False), options.pop("warmup", 0)
    options.setdefault("learning_rate", LEARNING_RATE)
    return [[ShardJob("demo_distributed_gcn", "gcn", params, x_pad[r * npp:(r + 1) * npp],
                      y_pad[r * npp:(r + 1) * npp], train_mask[r * npp:(r + 1) * npp],
                      (part.local_row[r], part.global_col[r], part.value[r]), dict(options),
                      steps, warmup=warmup, timed=timed)]
            for r in range(part.num_parts)]


def evaluate(normed, x, params, device="cuda"):
    """The trained weights' logits on the whole graph in one process:
    ``Â·relu(Â·(x W0) + b0) W1 + b1`` through ``SparseMatrix.matmul``."""
    n = x.shape[0]
    adj = SparseMatrix(normed.index.to(device), normed.value.to(device), (n, n))
    (w0, b0), (w1, b1) = [(torch.as_tensor(w, device=device), torch.as_tensor(b, device=device))
                          for w, b in params]
    with torch.no_grad():
        h = torch.relu(adj.matmul(x @ w0) + b0)
        return adj.matmul(h @ w1) + b1


def main(num_steps: int = 100, device="cuda", stats: Optional[dict] = None,
         world_size: Optional[int] = None):
    """Train on ``world_size`` ranks (default: one per card) and evaluate;
    returns the test accuracy. ``stats``, when given, receives ``losses``,
    ``steps``, ``evals``, ``world_size``, ``results`` (each rank's
    ``run_job`` result, its step times with CUDA events after one warm-up
    step) and ``params`` (the initial weights)."""
    graph, (train_index, _, test_index) = load_cora(device=device)
    num_parts = world_size or _card_count()
    normed, part, x_pad, y_pad, params = problem(graph, num_parts)
    train_mask = np.zeros(part.num_nodes_padded, np.float32)
    train_mask[train_index.cpu().numpy()] = 1.0
    steps = demo_steps(num_steps)
    results = [r[0] for r in run_ranks(
        rank_jobs(part, x_pad, y_pad, train_mask, params, steps, timed=stats is not None,
                  warmup=1), backend="gloo", device=device)]
    losses = results[0]["losses"]
    for s in range(0, steps, 20):
        print(f"step {s}: loss={losses[s]:.4f}")
    logits = evaluate(normed, graph.x, results[0]["params"], device)
    y = graph.y.long()
    acc = float((logits.argmax(-1)[test_index] == y[test_index]).float().mean())
    print(f"test accuracy ({num_parts}-way graph-parallel training): {acc:.4f}")
    if stats is not None:
        stats.update(losses=losses, steps=steps, evals=1, world_size=num_parts,
                     results=results, params=params)
    return acc


def _card_count() -> int:
    """The cards on this machine, the ranks' default count; raises where
    there is none (give ``world_size`` and ``device="cpu"`` there)."""
    count = torch.cuda.device_count()
    if count < 1:
        raise RuntimeError("no CUDA device: pass world_size and device='cpu' to run the ranks "
                           "on the CPU")
    return count


def _cli(run):
    """``run()`` on the card, or ``run(device="cpu", world_size=P)`` for
    ``--cpu [P]`` (P = 4 by default)."""
    args = sys.argv[1:]
    if "--cpu" not in args:
        return run()
    rest = args[args.index("--cpu") + 1:]
    return run(device="cpu", world_size=int(rest[0]) if rest and rest[0].isdigit() else 4)


if __name__ == "__main__":
    _cli(main)
