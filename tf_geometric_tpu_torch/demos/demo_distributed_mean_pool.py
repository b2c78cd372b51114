"""Data-parallel graph classification (JAX counterpart:
``demo/demo_distributed_mean_pool.py``, a ``shard_map`` over the ``data``
axis): padded batches of 8 graphs a rank (one ``batch_padding_spec`` over
train ∪ test of ``load_graph_classification_data("NCI1")``'s 90/10
``train_test_split``), each re-blocked so that rank d owns graphs
[8d, 8d + 8) with local ids (``shard_batch``, the script's, bit for bit,
its edge capacity cut included); per rank one mean-aggregation GCN layer
(hidden 32, relu), a per-graph mean readout and a dense head, weights from
``default_rng(0)`` at scale 0.1; Adam 5e-3, 150 steps, as
``torch.distributed`` ranks through ``parallel.run_ranks`` and
``parallel.make_data_parallel_step``. Then the test batches, each rank's
block through ``local_forward`` in this process. Returns the test accuracy.

    python -m tf_geometric_tpu_torch.demos.demo_distributed_mean_pool            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_distributed_mean_pool --cpu 4

The ranks default to one per card (the script's ``len(jax.devices())``)
over gloo. Each rank differentiates its masked cross-entropy sum over the
all-reduced label count and the gradients are all-reduced once: the true
gradient of the global mean. The script's step ``psum``s the loss inside
``value_and_grad`` and then the gradients (``:73-77``), which hands Adam P
times it (ROADMAP §3). The step runs segment sums only (``index_add``): no
custom kernel.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..parallel.runner import ShardJob, run_ranks
from ..parallel.sharded import sharded_spmm_local
from .demo_distributed_gcn import _card_count, _cli
from .demo_utils import (batch_padding_spec, demo_steps, load_graph_classification_data,
                         padded_batch_generator, train_test_split)

__all__ = ["local_forward", "shard_batch", "initial_params", "rank_jobs", "main", "HIDDEN",
           "PER_DEVICE_GRAPHS", "LEARNING_RATE"]

HIDDEN = 32
PER_DEVICE_GRAPHS = 8
LEARNING_RATE = 5e-3


def local_forward(params, x, rows, cols, vals, ngi):
    """One rank's logits [G, C] on its self-contained block: the mean
    aggregation (``vals``-weighted sum over the row's edges, over their sum
    + 1e-6; padded edges at row ``npd`` dropped), ``relu(· w0 + b0)``, the
    mean over each graph's nodes (padded nodes at graph G dropped), the
    dense head."""
    w0, b0, wd, bd = params
    npd, G = x.shape[0], PER_DEVICE_GRAPHS
    rows_safe = rows.long().clamp(0, npd)
    deg = vals.new_zeros(npd + 1).index_add(0, rows_safe, vals)[:npd] + 1e-6
    agg = sharded_spmm_local(x, rows, cols, vals, npd)
    h = torch.relu((agg / deg[:, None]) @ w0 + b0)
    ids = ngi.long().clamp(0, G)
    cnt = h.new_zeros(G + 1).index_add(0, ids, torch.ones_like(ids, dtype=h.dtype))[:G]
    pooled = h.new_zeros((G + 1, h.shape[1])).index_add(0, ids, h)[:G]
    return (pooled / cnt.clamp(min=1.0)[:, None]) @ wd + bd


def shard_batch(batch, real: int, num_devices: int, nodes_per_dev: int,
                per_device_graphs: int = PER_DEVICE_GRAPHS):
    """The script's re-blocking of one padded batch: per rank d, graphs
    [d·G, (d+1)·G) with local node and graph ids, ``(x [npd, F], rows
    [Ecap], cols, vals, ngi [npd], y [G], mask [G])``, the edge capacity
    ``ceil((E/P + 1) / 64)·64`` (edges past it are cut, as the script cuts
    them). Returns the list of the ranks' tuples (numpy)."""
    x = np.asarray(batch.x)
    ei = np.asarray(batch.edge_index)
    ew = np.asarray(batch.edge_weight)
    ngi = np.asarray(batch.node_graph_index)
    y_flat = np.asarray(batch.y).flatten()
    edge_cap = ei.shape[1] // num_devices + 1
    edge_cap = -(-edge_cap // 64) * 64
    out = []
    for d in range(num_devices):
        g_lo, g_hi = d * per_device_graphs, (d + 1) * per_device_graphs
        nmask = (ngi >= g_lo) & (ngi < g_hi)
        node_ids = np.nonzero(nmask)[0]
        lookup = np.full(len(ngi) + 1, -1, np.int64)
        lookup[node_ids] = np.arange(len(node_ids))
        xd = np.zeros((nodes_per_dev, x.shape[1]), np.float32)
        xd[:len(node_ids)] = x[node_ids]
        ngid = np.full(nodes_per_dev, per_device_graphs, np.int32)
        ngid[:len(node_ids)] = ngi[node_ids] - g_lo
        emask = nmask[np.clip(ei[0], 0, len(ngi) - 1)] \
            & (ei[0] < len(ngi)) & nmask[np.clip(ei[1], 0, len(ngi) - 1)]
        er = lookup[ei[0][emask]]
        ec = lookup[ei[1][emask]]
        ev = ew[emask]
        rd = np.full(edge_cap, nodes_per_dev, np.int32)
        cd = np.zeros(edge_cap, np.int32)
        vd = np.zeros(edge_cap, np.float32)
        k = min(len(er), edge_cap)
        rd[:k], cd[:k], vd[:k] = er[:k], ec[:k], ev[:k]
        yd = np.zeros(per_device_graphs, np.int32)
        md = np.zeros(per_device_graphs, np.float32)
        n_real = min(max(real - g_lo, 0), per_device_graphs)
        yd[:n_real] = y_flat[g_lo:g_lo + n_real]
        md[:n_real] = 1.0
        out.append((xd, rd, cd, vd, ngid, yd, md))
    return out


def initial_params(num_features: int, num_classes: int):
    """``(w0, b0, wd, bd)``, numpy: the script's draws from
    ``default_rng(0)`` at scale 0.1, zero biases."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(scale=0.1, size=(num_features, HIDDEN)).astype(np.float32)
    wd = rng.normal(scale=0.1, size=(HIDDEN, num_classes)).astype(np.float32)
    return (w0, np.zeros(HIDDEN, np.float32), wd, np.zeros(num_classes, np.float32))


def rank_jobs(step_blocks, params, **options):
    """One ``"data"`` ``ShardJob`` a rank: ``step_blocks[s][r]`` is rank r's
    block of step s (``shard_batch``), stacked over the steps; ``options``
    go to the job (``timed``, ``warmup``; the rest to the step)."""
    timed, warmup = options.pop("timed", False), options.pop("warmup", 0)
    options.setdefault("learning_rate", LEARNING_RATE)
    options["forward"] = local_forward
    world, steps = len(step_blocks[0]), len(step_blocks)
    empty = np.zeros(0, np.float32)
    return [[ShardJob("demo_distributed_mean_pool", "data", params, empty, empty, empty,
                      tuple(np.stack([blocks[r][k] for blocks in step_blocks]) for k in range(7)),
                      dict(options), steps, warmup=warmup, timed=timed)]
            for r in range(world)]


def main(num_steps: int = 150, device="cuda", stats: Optional[dict] = None,
         world_size: Optional[int] = None):
    """Train on ``world_size`` ranks (default: one per card) and evaluate;
    returns the test accuracy. ``stats``, when given, receives ``losses``,
    ``steps``, ``evals`` (test batches), ``world_size``, ``results`` (each
    rank's ``run_job`` result, its step times with CUDA events after one
    warm-up step), ``params`` (the initial weights) and ``blocks`` (each
    step's per-rank blocks)."""
    num_devices = world_size or _card_count()
    batch_size = PER_DEVICE_GRAPHS * num_devices
    graphs, num_classes = load_graph_classification_data("NCI1")
    train_graphs, test_graphs = train_test_split(graphs, test_size=0.1, random_state=0)
    # one padding spec over train ∪ test: the test batches take the
    # training step's per-rank node capacity
    shared_spec = batch_padding_spec(graphs, batch_size)
    gen = padded_batch_generator(train_graphs, batch_size, spec=shared_spec)
    batch, _ = next(gen)
    nodes_per_dev = batch.x.shape[0] // num_devices
    params = initial_params(batch.x.shape[1], num_classes)
    steps = demo_steps(num_steps)
    blocks = [shard_batch(*next(gen), num_devices, nodes_per_dev) for _ in range(steps)]
    results = [r[0] for r in run_ranks(
        rank_jobs(blocks, params, timed=stats is not None, warmup=1), backend="gloo",
        device=device)]
    losses = results[0]["losses"]
    for s in range(0, steps, 30):
        print(f"step {s}: loss={losses[s]:.4f}")

    trained = tuple(torch.as_tensor(p, device=device) for p in results[0]["params"])
    correct = total = evals = 0
    with torch.no_grad():
        for batch, real in padded_batch_generator(test_graphs, batch_size, shuffle=False,
                                                  infinite=False, spec=shared_spec):
            evals += 1
            for xd, rd, cd, vd, ngid, yd, md in shard_batch(batch, real, num_devices,
                                                            nodes_per_dev):
                args = (torch.as_tensor(a, device=device) for a in (xd, rd, cd, vd, ngid))
                preds = local_forward(trained, *args).argmax(-1).cpu().numpy()
                mask = md > 0
                correct += int((preds[mask] == yd[mask]).sum())
                total += int(mask.sum())
    acc = correct / max(total, 1)
    print(f"test accuracy ({num_devices}-way data-parallel): {acc:.4f}")
    if stats is not None:
        stats.update(losses=losses, steps=steps, evals=evals, world_size=num_devices,
                     results=results, params=params, blocks=blocks)
    return acc


if __name__ == "__main__":
    _cli(main)
