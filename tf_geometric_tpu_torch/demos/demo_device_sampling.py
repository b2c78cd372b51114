"""Neighbour-sampled GraphSAGE with the draws on the device (JAX
counterpart: ``demo/demo_device_sampling.py``): the CSR adjacency is
uploaded once (``DeviceNeighborSampler``); every step draws k = 10 and
k = 5 neighbours for every node and runs two ``mean_graph_sage_fixed_k``
layers of 64 (two halves of 32) and a dense head, numpy-initialized; the
softmax cross-entropy over the training nodes, Adam 1e-2, 120 steps; the
validation accuracy every 20 steps and the test accuracy at the end, each
on one fixed evaluation draw.

    python -m tf_geometric_tpu_torch.demos.demo_device_sampling            # on the card
    python -m tf_geometric_tpu_torch.demos.demo_device_sampling --cpu

On the card each draw is the fixed-k draw kernel (``csrc/fixed_k.cu``, X8)
and each layer's neighbour sum is the fixed-k aggregation (S1) at F = 32
(the projection runs first where the output is narrower), forward and
backward. The draws' integers come from a ``torch.Generator``; a step
takes given integers instead (``ints``), as the tests hand it JAX's.
"""
from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.conv.graph_sage import mean_graph_sage_fixed_k
from ..nn.sampling.device_sampler import DeviceNeighborSampler
from ..ops.fixed_k import draw_fixed_k_from_ints
from .demo_utils import demo_steps, load_cora

__all__ = ["SampledSageParams", "build", "forward", "train_step", "predict", "main",
           "NUM_SAMPLED_NEIGHBORS", "HIDDEN", "NUM_STEPS", "LEARNING_RATE", "INIT_SCALE",
           "TRAIN_SEED", "EVAL_SEED"]

NUM_SAMPLED_NEIGHBORS = (10, 5)
HIDDEN, NUM_STEPS, LEARNING_RATE, INIT_SCALE = 64, 120, 1e-2, 0.1
# the training draws' generator seed (JAX: PRNGKey(42)) and the evaluation
# draw's, seeded anew at each evaluation (JAX: the last of the split keys)
TRAIN_SEED, EVAL_SEED = 42, 43


class SampledSageParams(nn.Module):
    """The demo's parameters, drawn as the JAX demo draws them
    (``default_rng(seed)`` normals of scale 0.1 in the order ``s0 n0 s1 n1
    wd``, zero biases): both layers' self and neighbour kernels [in, 32],
    their biases [64], the head ``wd`` [64, C] and ``bd``."""

    def __init__(self, in_features: int, num_classes: int, seed: int = 0, device="cuda"):
        super().__init__()
        rng = np.random.default_rng(seed)
        half = HIDDEN // 2
        shapes = {"s0": (in_features, half), "n0": (in_features, half), "b0": HIDDEN,
                  "s1": (HIDDEN, half), "n1": (HIDDEN, half), "b1": HIDDEN,
                  "wd": (HIDDEN, num_classes), "bd": num_classes}
        for name, shape in shapes.items():
            value = (np.zeros(shape) if isinstance(shape, int)
                     else rng.normal(scale=INIT_SCALE, size=shape))
            self.register_parameter(name, nn.Parameter(
                torch.tensor(value, dtype=torch.float32, device=device)))


def build(graph, seed: int = 0, device="cuda"):
    """The sampler over ``graph`` (its CSR on ``device``), the parameters
    and their Adam optimizer."""
    sampler = DeviceNeighborSampler(graph.edge_index, graph.edge_weight,
                                    num_nodes=graph.num_nodes, device=device)
    params = SampledSageParams(graph.num_features, int(graph.y.max()) + 1, seed, device)
    return sampler, params, torch.optim.Adam(params.parameters(), lr=LEARNING_RATE)


def forward(p: SampledSageParams, sampler: DeviceNeighborSampler, x, generator=None,
            ints=None):
    """Logits over every node: the two draws (from ``generator``, or from
    the integers ``ints`` [k, N] of each), two fixed-k mean layers with
    relu, the dense head."""
    csr = sampler.csr()
    draws = [sampler.sample(generator, k, csr=csr) if ints is None
             else draw_fixed_k_from_ints(ints[i], csr)
             for i, k in enumerate(NUM_SAMPLED_NEIGHBORS)]
    (i0, w0), (i1, w1) = draws
    h = mean_graph_sage_fixed_k(x, i0, w0, p.s0, p.n0, bias=p.b0, activation=torch.relu)
    h = mean_graph_sage_fixed_k(h, i1, w1, p.s1, p.n1, bias=p.b1, activation=torch.relu)
    return h @ p.wd + p.bd


def train_step(p, optimizer, sampler, graph, train_mask, generator=None, ints=None):
    """One Adam step on the masked mean cross-entropy; returns the loss
    (detached)."""
    optimizer.zero_grad(set_to_none=True)
    ce = F.cross_entropy(forward(p, sampler, graph.x, generator, ints), graph.y.long(),
                         reduction="none")
    loss = (ce * train_mask).sum() / train_mask.sum()
    loss.backward()
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def predict(p, sampler, x, ints=None):
    """The classes on the evaluation draw (a generator seeded
    ``EVAL_SEED``, or ``ints``)."""
    generator = torch.Generator(device=x.device).manual_seed(EVAL_SEED)
    return forward(p, sampler, x, generator, ints).argmax(-1)


def main(device="cuda", num_steps: int = NUM_STEPS, stats: Optional[dict] = None):
    """Train on ``load_cora``; returns the test accuracy. ``stats``
    receives ``steps``, ``losses`` and ``evals`` (evaluation forwards)."""
    graph, (train_index, valid_index, test_index) = load_cora(device=device)
    sampler, p, optimizer = build(graph, 0, device)
    y = graph.y.long()
    train_mask = torch.zeros(graph.num_nodes, device=device)
    train_mask[train_index] = 1.0
    generator = torch.Generator(device=device).manual_seed(TRAIN_SEED)
    losses, evals = [], 0
    num_steps = demo_steps(num_steps)
    for i in range(num_steps):
        losses.append(train_step(p, optimizer, sampler, graph, train_mask, generator))
        if i % 20 == 0:
            pred = predict(p, sampler, graph.x)
            evals += 1
            acc = float((pred[valid_index] == y[valid_index]).float().mean())
            print(f"step {i}: loss={float(losses[-1]):.4f} valid_acc={acc:.4f}")
    pred = predict(p, sampler, graph.x)
    test_acc = float((pred[test_index] == y[test_index]).float().mean())
    print(f"test accuracy: {test_acc:.4f}")
    if stats is not None:
        stats.update(steps=num_steps, losses=losses, evals=evals + 1)
    return test_acc


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
