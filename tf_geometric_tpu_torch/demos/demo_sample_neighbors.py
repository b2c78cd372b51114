"""The neighbour-sampling walkthrough (JAX counterpart:
``demo/demo_sample_neighbors.py``): ``RandomNeighborSampler`` with k = 3,
k = 4 padded, ratio 0.5 and k = 3 restricted to a node set, then
``UniformNeighborSampler`` with p = 0.5, on 60 random edges among 12 nodes
from ``default_rng(0)``; the same draws and printed lines as the script.
Returns True.

    python -m tf_geometric_tpu_torch.demos.demo_sample_neighbors

Host only (``utils.graph_utils``, numpy and the native host library): no
kernel and no card. ``device`` is accepted for the twins' common form.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.graph_utils import RandomNeighborSampler, UniformNeighborSampler

__all__ = ["main"]


def main(device="cuda", stats: Optional[dict] = None):
    """Run the walkthrough; ``stats``, when given, receives ``draws``, each
    sampler call's ``(edge_index, edge_weight)`` in call order."""
    draws = []

    def keep(pair):
        draws.append(pair)
        return pair

    rng = np.random.default_rng(0)
    edge_index = rng.integers(0, 12, size=(2, 60)).astype(np.int32)
    sampler = RandomNeighborSampler(edge_index, rng=0)

    ei, ew = keep(sampler.sample(k=3))
    print(f"k=3 sample: {ei.shape[1]} edges")

    ei, ew = keep(sampler.sample(k=4, padding=True))
    counts = np.bincount(ei[0], minlength=12)
    print(f"k=4 padded: every present node has exactly 4: "
          f"{sorted(set(counts[counts > 0].tolist()))}")

    ei, ew = keep(sampler.sample(ratio=0.5))
    print(f"ratio=0.5 sample: {ei.shape[1]} edges")

    sampled_nodes = np.array([0, 2, 4, 6])
    ei, ew = keep(sampler.sample(k=3, sampled_node_index=sampled_nodes))
    print(f"restricted to {sampled_nodes.tolist()}: edge ids < "
          f"{int(ei.max(initial=0)) + 1} (virtual reindexed)")

    uni = UniformNeighborSampler(edge_index, rng=0)
    ei, ew = keep(uni.sample(0.5))
    print(f"uniform p=0.5: {ei.shape[1]} edges")
    if stats is not None:
        stats.update(draws=draws, steps=0, evals=0)
    return True


if __name__ == "__main__":
    main()
