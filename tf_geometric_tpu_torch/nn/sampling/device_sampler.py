"""Device-resident fixed-k neighbour sampling (JAX counterpart:
``tf_geometric_tpu/nn/sampling/device_sampler.py``).

The CSR adjacency (row starts, degrees, row-sorted columns and, unless every
weight is 1, the row-sorted weights) is built once on the host and uploaded;
each draw then runs on the device with no host work. Semantics of the JAX
sampler: exactly k neighbours per node, with replacement, uniform over the
node's edge multiset (an edge's weight rides along, it does not bias the
draw); a node without edges points at itself with weight 0. The draw is
slot-major ``[k, S]``, the layout ``mean_graph_sage_fixed_k`` takes, and
comes back as a ``FixedKDraw`` (``idx``, ``weight``): a named pair, so that
``idx, w = draw`` still unpacks it and ``layers.MeanGraphSage`` tells it
from an edge list.

Randomness comes from a ``torch.Generator`` (where JAX takes a key): the
draw asks it for ``randint(0, 2**31 - 1, (k, S))`` int32, as the JAX draw
asks ``jax.random.randint``; the two give different integers, and the same
integers give the same draw (``ops.fixed_k.draw_fixed_k_plain``).

Spans and counters (``utils.profiling``): ``tfg.setup.sampler_csr`` around
the CSR build and upload, with ``sampling.csr_rows`` and
``sampling.csr_entries``; ``tfg.nn.sampling.draw`` around each draw (its
``randint`` and the draw kernel), with ``sampling.draws`` (calls) and
``sampling.slots`` (k × rows drawn).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...native import build_row_ptr, sort_by_row
from ...ops.fixed_k import FixedKDraw, draw_fixed_k_from_ints
from ...utils.profiling import count, span
from ...utils.union_utils import convert_union_to_numpy

__all__ = ["DeviceNeighborSampler", "FixedKDraw", "draw_fixed_k"]

INT32_MAX = 2 ** 31 - 1


def _random_ints(generator: Optional[torch.Generator], k: int, num_rows: int, device):
    """Uniform int32 in [0, 2**31 - 1): the counterpart of the JAX draw's
    ``jax.random.randint(key, (k, S), 0, iinfo(int32).max)``."""
    return torch.randint(0, INT32_MAX, (k, num_rows), generator=generator, dtype=torch.int32,
                         device=device)


@span("tfg.nn.sampling.draw")
def draw_fixed_k(generator: Optional[torch.Generator], csr: dict, k: int,
                 self_ids=None) -> FixedKDraw:
    """The fixed-k with-replacement draw: a ``FixedKDraw`` (``idx`` int32
    [k, S], ``weight`` float32 [k, S]) over ``csr`` (``row_start``, ``degree``,
    ``sorted_col`` and optionally ``sorted_weight``), with random integers
    from ``generator`` (on the CSR's device; None: PyTorch's default).
    Rows without edges emit ``self_ids`` (default ``arange(S)``) with weight
    0. On CUDA tensors the draw is one kernel after ``torch.randint``."""
    deg = csr["degree"]
    r = _random_ints(generator, k, deg.shape[0], deg.device)
    if self_ids is not None:
        self_ids = torch.as_tensor(self_ids, dtype=torch.int32, device=deg.device)
    count("sampling.draws")
    count("sampling.slots", k * deg.shape[0])
    return FixedKDraw(*draw_fixed_k_from_ints(r, csr, self_ids))


class DeviceNeighborSampler:
    """CSR adjacency on ``device``; ``sample`` draws k neighbours per node.

    ``edge_index`` [2, E] (row = destination), optional ``edge_weight`` [E].
    All-ones weights (and no weights) keep no weight table: the draw then
    writes 1 for every real slot. Rows outside ``[0, num_nodes)`` are
    ignored.
    """

    def __init__(self, edge_index, edge_weight=None, num_nodes: Optional[int] = None,
                 device="cuda"):
        with span("tfg.setup.sampler_csr"):
            edge_index = convert_union_to_numpy(edge_index, np.int64)
            if num_nodes is None:
                num_nodes = int(edge_index.max()) + 1 if edge_index.size else 0
            self.num_nodes = num_nodes
            weight_np = (None if edge_weight is None
                         else convert_union_to_numpy(edge_weight, np.float32))
            order = sort_by_row(edge_index[0], num_nodes)
            row_ptr = build_row_ptr(edge_index[0], num_nodes)
            self.row_start = torch.as_tensor(row_ptr[:-1].astype(np.int32), device=device)
            self.degree = torch.as_tensor((row_ptr[1:] - row_ptr[:-1]).astype(np.int32),
                                          device=device)
            self.sorted_col = torch.as_tensor(edge_index[1][order].astype(np.int32),
                                              device=device)
            if weight_np is None or np.all(weight_np == 1.0):
                self.sorted_weight = None
            else:
                self.sorted_weight = torch.as_tensor(weight_np[order], device=device)
        count("sampling.csr_rows", num_nodes)
        count("sampling.csr_entries", int(row_ptr[-1]))

    def csr(self) -> dict:
        """The device arrays as a dict (the JAX sampler's ``csr_pytree()``)."""
        return {"row_start": self.row_start, "degree": self.degree,
                "sorted_col": self.sorted_col, "sorted_weight": self.sorted_weight}

    def sample(self, generator: Optional[torch.Generator], k: int,
               csr: Optional[dict] = None) -> FixedKDraw:
        """Draw k neighbours per node → ``FixedKDraw(idx [k, N], weight [k, N])``:
        weight 1 (or the edge's weight) on real draws, 0 on the self-slots
        of nodes without edges. ``csr`` overrides the sampler's arrays."""
        return draw_fixed_k(generator, csr if csr is not None else self.csr(), k)
