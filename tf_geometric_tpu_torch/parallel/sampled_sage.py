"""Node-partitioned, neighbour-sampled mean GraphSAGE over
``torch.distributed`` (JAX counterpart:
``tf_geometric_tpu/parallel/sampled_sage.py``, whose step runs under
``shard_map``).

The nodes live in contiguous blocks, one per rank of the ``graph`` process
group; each rank holds the CSR rows of its block (``build_csr_shards``),
with GLOBAL column ids, and draws its own fixed-k neighbours on the device
in every layer. The mean aggregator is linear, so each layer projects its
rows with the neighbour kernel first, all-gathers the PROJECTED table
(F_out-wide rows instead of F_in-wide ones) and aggregates against it with
the fixed-k kernel (``ops.fixed_k.fixed_k_aggregate``): ids drawn over the
whole graph index the gathered table directly. Sampled neighbours are
uniform over the graph, so no halo plan helps: the all-gather is the
exchange. The all-gather's backward sums each rank's slice of the table
gradient over the ranks (``sharded._AllGather``).

Kernels per rank and step: per layer one draw (``fixed_k_draw``), one
aggregation forward and one backward call.

Differences from the JAX step, by design:
- The gradient. The JAX step ``psum``s gradients that ``shard_map`` has
  already summed over the devices, so Adam gets P times the gradient of its
  loss; here each rank differentiates ``local_sum / global_count`` and one
  all-reduce sums the gradients (``sharded._finish_step``): Adam gets the
  gradient of the loss.
- The random integers. JAX folds the device index and the layer into the
  step key; here each rank draws from its own ``torch.Generator`` (seeded by
  the caller), or takes the integers it is given (``ints``, the way the
  tests hand both frameworks the same draw).
- Ids. JAX clips each drawn id to the gathered table; the fixed-k kernel
  needs ids below the table's rows and the draw gives them (a column id of
  the graph, or the row's own global id): the CPU path checks it.
- With a bfloat16 exchange the aggregation's float32 sums are rounded to
  bfloat16 once before the division by k, where JAX divides in float32.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..convert import sharded_params_from_numpy
from ..native import build_row_ptr, sort_by_row
from ..nn.sampling.device_sampler import _random_ints
from ..ops.fixed_k import draw_fixed_k_from_ints, fixed_k_aggregate
from .sharded import GraphMesh, _AllGather, _adam, _finish_step, _masked_ce_sum

__all__ = ["build_csr_shards", "init_sampled_sage_params", "make_sampled_sage_step",
           "set_exchange_dtype"]

# dtype the projected table crosses the all-gather in (None: float32), as
# the JAX module's; bfloat16 halves the exchange's bytes and those of the
# table gradient's all-to-all in the backward
exchange_dtype = None


def set_exchange_dtype(dtype) -> None:
    """Set the dtype of the exchanged table (None, or ``torch.bfloat16``)."""
    global exchange_dtype
    exchange_dtype = dtype


def build_csr_shards(edge_index, num_nodes: int, num_parts: int, edge_weight=None) -> dict:
    """The CSR adjacency in ``num_parts`` contiguous node blocks, as numpy
    arrays with a leading part dimension: ``row_start`` [P, n_local]
    (offsets into the part's own column shard), ``degree`` [P, n_local],
    ``sorted_col`` [P, e_max] (GLOBAL column ids, zero-padded; no draw
    reaches the padding) and, with ``edge_weight``, ``sorted_weight``
    [P, e_max]; ``e_max`` is the largest part's edge count rounded up to a
    multiple of 128. Raises when ``num_parts`` does not divide
    ``num_nodes`` (pad the graph first)."""
    if num_nodes % num_parts:
        raise ValueError(f"num_nodes={num_nodes} not divisible by "
                         f"num_parts={num_parts}; pad the graph first")
    n_local = num_nodes // num_parts
    edge_index = np.asarray(edge_index, np.int64)
    weight = None if edge_weight is None else np.asarray(edge_weight, np.float32)
    order = sort_by_row(edge_index[0], num_nodes)
    row_ptr = build_row_ptr(edge_index[0], num_nodes)
    col_sorted = edge_index[1][order].astype(np.int32)
    w_sorted = None if weight is None else weight[order]
    block_edges = [row_ptr[(p + 1) * n_local] - row_ptr[p * n_local] for p in range(num_parts)]
    e_max = max(1, int(-(-max(block_edges) // 128) * 128))
    row_start = np.zeros((num_parts, n_local), np.int32)
    degree = np.zeros((num_parts, n_local), np.int32)
    sorted_col = np.zeros((num_parts, e_max), np.int32)
    sorted_weight = None if w_sorted is None else np.zeros((num_parts, e_max), np.float32)
    for p in range(num_parts):
        lo, hi = row_ptr[p * n_local], row_ptr[(p + 1) * n_local]
        rp = row_ptr[p * n_local:(p + 1) * n_local + 1] - lo
        row_start[p] = rp[:-1]
        degree[p] = rp[1:] - rp[:-1]
        sorted_col[p, :hi - lo] = col_sorted[lo:hi]
        if sorted_weight is not None:
            sorted_weight[p, :hi - lo] = w_sorted[lo:hi]
    shards = {"row_start": row_start, "degree": degree, "sorted_col": sorted_col}
    if sorted_weight is not None:
        shards["sorted_weight"] = sorted_weight
    return shards


def _sampled_mean_layer(x_local, csr, k: int, self_kernel, neighbor_kernel, bias,
                        mesh: GraphMesh, activation, generator=None, ints=None):
    """One mean-SAGE layer on this rank's rows: project with the neighbour
    kernel, all-gather the projected table (in ``exchange_dtype``), draw k
    neighbours per row against global ids (``ints`` [k, n_local], or fresh
    integers from ``generator``), aggregate the gathered table's rows in
    float32, then ``[x·self ‖ mean] + bias`` and the activation."""
    hw_local = x_local @ neighbor_kernel
    if exchange_dtype is not None:
        hw_local = hw_local.to(exchange_dtype)
    hw_global = _AllGather.apply(hw_local, mesh)
    n_local = x_local.shape[0]
    # rows without edges point at their own GLOBAL id with weight 0
    self_ids = (mesh.rank * n_local
                + torch.arange(n_local, dtype=torch.int32, device=x_local.device)).int()
    r = ints if ints is not None else _random_ints(generator, k, n_local, x_local.device)
    idx, weight = draw_fixed_k_from_ints(r, csr, self_ids)
    if not idx.is_cuda and idx.numel() and not bool(
            ((idx >= 0) & (idx < hw_global.shape[0])).all()):
        raise ValueError(f"a drawn id lies outside the gathered table of "
                         f"{hw_global.shape[0]} rows")
    mean = fixed_k_aggregate(hw_global, idx, weight).float() / k
    h = torch.cat([x_local @ self_kernel, mean], dim=1) + bias
    return activation(h) if activation is not None else h


def init_sampled_sage_params(rng: np.random.Generator, num_features: int, num_classes: int,
                             num_layers: int = 2, hidden: int = 256) -> list:
    """The step's initial weights as numpy float32, from a numpy
    ``Generator`` with the JAX ``init_params``' calls in its order: per
    layer ``(self, nb, bias)`` (kernels [f_in, hidden // 2], normals at
    scale 0.05; a zero bias [hidden]), then ``(w, b)`` to the classes."""
    params, f_in = [], num_features
    for _ in range(num_layers):
        self_kernel = rng.normal(scale=0.05, size=(f_in, hidden // 2))
        neighbor_kernel = rng.normal(scale=0.05, size=(f_in, hidden // 2))
        params.append((self_kernel.astype(np.float32), neighbor_kernel.astype(np.float32),
                       np.zeros(hidden, np.float32)))
        f_in = hidden
    params.append((rng.normal(scale=0.05, size=(f_in, num_classes)).astype(np.float32),
                   np.zeros(num_classes, np.float32)))
    return params


def make_sampled_sage_step(mesh: GraphMesh, csr_shard: dict, num_features: int,
                           num_classes: int, k: Sequence[int] = (25, 10), hidden: int = 256,
                           learning_rate: float = 1e-2):
    """``(step, init_params, make_optimizer)`` for node-partitioned sampled
    mean-SAGE on this rank's ``csr_shard`` (part ``mesh.rank`` of
    ``build_csr_shards``' arrays as tensors on the step's device;
    ``sorted_weight`` may be absent or None).

    ``init_params(rng, device)``: ``init_sampled_sage_params`` as float32
    leaf tensors on ``device`` that require grad. ``make_optimizer(params)``:
    Adam at ``learning_rate``. ``step(params, optimizer, generator,
    x_local, y_local, mask_local, ints=None)``: one training step over this
    rank's rows (the masked mean cross-entropy over all ranks' rows); the
    draws take ``ints[layer]`` [k, n_local] where given, else integers from
    ``generator``. Returns the global loss; ``.grad`` holds the gradient
    Adam was given."""
    num_layers = len(k)

    def init_params(rng: np.random.Generator, device="cuda"):
        return sharded_params_from_numpy(
            init_sampled_sage_params(rng, num_features, num_classes, num_layers, hidden), device)

    def step(params, optimizer, generator: Optional[torch.Generator], x_local, y_local,
             mask_local, ints=None):
        h = x_local
        for li in range(num_layers):
            self_kernel, neighbor_kernel, bias = params[li]
            h = _sampled_mean_layer(h, csr_shard, int(k[li]), self_kernel, neighbor_kernel,
                                    bias, mesh, F.relu, generator,
                                    None if ints is None else ints[li])
        w, b = params[-1]
        return _finish_step(mesh, params, optimizer,
                            _masked_ce_sum(h @ w + b, y_local, mask_local), mask_local)

    return step, init_params, _adam(learning_rate)
