"""Training-step benchmark on the ogbn-arxiv-shaped graph (the port's twin
of workloads 1, 1b and 3 of the repository's ``bench.py``), on the
Reddit-shaped graph (the twin of ``benchmarks/sage_sampling_throughput.py``
in its ``device`` mode) and on a padded batch of small graphs (the twin of
``benchmarks/graph_classification_throughput.py``). With ``--tiled-ab``,
instead, the twin of ``benchmarks/tiled_spmm_ab.py`` (``tiled_ab``).

Prints one JSON line per workload: {"metric", "value", "unit", "vs_baseline"};
before each GIN and pool line, one with its real and padded edges per second;
before workload 18's, one with its host draw and copy ms per step.

1. ``gcn_arxiv_fwd_bwd``: a full training step (forward, backward, Adam) of
   the 2-layer GCN, HIDDEN 256, with the full-batch precompute ``P = Â·x``
   (layer 1's SpMM operand never changes), so the step runs one SpMM at
   width 40 and its transpose in the backward.
2. ``gcn_arxiv_canonical_fwd_bwd``: the same model without the precompute:
   SpMMs at widths 256 and 40, each with its transpose in the backward.
3. ``gat_arxiv_fwd_bwd``: a full training step of the 8-head GAT (8 × 32 =
   256 units) over the self-looped graph, then a dense layer to the 40
   classes: Q = relu(x Wq + bq), K = relu(x Wk + bk), V = x Wv, the fused
   attention (forward kernel, two backward kernels), ``h Wd + bd``.
4. ``sage_reddit_fwd_bwd``: a full training step of the sampled GraphSAGE on
   the Reddit-shaped graph (232,965 nodes, 11,606,919 edges, 602 features,
   41 classes): a fresh fixed-k draw for every node at each layer (k = 25,
   then 10: the draw kernel after ``torch.randint``), two
   ``mean_graph_sage_fixed_k`` layers (self and neighbour kernels to 128
   each, concatenated to 256, ReLU, no bias; both narrow the width, so each
   layer projects first and aggregates 128-wide rows through the fixed-k
   kernel and its backward), a dense layer to the classes, mean softmax
   cross-entropy over all nodes, Adam at 1e-2. Weights are the JAX
   benchmark's: ``default_rng(0)`` normals at scale 0.05 drawn after the
   graph (s0, n0, s1, n1, wd). The draws come from a ``torch.Generator``
   seeded with 0 when the weights are made.

5. ``gat_merged_arxiv_fwd_bwd``: a GAT whose query and key heads are
   narrower than its value heads, at the widths of the repository's one
   such configuration, the first layer of
   ``benchmarks/node_classification/bench_node_cls_early_stop_gat.py:44``
   (8 heads, units 64, attention units 8: d_q = 1, d_v = 8), on the
   self-looped arxiv graph with workload 3's structure (relu on Q and K,
   a dense layer to the 40 classes). It takes ``gat``'s merged-head
   branch: scores and the per-head softmax in PyTorch, then the multi-head
   SpMM (its forward, and ``d_att`` and ``dV`` in the backward), all
   float32 as the JAX branch runs; weights ``default_rng(1)`` normals at
   scale 0.05 (wq, wk, wv, wd), zero biases, Adam 1e-3.
6. ``gin_sum_pool_fwd_bwd`` and 7. ``gin_sort_pool_fwd_bwd``: the twins of
   ``benchmarks/graph_classification_throughput.py``: the offline graph set
   of 600 graphs (``synthetic_graph_classification``), its first batch of
   ``GIN_BATCH`` = 128 graphs padded by ``padded_batch_generator``
   (2,560 nodes, 12,928 edges), 3 ``GIN`` layers (MLP ``Dense(64)`` → relu
   → ``Dense(64)``, then relu), then ``sum_pool`` → ``Dense(2)``, or
   ``sort_pool(k=16)`` → [128, 16·64] → ``Dense(2)``; softmax cross-entropy,
   Adam 1e-3, float32. Each GIN layer's ``A·h`` is the COO SpMM (forward at
   widths 4, 64, 64; ``dh`` at 64, 64). Weights: flax's layout from
   ``default_rng(0)`` (``init_gin_flax_params``), carried over by
   ``convert.gin_classifier_state_dict_from_flax``.
8. ``gcn_arxiv_halo_p4_fwd_bwd`` and 9. ``gat_arxiv_halo_p4_fwd_bwd``: the
   graph-parallel steps of ``benchmarks/scaling.py`` (``measure(4, graph,
   model="gcn" | "gat_full")`` with ``TFG_SCALING_LAYOUT=ell``) on the arxiv
   graph partitioned over ``HALO_PARTS`` = 4 ranks (``partition_order``, then
   ``partition_edges_by_row`` and the halo plan), each rank a spawned process
   (``parallel/runner.py``). The halo GCN: 2 layers, hidden 64, Adam 1e-2,
   the normalized adjacency, ``ell_spmm`` on each rank's local and remote
   blocks. The fused halo GAT: ``layer_dims = ((8, 8), (1, 64))``, attention
   and feature dropout 0.6, Adam 5e-3, over the self-looped graph. Weights:
   ``default_rng(0)`` normals at scale 0.1, zero biases, in ``scaling.py``'s
   order; float32. The dropout masks come from one ``torch.Generator`` per
   rank (``scaling.py`` fixes the step key instead). Each rank times its
   steps with CUDA events; the line reports the slowest rank's median step
   and counts the partition's real edges, as ``scaling.py`` does, with the
   plan's ``halo_fraction`` and ``cap``. The ranks share one card over gloo,
   so the number is that of 4 ranks sharing one H100, not of 4 cards.
10. ``sgc_arxiv_fwd_bwd``, 11. ``appnp_arxiv_fwd_bwd`` and 12.
   ``ssgc_arxiv_fwd_bwd``: the propagation family at the widths, dropouts and
   learning rates of ``benchmarks/node_classification/
   bench_node_cls_early_stop_{sgc,appnp,ssgc}.py`` on the arxiv graph, 40
   classes: ``SGC(units=40, k=2)``, Adam 0.2; ``APPNP([64, 40], k=10,
   alpha=0.1, dense_drop_rate=0.5, edge_drop_rate=0.5)``, Adam 5e-3; the same
   ``SSGC`` behind an input dropout of 0.5, Adam 5e-3. Mean cross-entropy
   over all nodes plus ``l2_loss`` on the kernels (5e-6, 1e-3, 1e-3, the
   benches' coefficients). Every hop is Kernel A (and Kernel B on a side
   with hub rows) over the cached CSR adjacency in float32, forward and
   ``dh``; APPNP and SSGC re-skin the dropped edge values onto it each step.
   Weights: glorot-uniform from ``default_rng(2)``, zero biases; the dropout
   masks come from the problem's ``torch.Generator``, reseeded with the
   weights. Dense products float32.
13. ``sage_arxiv_sampled_p4_fwd_bwd``: the node-partitioned sampled SAGE of
   ``benchmarks/scaling.py`` (``measure(4, graph, model="sage")``) on the
   arxiv graph in its own order (sampling is uniform over the graph, so
   no partition ordering), nodes padded to a multiple of 128 × 4 (169,472;
   42,368 a rank), each rank a spawned process sharing one card over gloo
   (``parallel/sampled_sage.py``): k = (25, 10), hidden 128 (tables 64
   wide), 40 classes, Adam 1e-2, a float32 exchange; weights
   ``init_sampled_sage_params(default_rng(0))``, the draws from one
   ``torch.Generator`` per rank. Per rank and step: 2 draws, 2 aggregations
   forward and 2 backward calls against the all-gathered table of 169,472
   rows. The line counts ``num_nodes · 35`` sampled edges over the slowest
   rank's median step, as ``scaling.py`` does.
14. ``diff_pool_graphs_fwd_bwd``, 15. ``min_cut_pool_graphs_fwd_bwd`` and
   16. ``sag_pool_graphs_fwd_bwd``: the twins of the pooling demos' models
   (``demo/demo_diff_pool.py``, ``demo_min_cut_pool.py``,
   ``demo_sag_pool_h.py``) at their widths, on the GIN workloads' batch, Adam
   at 5e-3 (``demo_utils.run_graph_classification``'s rate), mean softmax
   cross-entropy (15: plus the cut and orthogonality losses), dropout 0.4
   from the problem's ``torch.Generator``. 14: two DiffPool levels of 8 and
   4 clusters (feature ``GCN(32, relu)``, assign ``GCN(C)``), a
   ``max_pool`` readout per level, ``Dense(64)``, relu, the head; 15:
   ``GCN(32, relu)``, MinCutPool of 8 clusters, ``mean_pool``, the head; 16:
   two levels of ``GCN(32, relu)`` and SAGPool (score ``GCN(1)``, k = 8,
   tanh), a ``mean_pool`` readout per level, the head. Every GCN runs
   without a cache: the COO SpMM (X6) forward and ``dh``, and in 14's
   second level, whose edge weights are the first level's S^T A S, the
   ``dv`` SDDMM. Weights: glorot-uniform matrices from a ``torch.Generator``
   seeded ``POOL_SEED``, zero vectors. The lines count graphs/s. The ASAP
   and Set2Set models (``demo_asap.py``, ``demo_set2set.py``) are here for
   chip_smoke.py, without a workload.

17. ``mincut_arxiv_p4_fwd_bwd``: the edge-partitioned MinCutPool step of
   ``benchmarks/scaling.py`` (``measure(4, graph, model="mincut")``,
   ``parallel/sharded.make_graph_parallel_mincut_step``) on the arxiv graph
   in ``partition_order``'s permutation, its symmetric-normalized adjacency
   without self-loops (``adj_norm_edge(..., add_self_loop=False)``)
   partitioned into 4 row blocks of 42,336 nodes, each rank a spawned
   process sharing one card over gloo: hidden 64, C = 32 clusters, 40
   classes, Adam 1e-2, the cut and orthogonality losses; weights
   ``default_rng(0)`` normals at scale 0.1 in ``scaling.py``'s order (w0,
   wa, wc, wo), zero biases; float32. Per rank and step 4 Kernel A launches
   on the rank's rectangular [42,336, 169,344] block: the encoder and
   assignment aggregation at F = 96 and ``Ã·S`` at F = 32, each with its
   ``dh``. The line counts the normalized adjacency's nonzeros over the
   slowest rank's median step, as ``scaling.py`` counts the partition's
   real edges.

18. ``sage_reddit_dense_fwd_bwd``: ``benchmarks/sage_sampling_throughput.py``
   with ``SAGE_BENCH_MODE=dense``: workload 4's graph, weights and layers,
   but the draw made on the host by ``RandomNeighborSampler(edge_index,
   rng=0)``, built once: each step calls ``sample_dense`` per layer (the
   native fixed-k draw when the host library builds), copies the four
   [k, N] arrays (65.2 MB at Reddit size) to the card, then runs the two
   ``mean_graph_sage_fixed_k`` layers (S1 forward and backward), the loss
   and Adam. The step is timed end to end, host draw and copy included, as
   the JAX script times it; the line before it gives the host draw's ms
   (host clock) and the copy's ms (CUDA events) per step. The sampler is
   reseeded with the weights, so every run from them sees the same draws.

The graph auto-encoder of ``demo/demo_gae.py`` (``GaeEncoder``,
``build_gae_problem``, ``gae_loss``) is here for chip_smoke.py, without a
workload: its split of the arxiv graph, per-step negatives drawn on the
host, the two GCNs on the COO SpMM (X6) and the test AUC.

The tiled A/B (``tiled_ab``, ``--tiled-ab``): for the random arxiv graph,
``tiled_spmm_ab.py``'s community graph (communities of the tile size, 0.95
of the edges inside) and the random graph at 32,768 nodes and 225,669 edges
(arxiv's mean degree), the occupancy of the normalized adjacency at t = 128
and 256 without building a tile; the 6 GB budget of the bf16 tiles of both
directions, over which a graph prints its SKIP line; then, at t = 128,
F = 128, bf16 tiles and float32 ``h``, the four chained steps of
``tiled_spmm_ab.py`` (forward, and the gradient of ``vdot(A·h, c)``)
through the CSR SpMM and through X7, timed by
``utils.profiling.measure_step_time``, and one ``VERDICT`` line per graph.
Nothing dispatches X7 whatever the verdict.

The GCN workloads use bf16 SpMM compute and a bf16 ``x @ W0`` by default,
the GAT workload bf16 attention compute and float32 dense products, as
``bench.py`` does; weights come from ``np.random.default_rng(0)`` normals at
scale 0.05 (GAT: drawn after the GCN's w0 and w1, in the order wq, wk, wv,
wd), biases are zeros; Adam at lr 1e-2 (GCN) and 1e-3 (GAT); mean softmax
cross-entropy. The dense products are ``torch.matmul``.

Timing: CUDA events around ``steps`` steps after 3 warm-up steps, so the
time is the device's, not the host's enqueue. There is no CPU path: a
measurement on the CPU would not be a device number. edges/s counts the
nonzeros of Â (GCN) or the self-looped edges (GAT), 1,335,586 each at full
size, per step; the SAGE line counts sampled edges, N·(25 + 10) =
8,153,775 per step (workloads 4 and 18).

vs_baseline = (least time of the step's sparse passes) / (measured step
time), the least time being the passes' least bytes over the H100's
3.35 TB/s, each input row that an edge reads read once and each output
written once (on the square, self-looped graphs every row is read; the
halo blocks and layouts leave many rows unread):
- one SpMM pass ``A_side · h``: the rows of h that an entry or the diagonal
  reads, and the output written (N·F elements, in the compute dtype),
  row_ptr, col and val (4 + 8·nnz bytes, nnz without the diagonal) and the
  diagonal (4·N bytes; ``csr_pass_bytes``);
- the three attention passes, at rows of H·d elements in the compute
  dtype: forward reads Q, K, V and writes out and lse; the destination-side
  backward reads Q, K, V, out, dy and lse and writes dQ and D; the
  source-side backward reads Q, K, V, dy, lse and D and writes dK and dV
  (inputs on the rows with an entry, outputs on every row); each pass also
  reads its side's row pointers and neighbour ids
  (4·(N + 1) + 4·nnz bytes) and, under dropout, the edge ids that index
  the mask (4·nnz) and the [E, H] float32 mask (``gat_pass_bytes``). The
  source-pass kernel's own row in chip_smoke.py is bound by what its
  function moves instead: given the destination pass's [E, 2H] float32
  weights, Q and dy read, w read on the side's edges, dK and dV written
  (``gat_src_gather_work``);
- the SAGE steps' two draws (the random integers read, idx and weight
  written, row starts and degrees, the picked column entries;
  ``ops.fixed_k.draw_pass_bytes``) and its two aggregations forward (the
  128-wide float32 source read, the output written, idx and weight) and
  backward (dy read, the float32 source gradient written, idx and weight;
  ``ops.fixed_k.aggregate_pass_bytes``); workload 13 counts the same
  passes of every rank, each rank's draw over its own rows and column
  shard and its aggregations against the gathered table; workload 18 its
  aggregations only (its draw is the host's; the copy is not charged);
- the merged-head GAT's multi-head SpMM forward and ``dV`` and its
  ``d_att`` SDDMM (``ops.spmm_heads.spmm_pass_bytes``,
  ``sddmm_pass_bytes``);
- the GIN step's COO SpMM passes (the same byte counts, one head, over the
  batch's real edges: padded edges are dropped from the views);
- workload 17's four Kernel A passes per rank (forward and ``dh`` at
  F = hidden + C and at F = C, float32, on the rank's rectangular block:
  ``mincut_pass_bytes``);
- the pool steps' COO SpMM forward and ``dh`` of every GCN and workload
  14's ``dv`` SDDMMs (``pool_x6_calls``: the views' stored entries, each
  GCN's self-loops included; SAGPool's second level over the edges its
  first level keeps at the initial weights).
Dense products, the loss and Adam are not charged, so the ratio is the
share of the step that the sparse passes' minimum traffic would fill. The
GIN lines count graphs/s; ``main`` also prints each GIN step's real and
padded edges per second.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from torch import nn
from torch.func import functional_call

from .convert import (GAT_BENCH_PARAM_NAMES, SAGE_BENCH_PARAM_NAMES, bench_params_from_numpy,
                      gin_classifier_state_dict_from_flax)
from .data.graph import Graph
from .data.padding import padded_batch_generator
from .datasets.synthetic_citation import (synthetic_graph_classification,
                                          synthetic_ogbn_arxiv_like)
from .datasets.synthetic_reddit import (REDDIT_CLASSES, REDDIT_EDGES, REDDIT_FEATURES,
                                        REDDIT_NODES, synthetic_reddit_like)
from .nn.conv.gat import _gat_edge_cache, gat
from .nn.conv.gcn import (compute_cache_key, gcn, gcn_norm_adj, maybe_compile_ell,
                          precompute_propagated_features)
from .layers.base import dropout, glorot_uniform, l2_loss
from .layers.conv.gcn import GCN
from .layers.conv.propagation import GIN
from .layers.pool.pool_layers import ASAP, DiffPool, MinCutPool, SAGPool, Set2Set
from .nn.conv.appnp import appnp
from .nn.conv.sgc import sgc
from .nn.conv.ssgc import ssgc
from .nn.conv.graph_sage import mean_graph_sage_fixed_k
from .nn.pool._subgraph import induced_subgraph_fixed
from .nn.pool.common_pool import max_pool, mean_pool, sum_pool
from .nn.pool.sort_pool import sort_pool
from .nn.pool.topk_pool import topk_pool_fixed
from .nn.sampling.device_sampler import DeviceNeighborSampler
from .ops import config as kernel_config
from .ops.csr_spmm import CsrAdj, CsrSide, csr_spmm
from .ops.fixed_k import aggregate_pass_bytes, draw_pass_bytes
from .ops.gat_attention import CsrGatLayout
from .ops.spmm_heads import sddmm_pass_bytes, spmm_pass_bytes
from .sparse.matrix import SparseMatrix
from .ops.tiled_spmm import TiledSpmm, build_tiled_spmm, count_occupied_tiles, tiled_spmm
from .utils.graph_utils import (RandomNeighborSampler, edge_train_test_split,
                                negative_sampling)
from .utils.metrics import binary_auc
from .utils.profiling import (H100_HBM_BYTES_PER_S, device_time_by_kernel,
                              estimate_spmm_roofline, measure_step_time)

__all__ = ["ArxivProblem", "SageProblem", "GraphBatchProblem", "build_problem",
           "build_sage_problem", "build_graph_problem", "init_params", "init_gat_params",
           "init_gat_merged_params", "init_sage_params", "init_gin_flax_params",
           "precomputed_loss", "canonical_loss", "gat_loss", "sage_loss",
           "gin_loss", "GinMlp", "GinClassifier", "make_step", "run_workload",
           "profile_workload", "gat_pass_bytes", "gat_pass_flops", "gat_src_gather_work",
           "sage_step_bytes",
           "gin_step_bytes", "Workload", "WORKLOADS", "GCN_WORKLOADS", "GIN_READOUTS",
           "SAGE_FANOUTS", "HaloProblem", "build_halo_problem", "halo_jobs",
           "run_halo_workload", "halo_pass_bytes", "csr_pass_bytes", "csr_rows_read",
           "csr_diag_rows", "HALO_WORKLOADS", "SPMM_PAIRS", "init_propagation_params",
           "sgc_loss", "appnp_loss", "ssgc_loss", "community_graph", "tiled_ab_graphs",
           "tiled_ab_occupancy", "TiledAbProblem", "build_tiled_ab", "tiled_ab_steps",
           "tiled_ab", "SampledSageProblem", "build_sampled_sage_problem",
           "sampled_sage_jobs", "sampled_sage_pass_bytes", "run_sampled_sage_workload",
           "SAMPLED_SAGE_WORKLOAD", "DiffPoolClassifier", "MinCutPoolClassifier",
           "SAGPoolClassifier", "ASAPClassifier", "Set2SetClassifier", "POOL_MODELS",
           "POOL_WORKLOADS", "init_pool_params", "pool_loss", "pool_x6_calls", "pool_step_bytes",
           "MincutProblem", "build_mincut_problem", "mincut_jobs", "mincut_pass_bytes",
           "run_mincut_workload", "MINCUT_WORKLOAD", "HostSageProblem",
           "build_host_sage_problem", "init_host_sage_params", "host_sage_draws",
           "host_sage_loss", "host_sage_rates", "host_sage_step_bytes", "HOST_SAGE_WORKLOAD",
           "GaeEncoder", "GaeProblem", "build_gae_problem", "gae_problem", "init_gae_model",
           "gae_negatives",
           "gae_loss", "gae_test_auc", "predict_edge", "main"]

NUM_CLASSES, HIDDEN = 40, 256
GAT_HEADS, GAT_UNITS = 8, 256
ARXIV_NODES, ARXIV_EDGES = 169_343, 1_166_243
WARMUP_STEPS = 3
PROFILE_STEPS, PROFILE_TOP = 5, 12  # steps traced, kernels listed per workload
# the port's kernels (csrc/*.cu), matched as substrings of the profiler's
# names; "fixed_k_" covers the draw, the gather and the backward's sort
PORT_KERNELS = ("csr_spmm_kernel", "sorted_segment_sum_kernel", "gat_forward_kernel",
                "gat_backward_dst_kernel", "gat_backward_src_kernel", "fixed_k_",
                "spmm_heads_kernel", "spmm_heads_chunk_kernel", "sddmm_heads_kernel")
SAGE_FANOUTS, SAGE_HIDDEN = (25, 10), 256
SAGE_DRAW_SEED = 0  # the draws' torch.Generator seed at the initial weights
# workload 18: sage_sampling_throughput.py's dense mode, RandomNeighborSampler(.., rng=0)
HOST_SAGE_WORKLOAD, HOST_SAGE_SEED = "sage_reddit_dense_fwd_bwd", 0
# workload 5's units and query/key units (bench_node_cls_early_stop_gat.py:44)
GAT_MERGED_UNITS, GAT_MERGED_ATT_UNITS = 64, 8
# benchmarks/graph_classification_throughput.py's constants
GIN_BATCH, GIN_UNITS, GIN_LAYERS, GIN_SORT_K = 128, 64, 3, 16
GIN_READOUTS = {"gin_sum_pool_fwd_bwd": "sum", "gin_sort_pool_fwd_bwd": "sort"}
# the pooling demos' widths (demo/demo_{diff_pool,min_cut_pool,sag_pool_h,asap,set2set}.py)
# and demo_utils.run_graph_classification's learning rate
POOL_UNITS, POOL_HIDDEN, POOL_DROP_RATE, POOL_LR = 32, 64, 0.4, 5e-3
DIFF_POOL_CLUSTERS, MIN_CUT_CLUSTERS, SAG_POOL_K = (8, 4), 8, 8
ASAP_BATCH, ASAP_K, SET2SET_ITERATIONS = 16, 8, 3
POOL_SEED = 0  # the pool models' weights and dropout generator
POOL_WORKLOADS = {"diff_pool_graphs_fwd_bwd": "diff_pool",
                  "min_cut_pool_graphs_fwd_bwd": "min_cut",
                  "sag_pool_graphs_fwd_bwd": "sag_pool"}
# demo/demo_gae.py's encoder widths, dropout, Adam rate and split; the seed of
# the split, the test negatives and the weights
GAE_UNITS, GAE_DROP_RATE, GAE_LR, GAE_TEST_SIZE, GAE_SEED = (32, 16), 0.3, 1e-2, 0.15, 0
# benchmarks/scaling.py's graph-parallel steps
HALO_PARTS, HALO_GCN_HIDDEN = 4, 64
HALO_GAT_DIMS, HALO_DROP_RATE = ((8, 8), (1, 64)), 0.6
HALO_WORKLOADS = {"gcn_arxiv_halo_p4_fwd_bwd": "gcn", "gat_arxiv_halo_p4_fwd_bwd": "gat_fused"}
# benchmarks/scaling.py's measure(4, graph, model="sage")
SAMPLED_SAGE_WORKLOAD = "sage_arxiv_sampled_p4_fwd_bwd"
SAMPLED_SAGE_FANOUTS, SAMPLED_SAGE_HIDDEN, SAMPLED_SAGE_ROW_MULTIPLE = (25, 10), 128, 128
# benchmarks/scaling.py's measure(4, graph, model="mincut")
MINCUT_WORKLOAD = "mincut_arxiv_p4_fwd_bwd"
MINCUT_HIDDEN, MINCUT_CLUSTERS = 64, 32


class ArxivProblem(NamedTuple):
    adj: CsrAdj
    x: torch.Tensor                    # [N, 128] float32
    px: torch.Tensor                   # [N, 128] float32, Â·x
    y: torch.Tensor                    # [N] int64
    num_edges_normed: int              # nnz of Â, self-loops included
    spmm_dtype: Optional[torch.dtype]  # SpMM and attention compute dtype (None: float32)
    gat_layout: CsrGatLayout           # the self-looped graph's attention layout
    gat_edges: torch.Tensor            # [2, E + N] the self-looped list, row-sorted
    edge_index: torch.Tensor           # [2, E] the graph's edges, on the device
    cache: dict                        # the graph's cache: Â and its CSR twin
    generator: torch.Generator         # dropout draws of workloads 11 and 12


@contextlib.contextmanager
def _spmm_compute_dtype(dtype):
    prev = kernel_config.ell_compute_dtype
    kernel_config.set_ell_compute_dtype(dtype)
    try:
        yield
    finally:
        kernel_config.set_ell_compute_dtype(prev)


def build_problem(num_nodes: int = ARXIV_NODES, num_edges: int = ARXIV_EDGES,
                  device="cuda", spmm_bf16: bool = True) -> ArxivProblem:
    """The synthetic arxiv graph, its normalized CSR adjacency, ``P = Â·x``
    (computed in the SpMM compute dtype, as ``bench.py`` does) and the GAT
    edge cache of the self-looped graph."""
    graph = synthetic_ogbn_arxiv_like(num_nodes=num_nodes, num_edges=num_edges)
    n = graph.num_nodes
    coo = SparseMatrix(graph.edge_index, graph.edge_weight, (n, n), device=device)
    cache = {}
    normed = gcn_norm_adj(coo, cache=cache)
    adj = maybe_compile_ell(normed, cache, compute_cache_key("both", True, True, True, False))
    x = torch.as_tensor(graph.x, device=device)
    spmm_dtype = torch.bfloat16 if spmm_bf16 else None
    with _spmm_compute_dtype(spmm_dtype):
        px = precompute_propagated_features(x, coo, cache=cache)
    y = torch.as_tensor(graph.y, device=device).long()
    gat_edges, _, gat_layout = _gat_edge_cache(graph.edge_index, n, {}, device)
    return ArxivProblem(adj, x, px, y, normed.nnz, spmm_dtype, gat_layout, gat_edges,
                        coo.index, cache, torch.Generator(device=device))


class SageProblem(NamedTuple):
    sampler: DeviceNeighborSampler     # the graph's CSR on the device
    x: torch.Tensor                    # [N, 602] float32
    y: torch.Tensor                    # [N] int64
    params0: Dict[str, np.ndarray]     # the benchmark's initial weights
    generator: torch.Generator         # the draws' random integers, on x's device
    fanouts: Tuple[int, ...]           # k of each layer's draw


def _sage_graph_and_weights(num_nodes: int, num_edges: int, num_features: int,
                            num_classes: int):
    """The Reddit-shaped graph and the SAGE benchmark's initial weights,
    drawn from one ``default_rng(0)`` in the JAX benchmark's order."""
    rng = np.random.default_rng(0)
    graph = synthetic_reddit_like(num_nodes, num_edges, num_features, num_classes, rng=rng)
    half = SAGE_HIDDEN // 2
    params0 = {"s0": rng.normal(scale=0.05, size=(num_features, half)),
               "n0": rng.normal(scale=0.05, size=(num_features, half)),
               "s1": rng.normal(scale=0.05, size=(SAGE_HIDDEN, half)),
               "n1": rng.normal(scale=0.05, size=(SAGE_HIDDEN, half)),
               "wd": rng.normal(scale=0.05, size=(SAGE_HIDDEN, num_classes))}
    return graph, params0


def build_sage_problem(num_nodes: int = REDDIT_NODES, num_edges: int = REDDIT_EDGES,
                       num_features: int = REDDIT_FEATURES, num_classes: int = REDDIT_CLASSES,
                       device="cuda", fanouts: Tuple[int, ...] = SAGE_FANOUTS) -> SageProblem:
    """The Reddit-shaped graph, its device sampler and the initial weights."""
    graph, params0 = _sage_graph_and_weights(num_nodes, num_edges, num_features, num_classes)
    sampler = DeviceNeighborSampler(graph.edge_index, num_nodes=num_nodes, device=device)
    return SageProblem(sampler, torch.as_tensor(graph.x, device=device),
                       torch.as_tensor(graph.y, device=device).long(), params0,
                       torch.Generator(device=device), tuple(fanouts))


def init_sage_params(problem: SageProblem) -> Dict[str, torch.Tensor]:
    """The SAGE benchmark's initial weights; also reseeds the draws, so
    every run from these weights sees the same sequence of draws."""
    problem.generator.manual_seed(SAGE_DRAW_SEED)
    return bench_params_from_numpy(problem.params0, device=problem.x.device,
                                   names=SAGE_BENCH_PARAM_NAMES)


def _sage_draws_loss(p, problem, draws):
    """Two ``mean_graph_sage_fixed_k`` layers with ReLU over the two layers'
    draws, ``h Wd``, mean cross-entropy (all in float32)."""
    (e0, w0), (e1, w1) = draws
    h = mean_graph_sage_fixed_k(problem.x, e0, w0, p["s0"], p["n0"], activation=torch.relu)
    h = mean_graph_sage_fixed_k(h, e1, w1, p["s1"], p["n1"], activation=torch.relu)
    return F.cross_entropy(h @ p["wd"], problem.y)


def sage_loss(p, problem: SageProblem):
    """Workload 4: a fresh device draw per layer, then ``_sage_draws_loss``."""
    csr = problem.sampler.csr()
    return _sage_draws_loss(p, problem, [problem.sampler.sample(problem.generator, k, csr)
                                         for k in problem.fanouts])


class HostSageProblem(NamedTuple):
    sampler: RandomNeighborSampler     # the graph's CSR on the host
    x: torch.Tensor                    # [N, 602] float32
    y: torch.Tensor                    # [N] int64
    params0: Dict[str, np.ndarray]     # the benchmark's initial weights (workload 4's)
    fanouts: Tuple[int, ...]           # k of each layer's draw
    timing: dict                       # per step: "draw_ms" (host), "copy" (event pairs)


def build_host_sage_problem(num_nodes: int = REDDIT_NODES, num_edges: int = REDDIT_EDGES,
                            num_features: int = REDDIT_FEATURES,
                            num_classes: int = REDDIT_CLASSES, device="cuda",
                            fanouts: Tuple[int, ...] = SAGE_FANOUTS) -> HostSageProblem:
    """Workload 18's problem: workload 4's graph and weights, with
    ``RandomNeighborSampler(edge_index, rng=HOST_SAGE_SEED)`` on the host
    in place of the device sampler (``sage_sampling_throughput.py``'s
    ``dense`` mode)."""
    graph, params0 = _sage_graph_and_weights(num_nodes, num_edges, num_features, num_classes)
    sampler = RandomNeighborSampler(graph.edge_index, rng=HOST_SAGE_SEED)
    return HostSageProblem(sampler, torch.as_tensor(graph.x, device=device),
                           torch.as_tensor(graph.y, device=device).long(), params0,
                           tuple(fanouts), {"draw_ms": [], "copy": []})


def init_host_sage_params(problem: HostSageProblem) -> Dict[str, torch.Tensor]:
    """The SAGE benchmark's initial weights; also reseeds the sampler, so
    every run from these weights sees the same sequence of draws."""
    problem.sampler.rng = np.random.default_rng(HOST_SAGE_SEED)
    return bench_params_from_numpy(problem.params0, device=problem.x.device,
                                   names=SAGE_BENCH_PARAM_NAMES)


def host_sage_draws(problem: HostSageProblem):
    """One ``sample_dense`` per layer on the host, then the four [k, N]
    arrays copied to ``x``'s device; the host draw's ms and (on the card)
    a CUDA event pair around the copies are appended to ``problem.timing``."""
    t0 = time.perf_counter()
    drawn = [problem.sampler.sample_dense(k) for k in problem.fanouts]
    problem.timing["draw_ms"].append((time.perf_counter() - t0) * 1e3)
    device = problem.x.device
    events = None
    if device.type == "cuda":
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        events[0].record()
    out = [(torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device))
           for idx, w in drawn]
    if events is not None:
        events[1].record()
        problem.timing["copy"].append(events)
    return out


def host_sage_loss(p, problem: HostSageProblem):
    """Workload 18: the host draws, then workload 4's layers and loss."""
    return _sage_draws_loss(p, problem, host_sage_draws(problem))


def host_sage_rates(problem: HostSageProblem, steps: int) -> dict:
    """The host draw's and the copy's ms per step over the last ``steps``
    steps, and the bytes copied per step."""
    copies = problem.timing["copy"][-steps:]
    n = problem.x.shape[0]
    return {"host_draw_ms": float(np.mean(problem.timing["draw_ms"][-steps:])),
            "copy_ms": (float(np.mean([a.elapsed_time(b) for a, b in copies]))
                        if copies else None),
            "copy_bytes": 8 * n * sum(problem.fanouts)}


def host_sage_step_bytes(problem: HostSageProblem) -> int:
    """Least bytes of workload 18's device passes: both layers' 128-wide
    float32 aggregations forward and backward (the draw is the host's)."""
    n = problem.x.shape[0]
    width = SAGE_HIDDEN // 2
    return sum(aggregate_pass_bytes(n, k, n, width, 4)
               + aggregate_pass_bytes(n, k, n, width, 4, backward=True)
               for k in problem.fanouts)


def sage_step_bytes(problem: SageProblem) -> int:
    """Least bytes of the SAGE step's sparse passes: both draws, and both
    layers' 128-wide float32 aggregations forward and backward."""
    n = problem.x.shape[0]
    nnz = int(problem.sampler.sorted_col.shape[0])
    weighted = problem.sampler.sorted_weight is not None
    width = SAGE_HIDDEN // 2
    return sum(draw_pass_bytes(k, n, nnz, weighted)
               + aggregate_pass_bytes(n, k, n, width, 4)
               + aggregate_pass_bytes(n, k, n, width, 4, backward=True)
               for k in problem.fanouts)


def init_params(num_features: int, device="cuda") -> Dict[str, torch.Tensor]:
    """``bench.py``'s GCN weights: ``default_rng(0)`` normals at scale 0.05, zero biases."""
    rng = np.random.default_rng(0)
    return bench_params_from_numpy({
        "w0": rng.normal(scale=0.05, size=(num_features, HIDDEN)),
        "b0": np.zeros(HIDDEN),
        "w1": rng.normal(scale=0.05, size=(HIDDEN, NUM_CLASSES)),
        "b1": np.zeros(NUM_CLASSES),
    }, device=device)


def init_gat_params(num_features: int, device="cuda") -> Dict[str, torch.Tensor]:
    """``bench.py``'s GAT weights: the same generator, after the GCN's w0 and
    w1, normals at scale 0.05 in the order wq, wk, wv, wd; zero biases."""
    rng = np.random.default_rng(0)
    rng.normal(scale=0.05, size=(num_features, HIDDEN))   # w0
    rng.normal(scale=0.05, size=(HIDDEN, NUM_CLASSES))    # w1
    wq, wk, wv = (rng.normal(scale=0.05, size=(num_features, GAT_UNITS)) for _ in range(3))
    return bench_params_from_numpy({
        "wq": wq, "bq": np.zeros(GAT_UNITS), "wk": wk, "bk": np.zeros(GAT_UNITS), "wv": wv,
        "wd": rng.normal(scale=0.05, size=(GAT_UNITS, NUM_CLASSES)),
        "bd": np.zeros(NUM_CLASSES),
    }, device=device, names=GAT_BENCH_PARAM_NAMES)


def _dense_first_layer(a, w0, dense_bf16: bool):
    if dense_bf16:
        return (a.to(torch.bfloat16) @ w0.to(torch.bfloat16)).float()
    return a @ w0


def precomputed_loss(p, problem: ArxivProblem, dense_bf16: bool = True):
    """Workload 1: ``relu(P W0 + b0)``, then one SpMM at width 40."""
    h = torch.relu(_dense_first_layer(problem.px, p["w0"], dense_bf16) + p["b0"])
    logits = csr_spmm(problem.adj, h @ p["w1"], problem.spmm_dtype) + p["b1"]
    return F.cross_entropy(logits, problem.y)


def canonical_loss(p, problem: ArxivProblem, dense_bf16: bool = True):
    """Workload 1b: both SpMMs in the step (widths 256 and 40)."""
    xw = _dense_first_layer(problem.x, p["w0"], dense_bf16)
    h = torch.relu(csr_spmm(problem.adj, xw, problem.spmm_dtype) + p["b0"])
    logits = csr_spmm(problem.adj, h @ p["w1"], problem.spmm_dtype) + p["b1"]
    return F.cross_entropy(logits, problem.y)


def gat_loss(p, problem: ArxivProblem):
    """Workloads 3 and 5: ``gat`` with 8 heads over the cached layout (no
    bias or activation on its output), then ``h Wd + bd``. The dense
    products stay float32 as in ``bench.py``; the fused attention (equal
    head widths) computes in ``problem.spmm_dtype``, the merged-head branch
    (workload 5's d_q = 1, d_v = 8) in float32, as the JAX branch runs."""
    with _spmm_compute_dtype(problem.spmm_dtype):
        h = gat(problem.x, None, p["wq"], p["bq"], torch.relu, p["wk"], p["bk"], torch.relu,
                p["wv"], num_heads=GAT_HEADS, num_nodes=problem.x.shape[0],
                ell_layout=problem.gat_layout, sorted_edge_index=problem.gat_edges)
    return F.cross_entropy(h @ p["wd"] + p["bd"], problem.y)


def init_gat_merged_params(num_features: int, device="cuda") -> Dict[str, torch.Tensor]:
    """Workload 5's weights: ``default_rng(1)`` normals at scale 0.05 in the
    order wq, wk ([F, 8]), wv ([F, 64]), wd; zero biases."""
    rng = np.random.default_rng(1)
    wq, wk = (rng.normal(scale=0.05, size=(num_features, GAT_MERGED_ATT_UNITS)) for _ in range(2))
    return bench_params_from_numpy({
        "wq": wq, "bq": np.zeros(GAT_MERGED_ATT_UNITS), "wk": wk,
        "bk": np.zeros(GAT_MERGED_ATT_UNITS),
        "wv": rng.normal(scale=0.05, size=(num_features, GAT_MERGED_UNITS)),
        "wd": rng.normal(scale=0.05, size=(GAT_MERGED_UNITS, NUM_CLASSES)),
        "bd": np.zeros(NUM_CLASSES),
    }, device=device, names=GAT_BENCH_PARAM_NAMES)


# ---------------------------------------------------------------------------
# workloads 10-12: the propagation family
# ---------------------------------------------------------------------------

# benchmarks/node_classification/bench_node_cls_early_stop_{sgc,appnp,ssgc}.py:
# SGC(units=C, k=2), lr 0.2; APPNP and SSGC ([64, C], k=10, alpha=0.1, dense
# and edge dropout 0.5; SSGC behind an input dropout of 0.5), lr 5e-3; L2 on
# the kernels at their arxiv (SGC) and default (APPNP, SSGC) coefficients
SGC_K, PPR_K, PPR_ALPHA, PPR_HIDDEN, PPR_DROP = 2, 10, 0.1, 64, 0.5
PROPAGATION_L2 = {"sgc_arxiv_fwd_bwd": 5e-6, "appnp_arxiv_fwd_bwd": 1e-3,
                  "ssgc_arxiv_fwd_bwd": 1e-3}
PROPAGATION_SEED = 2  # the weights' numpy seed and the dropout generator's


def init_propagation_params(problem: ArxivProblem, name: str) -> Dict[str, torch.Tensor]:
    """Workload ``name``'s weights in the flax layer's names: glorot-uniform
    kernels from ``default_rng(PROPAGATION_SEED)`` (SGC ``kernel`` [F, 40];
    APPNP and SSGC ``kernel_0`` [F, 64], ``kernel_1`` [64, 40]), zero
    biases. Also reseeds the dropout generator, so every run from these
    weights draws the same masks."""
    problem.generator.manual_seed(PROPAGATION_SEED)
    rng = np.random.default_rng(PROPAGATION_SEED)
    dims = ([problem.x.shape[1], NUM_CLASSES] if name == "sgc_arxiv_fwd_bwd"
            else [problem.x.shape[1], PPR_HIDDEN, NUM_CLASSES])

    def glorot(fan_in, fan_out):
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-limit, limit, size=(fan_in, fan_out))

    if len(dims) == 2:
        params = {"kernel": glorot(*dims), "bias": np.zeros(dims[1])}
    else:
        params = {}
        for i in range(len(dims) - 1):
            params[f"kernel_{i}"] = glorot(dims[i], dims[i + 1])
            params[f"bias_{i}"] = np.zeros(dims[i + 1])
    return bench_params_from_numpy(params, device=problem.x.device, names=tuple(params))


def sgc_loss(p, problem: ArxivProblem):
    """Workload 10: ``sgc`` (k = 2) over the cached CSR adjacency, mean
    cross-entropy over all nodes plus L2 on the kernel."""
    logits = sgc(problem.x, problem.edge_index, None, SGC_K, p["kernel"], p["bias"],
                 cache=problem.cache)
    return (F.cross_entropy(logits, problem.y)
            + l2_loss(p, PROPAGATION_L2["sgc_arxiv_fwd_bwd"]))


def _ppr_loss(fn, name: str, p, problem: ArxivProblem, masks: Optional[dict] = None):
    """Workloads 11 and 12: ``appnp`` or ``ssgc`` in training mode, the
    edge and dense dropout drawn from the problem's generator, or taken
    from ``masks`` ({"input", "edge", "dense"} keep masks)."""
    masks = masks or {}
    x = problem.x
    if name == "ssgc_arxiv_fwd_bwd":
        keep = masks.get("input")
        if keep is None:
            keep = torch.rand(x.shape, generator=problem.generator, device=x.device) >= PPR_DROP
        x = torch.where(keep, x / (1.0 - PPR_DROP), torch.zeros_like(x))
    logits = fn(x, problem.edge_index, None, [p["kernel_0"], p["kernel_1"]],
                [p["bias_0"], p["bias_1"]], k=PPR_K, alpha=PPR_ALPHA, dense_drop_rate=PPR_DROP,
                edge_drop_rate=PPR_DROP, cache=problem.cache, training=True,
                generator=problem.generator, edge_keep_mask=masks.get("edge"),
                dense_keep_masks=masks.get("dense"))
    return F.cross_entropy(logits, problem.y) + l2_loss(p, PROPAGATION_L2[name])


def appnp_loss(p, problem: ArxivProblem, masks: Optional[dict] = None):
    return _ppr_loss(appnp, "appnp_arxiv_fwd_bwd", p, problem, masks)


def ssgc_loss(p, problem: ArxivProblem, masks: Optional[dict] = None):
    return _ppr_loss(ssgc, "ssgc_arxiv_fwd_bwd", p, problem, masks)


# ---------------------------------------------------------------------------
# workloads 6 and 7: GIN graph classification
# ---------------------------------------------------------------------------

class GinMlp(nn.Module):
    """The benchmark's MLP: ``Dense(units)`` → relu → ``Dense(units)``."""

    def __init__(self, in_features: int, units: int, device="cuda"):
        super().__init__()
        self.dense0 = nn.Linear(in_features, units, device=device)
        self.dense1 = nn.Linear(units, units, device=device)

    def forward(self, h):
        return self.dense1(torch.relu(self.dense0(h)))


class GinClassifier(nn.Module):
    """``GINSum`` (readout ``"sum"``) or ``GINSort`` (``"sort"``) of
    ``benchmarks/graph_classification_throughput.py``: ``num_layers`` ×
    (``GIN`` with a ``GinMlp``, then relu), then ``sum_pool`` or
    ``sort_pool(k=sort_k)`` reshaped to [num_graphs, sort_k·units], then a
    dense head to the classes. Called on a padded batch
    ``(x, edge_index, edge_weight, node_graph_index)``."""

    def __init__(self, in_features: int, num_classes: int, readout: str = "sum",
                 units: int = GIN_UNITS, num_layers: int = GIN_LAYERS, sort_k: int = GIN_SORT_K,
                 num_graphs: int = GIN_BATCH, device="cuda"):
        super().__init__()
        if readout not in ("sum", "sort"):
            raise ValueError(f"readout must be 'sum' or 'sort', got {readout!r}")
        self.readout, self.sort_k, self.num_graphs = readout, sort_k, num_graphs
        self.gins = nn.ModuleList(
            GIN(GinMlp(in_features if i == 0 else units, units, device), device=device)
            for i in range(num_layers))
        self.head = nn.Linear(units * (sort_k if readout == "sort" else 1), num_classes,
                              device=device)

    def forward(self, x, edge_index, edge_weight, node_graph_index):
        h = x
        for layer in self.gins:
            h = torch.relu(layer([h, edge_index]))
        if self.readout == "sum":
            h = sum_pool(h, node_graph_index, num_graphs=self.num_graphs)
        else:
            pooled = sort_pool(h, edge_index, edge_weight, node_graph_index, k=self.sort_k,
                               num_graphs=self.num_graphs)
            h = pooled[0].reshape(self.num_graphs, -1)
        return self.head(h)


def init_gin_flax_params(in_features: int, num_classes: int, readout: str,
                         units: int = GIN_UNITS, num_layers: int = GIN_LAYERS,
                         sort_k: int = GIN_SORT_K, seed: int = 0) -> dict:
    """The benchmark model's params in flax's layout (``{"params": {"MLP_i":
    {"Dense_0", "Dense_1"}, "Dense_0"}}``): LeCun normals (scale
    1/√fan_in) from ``default_rng(seed)``, layer by layer and the head last,
    zero biases; ε is not trained."""
    rng = np.random.default_rng(seed)

    def dense(fan_in, fan_out):
        return {"kernel": rng.normal(scale=1.0 / np.sqrt(fan_in),
                                     size=(fan_in, fan_out)).astype(np.float32),
                "bias": np.zeros(fan_out, np.float32)}

    params = {f"MLP_{i}": {"Dense_0": dense(in_features if i == 0 else units, units),
                           "Dense_1": dense(units, units)} for i in range(num_layers)}
    params["Dense_0"] = dense(units * (sort_k if readout == "sort" else 1), num_classes)
    return {"params": params}


class GraphBatchProblem(NamedTuple):
    x: torch.Tensor                    # [N, 4] float32, padded nodes zero
    edge_index: torch.Tensor           # [2, E] int64, padded edges at the sink N
    edge_weight: torch.Tensor          # [E] float32, padded edges 0
    node_graph_index: torch.Tensor     # [N] int64, padded nodes num_graphs
    y: torch.Tensor                    # [num_graphs] int64
    num_graphs: int
    num_classes: int
    real_edges: int                    # edges of the batch's graphs, padding excluded
    models: Dict[str, nn.Module]       # per readout or pool model, the module its params are
                                       # called in
    params0: Dict[str, dict]           # per readout, the initial params (flax layout)
    generator: torch.Generator         # the pool models' dropout masks, on x's device


def build_graph_problem(batch: int = GIN_BATCH, device="cuda", num_graphs: int = 600,
                        seed: int = 0) -> GraphBatchProblem:
    """The benchmark's fixed batch: the offline graph set's first ``batch``
    graphs (``shuffle=False``), padded to the set's capacities."""
    graphs, num_classes = synthetic_graph_classification(num_graphs, seed=seed)
    padded, real = next(padded_batch_generator(graphs, batch, shuffle=False, seed=seed))
    chunk = graphs[:real]
    y = np.array([g.y for g in chunk], np.int64).reshape(-1)
    num_features = padded.x.shape[1]

    def tensor(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    models = {r: GinClassifier(num_features, num_classes, r, num_graphs=batch, device=device)
              for r in ("sum", "sort")}
    models.update({name: cls(num_features, num_classes, batch, device=device)
                   for name, cls in POOL_MODELS.items()})
    return GraphBatchProblem(
        tensor(padded.x, torch.float32), tensor(padded.edge_index, torch.long),
        tensor(padded.edge_weight, torch.float32), tensor(padded.node_graph_index, torch.long),
        tensor(y, torch.long), batch, num_classes, sum(g.num_edges for g in chunk), models,
        {r: init_gin_flax_params(num_features, num_classes, r) for r in ("sum", "sort")},
        torch.Generator(device=device))


def init_gin_params(problem: GraphBatchProblem, readout: str) -> Dict[str, torch.Tensor]:
    """A GIN workload's initial weights, as leaf tensors that require grad."""
    state = gin_classifier_state_dict_from_flax(problem.params0[readout])
    return {k: v.to(problem.x.device).requires_grad_() for k, v in state.items()}


def gin_loss(p, problem: GraphBatchProblem, readout: str):
    """Workloads 6 and 7: the classifier with weights ``p``, mean softmax
    cross-entropy over the batch's graphs."""
    logits = functional_call(problem.models[readout], p, (
        problem.x, problem.edge_index, problem.edge_weight, problem.node_graph_index),
        strict=True)
    return F.cross_entropy(logits, problem.y)


def gin_step_bytes(problem: GraphBatchProblem) -> int:
    """Least bytes of a GIN step's COO SpMM passes: forward at the input
    width and twice at ``GIN_UNITS``, ``dh`` twice at ``GIN_UNITS`` (layer
    1's input is data); each over the real edges, float32."""
    n = problem.x.shape[0]
    widths = (problem.x.shape[1],) + (GIN_UNITS,) * (2 * GIN_LAYERS - 2)
    return sum(spmm_pass_bytes(problem.real_edges, n, n, w, 1, 4, 4) for w in widths)


def gin_edge_rates(problem: GraphBatchProblem, step_ms: float) -> Dict[str, float]:
    """Real and padded edges per second at a step time."""
    return {"real_edges_per_sec": problem.real_edges / step_ms * 1e3,
            "padded_edges_per_sec": problem.edge_index.shape[1] / step_ms * 1e3}


# ---------------------------------------------------------------------------
# workloads 14-16 (and the ASAP and Set2Set models): hierarchical pooling
# ---------------------------------------------------------------------------

class DiffPoolClassifier(nn.Module):
    """``demo/demo_diff_pool.py``'s ``DiffPoolModel``: for each level of
    ``DIFF_POOL_CLUSTERS`` = (8, 4) clusters, a ``DiffPool`` over a feature
    ``GCN(32, relu)`` and an assign ``GCN(C)``, then ``max_pool``; the
    readouts concatenated, ``Dense(64)``, relu, dropout 0.4 and a dense
    head. Submodules carry the flax model's names. Called on a padded batch
    ``(x, edge_index, edge_weight, node_graph_index)``."""

    def __init__(self, in_features: int, num_classes: int, num_graphs: int, device="cuda"):
        super().__init__()
        self.num_graphs = num_graphs
        width = in_features
        for level, clusters in enumerate(DIFF_POOL_CLUSTERS):
            feature = GCN(width, POOL_UNITS, activation=torch.relu, device=device)
            assign = GCN(width, clusters, device=device)
            self.add_module(f"feature_gnn_{level}", feature)
            self.add_module(f"assign_gnn_{level}", assign)
            # the GCNs pass as bound calls: submodules of this model alone
            self.add_module(f"diff_pool_{level}", DiffPool(
                feature.__call__, assign.__call__, units=POOL_UNITS, num_clusters=clusters,
                num_graphs=num_graphs, device=device))
            width = POOL_UNITS
        self.Dense_0 = nn.Linear(POOL_UNITS * len(DIFF_POOL_CLUSTERS), POOL_HIDDEN, device=device)
        self.Dense_1 = nn.Linear(POOL_HIDDEN, num_classes, device=device)

    def forward(self, x, edge_index, edge_weight, node_graph_index, generator=None,
                keep_mask=None):
        readouts, inputs = [], [x, edge_index, edge_weight, node_graph_index]
        for level in range(len(DIFF_POOL_CLUSTERS)):
            inputs = getattr(self, f"diff_pool_{level}")(inputs)
            readouts.append(max_pool(inputs[0], inputs[3], num_graphs=self.num_graphs))
        h = torch.relu(self.Dense_0(torch.cat(readouts, dim=-1)))
        return self.Dense_1(dropout(h, POOL_DROP_RATE, self.training, generator, keep_mask))


class MinCutPoolClassifier(nn.Module):
    """``demo/demo_min_cut_pool.py``'s ``MinCutPoolModel``: ``GCN(32,
    relu)``, a ``MinCutPool`` of ``MIN_CUT_CLUSTERS`` = 8 clusters over a
    feature ``GCN(32, relu)`` and an assign ``GCN(8)``, ``mean_pool``,
    dropout 0.4, a dense head. Returns ``(logits, (cut, orth))``: the
    pool's auxiliary losses, which the flax model sows."""

    def __init__(self, in_features: int, num_classes: int, num_graphs: int, device="cuda"):
        super().__init__()
        self.num_graphs = num_graphs
        self.GCN_0 = GCN(in_features, POOL_UNITS, activation=torch.relu, device=device)
        self.feature_gnn = GCN(POOL_UNITS, POOL_UNITS, activation=torch.relu, device=device)
        self.assign_gnn = GCN(POOL_UNITS, MIN_CUT_CLUSTERS, device=device)
        self.MinCutPool_0 = MinCutPool(self.feature_gnn.__call__, self.assign_gnn.__call__,
                                       units=POOL_UNITS, num_clusters=MIN_CUT_CLUSTERS,
                                       num_graphs=num_graphs, device=device)
        self.Dense_0 = nn.Linear(POOL_UNITS, num_classes, device=device)

    def forward(self, x, edge_index, edge_weight, node_graph_index, generator=None,
                keep_mask=None):
        h = self.GCN_0([x, edge_index, edge_weight])
        (h, _, _, ngi), losses = self.MinCutPool_0(
            [h, edge_index, edge_weight, node_graph_index], return_losses=True)
        h = mean_pool(h, ngi, num_graphs=self.num_graphs)
        h = dropout(h, POOL_DROP_RATE, self.training, generator, keep_mask)
        return self.Dense_0(h), losses


class SAGPoolClassifier(nn.Module):
    """``demo/demo_sag_pool_h.py``'s ``SAGPoolHModel``: two levels of
    ``GCN(32, relu)`` then ``SAGPool`` (score ``GCN(1)``, ``k =
    SAG_POOL_K`` = 8, tanh), a ``mean_pool`` readout per level,
    concatenated, dropout 0.4, a dense head."""

    def __init__(self, in_features: int, num_classes: int, num_graphs: int, device="cuda"):
        super().__init__()
        self.num_graphs = num_graphs
        width = in_features
        for level in range(2):
            self.add_module(f"GCN_{level}", GCN(width, POOL_UNITS, activation=torch.relu,
                                                device=device))
            score = GCN(POOL_UNITS, 1, device=device)
            self.add_module(f"score_gnn_{level}", score)
            self.add_module(f"sag_pool_{level}", SAGPool(score.__call__, k=SAG_POOL_K,
                                                         score_activation=torch.tanh,
                                                         num_graphs=num_graphs))
            width = POOL_UNITS
        self.Dense_0 = nn.Linear(2 * POOL_UNITS, num_classes, device=device)

    def forward(self, x, edge_index, edge_weight, node_graph_index, generator=None,
                keep_mask=None):
        readouts, (h, ei, ew, ngi) = [], (x, edge_index, edge_weight, node_graph_index)
        for level in range(2):
            h = getattr(self, f"GCN_{level}")([h, ei, ew])
            h, ei, ew, ngi = getattr(self, f"sag_pool_{level}")([h, ei, ew, ngi])
            readouts.append(mean_pool(h, ngi, num_graphs=self.num_graphs))
        h = torch.cat(readouts, dim=-1)
        return self.Dense_0(dropout(h, POOL_DROP_RATE, self.training, generator, keep_mask))


class ASAPClassifier(nn.Module):
    """``demo/demo_asap.py``'s ``ASAPModel``: ``GCN(32, relu)``, ``ASAP(32,
    k = 8)`` in its fixed mode, ``mean_pool``, dropout 0.4, a dense head.
    The demo trains it at batch ``ASAP_BATCH`` = 16: the fixed mode's pooled
    edges are every pair of the batch's G·k clusters."""

    def __init__(self, in_features: int, num_classes: int, num_graphs: int, device="cuda"):
        super().__init__()
        self.num_graphs = num_graphs
        self.GCN_0 = GCN(in_features, POOL_UNITS, activation=torch.relu, device=device)
        self.ASAP_0 = ASAP(POOL_UNITS, POOL_UNITS, k=ASAP_K, num_graphs=num_graphs, device=device)
        self.Dense_0 = nn.Linear(POOL_UNITS, num_classes, device=device)

    def forward(self, x, edge_index, edge_weight, node_graph_index, generator=None,
                keep_mask=None):
        h = self.GCN_0([x, edge_index, edge_weight])
        h, _, _, ngi = self.ASAP_0([h, edge_index, edge_weight, node_graph_index])
        h = mean_pool(h, ngi, num_graphs=self.num_graphs)
        return self.Dense_0(dropout(h, POOL_DROP_RATE, self.training, generator, keep_mask))


class Set2SetClassifier(nn.Module):
    """``demo/demo_set2set.py``'s ``Set2SetModel``: two ``GCN(32, relu)``,
    ``Set2Set`` over ``SET2SET_ITERATIONS`` = 3 iterations, dropout 0.4, a
    dense head."""

    def __init__(self, in_features: int, num_classes: int, num_graphs: int, device="cuda"):
        super().__init__()
        self.GCN_0 = GCN(in_features, POOL_UNITS, activation=torch.relu, device=device)
        self.GCN_1 = GCN(POOL_UNITS, POOL_UNITS, activation=torch.relu, device=device)
        self.Set2Set_0 = Set2Set(POOL_UNITS, SET2SET_ITERATIONS, num_graphs=num_graphs,
                                 device=device)
        self.Dense_0 = nn.Linear(2 * POOL_UNITS, num_classes, device=device)

    def forward(self, x, edge_index, edge_weight, node_graph_index, generator=None,
                keep_mask=None):
        h = self.GCN_0([x, edge_index, edge_weight])
        h = self.GCN_1([h, edge_index, edge_weight])
        h = self.Set2Set_0([h, node_graph_index])
        return self.Dense_0(dropout(h, POOL_DROP_RATE, self.training, generator, keep_mask))


POOL_MODELS = {"diff_pool": DiffPoolClassifier, "min_cut": MinCutPoolClassifier,
               "sag_pool": SAGPoolClassifier, "asap": ASAPClassifier, "set2set": Set2SetClassifier}


def _pool_params0(problem: GraphBatchProblem, name: str) -> Dict[str, torch.Tensor]:
    gen = torch.Generator().manual_seed(POOL_SEED)
    device = problem.x.device
    return {k: (glorot_uniform(tuple(v.shape), gen) if v.dim() == 2 else torch.zeros(v.shape))
            .to(device).requires_grad_()
            for k, v in problem.models[name].named_parameters()}


def init_pool_params(problem: GraphBatchProblem, name: str) -> Dict[str, torch.Tensor]:
    """Pool model ``name``'s initial weights as leaf tensors that require
    grad: every matrix glorot-uniform from a ``torch.Generator`` seeded
    ``POOL_SEED``, in the model's parameter order (the bound is symmetric
    in the two dims, so [in, out] kernels, [out, in] ``Linear`` weights and
    the LSTM cell's alike), every vector zeros. Also reseeds the dropout
    generator, so every run from these weights draws the same masks."""
    problem.generator.manual_seed(POOL_SEED)
    return _pool_params0(problem, name)


def pool_loss(p, problem: GraphBatchProblem, name: str, keep_mask=None):
    """Pool model ``name`` with weights ``p`` on the batch: mean softmax
    cross-entropy over its graphs, plus MinCutPool's cut and orthogonality
    losses. Dropout draws from the problem's generator unless ``keep_mask``
    is given."""
    out = functional_call(problem.models[name], p, (
        problem.x, problem.edge_index, problem.edge_weight, problem.node_graph_index),
        {"generator": problem.generator, "keep_mask": keep_mask}, strict=True)
    logits, aux = out if isinstance(out, tuple) else (out, None)
    loss = F.cross_entropy(logits, problem.y)
    return loss if aux is None else loss + (aux[0] + aux[1])


def pool_x6_calls(problem: GraphBatchProblem, name: str) -> list:
    """The COO SpMM calls of one training step of pool model ``name``, one
    ``(entries, stored, rows, width, dv)`` per GCN: the edge list's length
    with the self-loops (what the views take in), the entries the views
    keep (rows in range), the product's rows and width, and whether the
    backward also takes the values' gradient (``dv``, DiffPool's second
    level, whose edge weights come from the first level's assignment).
    Every call also runs ``dh``. SAGPool's second level keeps the edges
    whose ends both survive the first; they are counted at the initial
    weights."""
    n, e = problem.x.shape[0], problem.edge_index.shape[1]
    level0 = (e + n, problem.real_edges + n, n)
    if name == "diff_pool":
        c0, c1 = DIFF_POOL_CLUSTERS
        pairs = problem.num_graphs * c0 * c0
        level1 = (pairs + problem.num_graphs * c0,) * 2 + (problem.num_graphs * c0,)
        return [(*level0, POOL_UNITS, False), (*level0, c0, False),
                (*level1, POOL_UNITS, True), (*level1, c1, True)]
    if name == "min_cut":
        return [(*level0, POOL_UNITS, False), (*level0, POOL_UNITS, False),
                (*level0, MIN_CUT_CLUSTERS, False)]
    if name == "sag_pool":
        cap = problem.num_graphs * SAG_POOL_K
        level1 = (e + cap, _sag_pool_kept_edges(problem) + cap, cap)
        return [(*level0, POOL_UNITS, False), (*level0, 1, False),
                (*level1, POOL_UNITS, False), (*level1, 1, False)]
    raise ValueError(f"no X6 calls listed for {name!r}")


def _sag_pool_kept_edges(problem: GraphBatchProblem) -> int:
    """The edges SAGPool's first level keeps at the initial weights, by the
    plain versions (so counting launches nothing)."""
    p = _pool_params0(problem, "sag_pool")
    adj = SparseMatrix(problem.edge_index, problem.edge_weight, (problem.x.shape[0],) * 2)
    with torch.no_grad(), kernel_config.use_plain_versions():
        h = gcn(problem.x, adj, p["GCN_0.kernel"], p["GCN_0.bias"], activation=torch.relu)
        score = gcn(h, adj, p["score_gnn_0.kernel"], p["score_gnn_0.bias"])
        idx, valid = topk_pool_fixed(problem.node_graph_index, score, problem.num_graphs,
                                     SAG_POOL_K)
        _, kept, _, _ = induced_subgraph_fixed(h, problem.edge_index, problem.edge_weight,
                                               problem.node_graph_index, idx, valid,
                                               problem.num_graphs)
    return int((kept[0] < idx.shape[0]).sum())


def pool_step_bytes(problem: GraphBatchProblem, name: str) -> int:
    """Least bytes of a pool step's X6 passes (``pool_x6_calls``): each
    GCN's forward and ``dh`` over the stored entries, float32, and the
    ``dv`` SDDMM where the values need a gradient."""
    return sum(2 * spmm_pass_bytes(stored, rows, rows, width, 1, 4, 4)
               + (sddmm_pass_bytes(stored, rows, rows, width, 1, 4) if dv else 0)
               for _, stored, rows, width, dv in pool_x6_calls(problem, name))


# ---------------------------------------------------------------------------
# graph auto-encoder link prediction (demo/demo_gae.py), chip_smoke.py's GAE phase
# ---------------------------------------------------------------------------

class GaeEncoder(nn.Module):
    """``demo_gae.py``'s encoder: ``GCN(32, relu)``, dropout ``GAE_DROP_RATE``,
    ``GCN(16)``, both GCNs without a cache, as the demo calls them (each
    normalizes the graph per call and multiplies by the COO SpMM)."""

    def __init__(self, in_features: int, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.gcn0 = GCN(in_features, GAE_UNITS[0], activation=torch.relu, generator=generator,
                        device=device)
        self.gcn1 = GCN(GAE_UNITS[0], GAE_UNITS[1], generator=generator, device=device)

    def forward(self, x, edge_index, edge_weight, generator=None, keep_mask=None):
        h = self.gcn0([x, edge_index, edge_weight])
        h = dropout(h, GAE_DROP_RATE, self.training, generator, keep_mask)
        return self.gcn1([h, edge_index, edge_weight])


def predict_edge(embedded, edge_index):
    """The inner-product decoder: ``<z_row, z_col>`` per pair."""
    edge_index = torch.as_tensor(edge_index, device=embedded.device).long()
    return (embedded[edge_index[0]] * embedded[edge_index[1]]).sum(-1)


class GaeProblem(NamedTuple):
    x: torch.Tensor                    # [N, F] float32
    edge_index: torch.Tensor           # [2, E] the train split, both directions
    edge_weight: torch.Tensor          # [E] ones
    train_index: np.ndarray            # [2, T] int32, one edge per train pair (host)
    pos_train: torch.Tensor            # the same on the device
    test_index: np.ndarray             # [2, S] int32, the held-out pairs
    test_neg: np.ndarray               # [2, S] int32, pairs absent from the graph
    generator: torch.Generator         # dropout draws


def build_gae_problem(num_nodes: int = ARXIV_NODES, num_edges: int = ARXIV_EDGES,
                      device="cuda") -> GaeProblem:
    """``demo_gae.py``'s set-up on the synthetic arxiv graph:
    ``edge_train_test_split(test_size=0.15, random_state=0)``, the test
    negatives ``negative_sampling(S, N, edge_index=graph, replace=False,
    rng=0)``, and the train split made directed for the encoder."""
    graph = synthetic_ogbn_arxiv_like(num_nodes, num_edges)
    return gae_problem(graph.x, graph.edge_index, device)


def gae_problem(x, edge_index, device="cuda") -> GaeProblem:
    """``demo_gae.py``'s set-up on a graph given by its host arrays (``x``
    [N, F], ``edge_index`` [2, E], numpy): the split, the test negatives
    and the directed train graph of ``build_gae_problem``."""
    x, edge_index = np.asarray(x, np.float32), np.asarray(edge_index)
    n = x.shape[0]
    train_index, test_index, _, _ = edge_train_test_split(edge_index, GAE_TEST_SIZE,
                                                          random_state=GAE_SEED)
    test_neg = negative_sampling(test_index.shape[1], n, edge_index=edge_index,
                                 replace=False, rng=GAE_SEED)
    train_graph = Graph(x=x, edge_index=train_index).to_directed()
    return GaeProblem(torch.as_tensor(x, device=device),
                      torch.as_tensor(train_graph.edge_index, device=device),
                      torch.as_tensor(train_graph.edge_weight, device=device), train_index,
                      torch.as_tensor(train_index, device=device), test_index, test_neg,
                      torch.Generator(device=device))


def init_gae_model(problem: GaeProblem) -> GaeEncoder:
    """The encoder's weights (glorot-uniform from a generator seeded
    ``GAE_SEED``, zero biases); also reseeds the dropout generator."""
    problem.generator.manual_seed(GAE_SEED)
    return GaeEncoder(problem.x.shape[1], torch.Generator().manual_seed(GAE_SEED),
                      device=problem.x.device)


def gae_negatives(problem: GaeProblem, step: int) -> np.ndarray:
    """The demo's negatives of step ``step``: as many pairs as the train
    split, absent from it, ``rng=step``."""
    return negative_sampling(problem.train_index.shape[1], problem.x.shape[0],
                             edge_index=problem.train_index, rng=step)


def gae_loss(model: GaeEncoder, problem: GaeProblem, neg_index, keep_mask=None):
    """Sigmoid cross-entropy of the train pairs as 1 and ``neg_index`` as 0,
    the two means added (the demo's loss)."""
    z = model(problem.x, problem.edge_index, problem.edge_weight, generator=problem.generator,
              keep_mask=keep_mask)
    pos, neg = predict_edge(z, problem.pos_train), predict_edge(z, neg_index)
    return (F.binary_cross_entropy_with_logits(pos, torch.ones_like(pos))
            + F.binary_cross_entropy_with_logits(neg, torch.zeros_like(neg)))


def gae_test_auc(model: GaeEncoder, problem: GaeProblem) -> float:
    """``binary_auc`` of the held-out pairs against the test negatives, the
    encoder in eval mode (no dropout)."""
    model.eval()
    try:
        with torch.no_grad():
            z = model(problem.x, problem.edge_index, problem.edge_weight)
            scores = torch.cat([torch.sigmoid(predict_edge(z, problem.test_index)),
                                torch.sigmoid(predict_edge(z, problem.test_neg))])
    finally:
        model.train()
    labels = np.concatenate([np.ones(problem.test_index.shape[1]),
                             np.zeros(problem.test_neg.shape[1])])
    return binary_auc(scores.cpu().numpy(), labels)


def make_step(loss_fn: Callable, params: Dict[str, torch.Tensor], lr: float = 1e-2) -> Callable:
    """One Adam(lr) step per call (optax.adam's defaults: b1 0.9, b2 0.999,
    eps 1e-8 outside the sqrt); returns the pre-update loss."""
    opt = torch.optim.Adam(list(params.values()), lr=lr)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def csr_diag_rows(adj: CsrAdj) -> int:
    """Rows of ``adj`` with a split-off diagonal entry."""
    return 0 if adj.diag_val is None else int((adj.diag_eid < adj.num_edges).sum())


def csr_rows_read(adj: CsrAdj, side: CsrSide) -> int:
    """Rows of the operand that a pass over ``side`` reads: the distinct
    columns of its entries and the rows with a diagonal entry."""
    cols = side.col.long()
    if adj.diag_val is not None:
        cols = torch.cat([cols, torch.nonzero(adj.diag_eid < adj.num_edges).flatten()])
    return int(torch.unique(cols).numel())


def csr_pass_bytes(adj: CsrAdj, side: CsrSide, width: int, elt_bytes: int) -> int:
    """Least bytes of one SpMM pass ``A_side · h`` (see the module docstring)."""
    nnz = int(side.col.shape[0])
    return ((csr_rows_read(adj, side) + side.num_rows) * width * elt_bytes
            + 4 * (side.row_ptr.shape[0]) + 8 * nnz
            + (4 * side.num_rows if adj.diag_val is not None else 0))


def _spmm_step_bytes(problem: ArxivProblem, widths, elt: Optional[int] = None) -> int:
    adj = problem.adj
    if elt is None:
        elt = 2 if problem.spmm_dtype == torch.bfloat16 else 4
    return sum(csr_pass_bytes(adj, adj.fwd, w, elt) + csr_pass_bytes(adj, adj.bwd, w, elt)
               for w in widths)


# per attention pass (0 forward, 1 backward destination side, 2 backward
# source side): dense operands read and written with the destination rows
# (Q, out, dy read; out, dQ written) and with the source rows (K, V read; dK,
# dV written), [N, H] float32 statistics read and written (lse, D), flops per
# stored edge and feature
_GAT_DST_READ, _GAT_DST_WRITE = (1, 3, 2), (1, 1, 0)
_GAT_SRC_READ, _GAT_SRC_WRITE = (2, 2, 2), (0, 0, 2)
_GAT_STATS_READ, _GAT_STATS_WRITE = (0, 1, 2), (1, 1, 0)
_GAT_PASS_FLOPS = (4, 6, 8)


def gat_pass_bytes(layout: CsrGatLayout, kind: int, num_heads: int, head_width: int,
                   elt_bytes: int, with_keep: bool = False) -> int:
    """Least bytes of attention pass ``kind`` (see the module docstring)
    over a square or rectangular layout. Inputs are charged only on the rows
    an edge reads (destination rows with an entry, source rows with an
    entry); outputs on every row, as every row must be written."""
    n, s, nnz = layout.num_nodes, layout.num_src, int(layout.dst.nbr.shape[0])
    n_read = int((layout.dst.row_ptr.diff() > 0).sum())
    s_read = int((layout.src.row_ptr.diff() > 0).sum())
    rows = n if kind < 2 else s  # the side the pass walks
    return ((_GAT_DST_READ[kind] * n_read + _GAT_DST_WRITE[kind] * n
             + _GAT_SRC_READ[kind] * s_read + _GAT_SRC_WRITE[kind] * s)
            * num_heads * head_width * elt_bytes
            + 4 * num_heads * (_GAT_STATS_READ[kind] * n_read + _GAT_STATS_WRITE[kind] * n)
            + 4 * (rows + 1) + 4 * nnz
            + (4 * nnz + 4 * layout.num_edges * num_heads if with_keep else 0))


def gat_pass_flops(layout: CsrGatLayout, kind: int, num_heads: int, head_width: int) -> int:
    """Flops of attention pass ``kind`` on these edges: 2 per multiply-add
    of each per-edge dot product and each weighted row sum."""
    return _GAT_PASS_FLOPS[kind] * int(layout.dst.nbr.shape[0]) * num_heads * head_width


def gat_src_gather_work(layout: CsrGatLayout, num_heads: int, head_width: int,
                        elt_bytes: int) -> tuple:
    """(least bytes, flops) of the source-pass kernel's own function, the
    two-output weighted gather ``dK[c] = Σ w[e, H + h]·Q[r]``, ``dV[c] = Σ
    w[e, h]·dy[r]``: the Q and dy rows an entry names, w on the side's edges
    (2H float32 each), the side's row pointers, neighbours and edge ids
    read, dK and dV written on every source row; 2 flops per multiply-add
    of each output. ``gat_pass_bytes(kind=2)`` is the attention backward's
    own work (K, V, lse and D in place of w)."""
    s, nnz = layout.num_src, int(layout.src.nbr.shape[0])
    n_read = int((layout.dst.row_ptr.diff() > 0).sum())
    nbytes = ((2 * n_read + 2 * s) * num_heads * head_width * elt_bytes
              + 4 * 2 * num_heads * nnz + 4 * (s + 1) + 8 * nnz)
    return nbytes, 4 * nnz * num_heads * head_width


def _gat_step_bytes(problem: ArxivProblem) -> int:
    elt = 2 if problem.spmm_dtype == torch.bfloat16 else 4
    d = GAT_UNITS // GAT_HEADS
    return sum(gat_pass_bytes(problem.gat_layout, k, GAT_HEADS, d, elt) for k in range(3))


def _gat_merged_step_bytes(problem: ArxivProblem) -> int:
    """The multi-head SpMM's forward and ``dV`` and its ``d_att`` SDDMM,
    float32, over the layout's stored edges."""
    layout = problem.gat_layout
    n, nnz = layout.num_nodes, int(layout.dst.nbr.shape[0])
    return (2 * spmm_pass_bytes(nnz, n, n, GAT_MERGED_UNITS, GAT_HEADS, 4, 4)
            + sddmm_pass_bytes(nnz, n, n, GAT_MERGED_UNITS, GAT_HEADS, 4))


class Workload(NamedTuple):
    loss: Callable          # (params, problem, dense_bf16) -> scalar loss
    init: Callable          # problem -> params
    lr: float               # Adam learning rate
    bound_bytes: Callable   # problem -> least bytes of the step's sparse passes
    edges: Callable         # problem -> edges per step
    problem: str = "arxiv"  # the problem it runs on: "arxiv" or "reddit"
    counts: str = "edges"   # what edges/s counts, in the metric's name


def _arxiv_init(pr: ArxivProblem):
    return init_params(pr.x.shape[1], device=pr.x.device)


def _no_dense_bf16(loss: Callable) -> Callable:
    """Workloads whose dense products stay float32 as their JAX twins
    write them: ``dense_bf16`` does not apply."""
    return lambda p, pr, dense_bf16=True: loss(p, pr)


WORKLOADS = {
    "gcn_arxiv_fwd_bwd": Workload(
        precomputed_loss, _arxiv_init, 1e-2,
        lambda pr: _spmm_step_bytes(pr, (NUM_CLASSES,)), lambda pr: pr.num_edges_normed),
    "gcn_arxiv_canonical_fwd_bwd": Workload(
        canonical_loss, _arxiv_init, 1e-2,
        lambda pr: _spmm_step_bytes(pr, (HIDDEN, NUM_CLASSES)), lambda pr: pr.num_edges_normed),
    "gat_arxiv_fwd_bwd": Workload(
        _no_dense_bf16(gat_loss), lambda pr: init_gat_params(pr.x.shape[1], device=pr.x.device),
        1e-3, _gat_step_bytes, lambda pr: pr.gat_layout.num_edges),
    "sage_reddit_fwd_bwd": Workload(
        _no_dense_bf16(sage_loss), init_sage_params, 1e-2, sage_step_bytes,
        lambda pr: pr.x.shape[0] * sum(pr.fanouts), problem="reddit", counts="sampled_edges"),
    "gat_merged_arxiv_fwd_bwd": Workload(
        _no_dense_bf16(gat_loss),
        lambda pr: init_gat_merged_params(pr.x.shape[1], device=pr.x.device), 1e-3,
        _gat_merged_step_bytes, lambda pr: pr.gat_layout.num_edges),
}
GCN_WORKLOADS = ("gcn_arxiv_fwd_bwd", "gcn_arxiv_canonical_fwd_bwd")
# the CSR SpMM pairs (forward, dh) of a step of each workload on Kernels A and B
SPMM_PAIRS = {"gcn_arxiv_fwd_bwd": 1, "gcn_arxiv_canonical_fwd_bwd": 2,
              "sgc_arxiv_fwd_bwd": SGC_K, "appnp_arxiv_fwd_bwd": PPR_K,
              "ssgc_arxiv_fwd_bwd": PPR_K}


def _gin_workload(readout: str) -> Workload:
    return Workload(lambda p, pr, dense_bf16=True: gin_loss(p, pr, readout),
                    lambda pr: init_gin_params(pr, readout), 1e-3, gin_step_bytes,
                    lambda pr: pr.num_graphs, problem="graphs", counts="graphs")


WORKLOADS.update({name: _gin_workload(readout) for name, readout in GIN_READOUTS.items()})


def _pool_workload(model: str) -> Workload:
    return Workload(lambda p, pr, dense_bf16=True: pool_loss(p, pr, model),
                    lambda pr: init_pool_params(pr, model), POOL_LR,
                    lambda pr: pool_step_bytes(pr, model), lambda pr: pr.num_graphs,
                    problem="graphs", counts="graphs")


def _propagation_workload(name: str, loss: Callable, lr: float) -> Workload:
    return Workload(_no_dense_bf16(loss), lambda pr: init_propagation_params(pr, name), lr,
                    lambda pr: _spmm_step_bytes(pr, (NUM_CLASSES,) * SPMM_PAIRS[name], elt=4),
                    lambda pr: pr.num_edges_normed)


WORKLOADS.update({
    "sgc_arxiv_fwd_bwd": _propagation_workload("sgc_arxiv_fwd_bwd", sgc_loss, 0.2),
    "appnp_arxiv_fwd_bwd": _propagation_workload("appnp_arxiv_fwd_bwd", appnp_loss, 5e-3),
    "ssgc_arxiv_fwd_bwd": _propagation_workload("ssgc_arxiv_fwd_bwd", ssgc_loss, 5e-3),
})
WORKLOADS.update({name: _pool_workload(model) for name, model in POOL_WORKLOADS.items()})
WORKLOADS[HOST_SAGE_WORKLOAD] = Workload(
    _no_dense_bf16(host_sage_loss), init_host_sage_params, 1e-2, host_sage_step_bytes,
    lambda pr: pr.x.shape[0] * sum(pr.fanouts), problem="reddit_host", counts="sampled_edges")


def _workload_step(problem, name: str, dense_bf16: bool):
    wl = WORKLOADS[name]
    params = wl.init(problem)
    return make_step(lambda p: wl.loss(p, problem, dense_bf16), params, wl.lr)


def run_workload(problem, name: str, steps: int = 20,
                 dense_bf16: bool = True) -> dict:
    """Train ``WARMUP_STEPS + steps`` Adam steps of workload ``name`` from its
    initial weights and time the last ``steps`` with CUDA events. Returns
    the JSON line (``line``), the step time, the losses of every step and
    the number of steps taken."""
    device = problem.x.device
    if device.type != "cuda":
        raise ValueError(f"the bench times on a CUDA device, got {device}")
    step = _workload_step(problem, name, dense_bf16)
    losses = [step() for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    losses += [step() for _ in range(steps)]
    end.record()
    end.synchronize()
    step_s = start.elapsed_time(end) / 1e3 / steps
    wl = WORKLOADS[name]
    line = {
        "metric": f"{name}_{wl.counts}_per_sec_per_chip",
        "value": round(wl.edges(problem) / step_s, 1),
        "unit": wl.counts.replace("_", " ") + "/s",
        "vs_baseline": round(wl.bound_bytes(problem) / H100_HBM_BYTES_PER_S / step_s, 4),
    }
    return {"line": line, "step_ms": step_s * 1e3,
            "losses": torch.stack(losses).float().cpu().tolist(),
            "steps_taken": WARMUP_STEPS + steps}


def profile_workload(problem, name: str, dense_bf16: bool = True) -> dict:
    """Device time by kernel over ``PROFILE_STEPS`` steps of workload
    ``name`` (``torch.profiler``): the step's wall time, the device's busy
    time (sum of kernel self times; the step's kernels run on one stream, so
    they do not overlap), the ``PROFILE_TOP`` kernels by device time and the
    port's own kernels (``PORT_KERNELS``) wherever they rank, all per step."""
    from torch.profiler import ProfilerActivity, profile
    device = problem.x.device
    if device.type != "cuda":
        raise ValueError(f"the profile reads device time, got {device}")
    step = _workload_step(problem, name, dense_bf16)
    for _ in range(WARMUP_STEPS):
        step()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(PROFILE_STEPS):
            step()
        end.record()
        end.synchronize()
    kernels = device_time_by_kernel(prof, PROFILE_STEPS)
    step_ms = start.elapsed_time(end) / PROFILE_STEPS
    busy_ms = sum(k[1] for k in kernels)
    return {"profile": name, "step_ms": step_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / step_ms if step_ms else None,
            "kernels_per_step": sum(k[2] for k in kernels),
            "top": [[k[0][:90], round(k[1], 5), k[2]] for k in kernels[:PROFILE_TOP]],
            "port": [[k[0][:90], round(k[1], 5), k[2]] for k in kernels
                     if any(p in k[0] for p in PORT_KERNELS)]}


# ---------------------------------------------------------------------------
# workloads 8 and 9: the graph-parallel steps on spawned ranks
# ---------------------------------------------------------------------------

class HaloProblem(NamedTuple):
    num_parts: int
    x: np.ndarray                      # [P·npp, 128] float32, padding rows zero
    y: np.ndarray                      # [P·npp] int32
    mask: np.ndarray                   # [P·npp] float32, 1 on real nodes
    gcn_part: "EdgePartition"          # the normalized adjacency's partition
    gcn_spec: "HaloSpecEll"            # its packed halo plan
    gat_part: "EdgePartition"          # the self-looped graph's partition
    gat_spec: "GatHaloSpec"            # its fused-GAT halo plan
    params: Dict[str, object]          # per workload, the initial weights (numpy)
    partition_s: float                 # host seconds of partition_order
    plan_s: float                      # host seconds of the partitions and plans


def build_halo_problem(num_parts: int = HALO_PARTS, num_nodes: int = ARXIV_NODES,
                       num_edges: int = ARXIV_EDGES) -> HaloProblem:
    """``benchmarks/scaling.py``'s set-up on the host: the arxiv graph
    permuted by ``partition_order``, the normalized adjacency's partition and
    packed plan, the self-looped graph's partition and fused-GAT plan, and
    the weights (``default_rng(0)`` per workload, as each ``measure`` call
    draws them)."""
    import time
    from .parallel import (apply_node_permutation, build_gat_halo_spec, build_halo_spec,
                           partition_edges_by_row, partition_order)
    from .utils.graph_utils import add_self_loop_edge
    graph = synthetic_ogbn_arxiv_like(num_nodes=num_nodes, num_edges=num_edges)
    n = graph.num_nodes
    t0 = time.perf_counter()
    perm = partition_order(graph.edge_index, n, num_parts)
    partition_s = time.perf_counter() - t0
    graph, _ = apply_node_permutation(graph, perm)
    t0 = time.perf_counter()
    normed = gcn_norm_adj(SparseMatrix(graph.edge_index, graph.edge_weight, (n, n),
                                       device="cpu"))
    gcn_part = partition_edges_by_row(normed.index.numpy(), normed.value.numpy(), n, num_parts)
    loops, ones = add_self_loop_edge(graph.edge_index, n)
    gat_part = partition_edges_by_row(loops, ones, n, num_parts)
    gcn_spec, gat_spec = build_halo_spec(gcn_part, layout="ell"), build_gat_halo_spec(gat_part)
    plan_s = time.perf_counter() - t0
    n_pad = gcn_part.num_nodes_padded
    x = np.zeros((n_pad, graph.x.shape[1]), np.float32)
    x[:n] = graph.x
    y = np.zeros(n_pad, np.int32)
    y[:n] = graph.y
    mask = np.zeros(n_pad, np.float32)
    mask[:n] = 1.0

    def normal(rng, *shape):
        return rng.normal(scale=0.1, size=shape).astype(np.float32)

    rng = np.random.default_rng(0)
    gcn = [(normal(rng, x.shape[1], HALO_GCN_HIDDEN), np.zeros(HALO_GCN_HIDDEN, np.float32)),
           (normal(rng, HALO_GCN_HIDDEN, NUM_CLASSES), np.zeros(NUM_CLASSES, np.float32))]
    rng, layers, fin = np.random.default_rng(0), [], x.shape[1]
    for heads, units in HALO_GAT_DIMS:
        hd = heads * units
        zeros = np.zeros(hd, np.float32)
        layers.append((normal(rng, fin, hd), zeros, normal(rng, fin, hd), zeros,
                       normal(rng, fin, hd), zeros))
        fin = hd
    gat = (layers, (normal(rng, fin, NUM_CLASSES), np.zeros(NUM_CLASSES, np.float32)))
    return HaloProblem(num_parts, x, y, mask, gcn_part, gcn_spec, gat_part, gat_spec,
                       {"gcn_arxiv_halo_p4_fwd_bwd": gcn, "gat_arxiv_halo_p4_fwd_bwd": gat},
                       partition_s, plan_s)


def halo_jobs(problem: HaloProblem, name: str, steps: int, warmup: int = 0,
              timed: bool = False, plain: bool = False, seed: int = 0) -> list:
    """Per rank, the job list of workload ``name`` (``HALO_WORKLOADS``): the
    rank's rows and its shard of the plan."""
    from .parallel import ShardJob, rank_gat_plan, rank_halo_plan
    kind = HALO_WORKLOADS[name]
    npp = problem.gcn_part.nodes_per_part
    if kind == "gcn":
        options = {"learning_rate": 1e-2}
    else:
        options = {"layer_dims": HALO_GAT_DIMS, "learning_rate": 5e-3,
                   "edge_drop_rate": HALO_DROP_RATE,
                   "feat_drop_rate": HALO_DROP_RATE, "seed": seed}
    jobs = []
    for r in range(problem.num_parts):
        rows = slice(r * npp, (r + 1) * npp)
        plan = (rank_halo_plan(problem.gcn_spec, r, "cpu") if kind == "gcn"
                else rank_gat_plan(problem.gat_spec, r, "cpu"))
        jobs.append([ShardJob(name, kind, problem.params[name], problem.x[rows],
                              problem.y[rows], problem.mask[rows], plan,
                              dict(options, plain=plain), steps, warmup, timed)])
    return jobs


def halo_pass_bytes(problem: HaloProblem, name: str) -> int:
    """Least bytes of one step's sparse passes over all ranks: for the GCN
    each layer's forward and ``dh`` on both blocks (float32, widths 64 and
    40); for the GAT each layer's three attention passes (float32)."""
    if HALO_WORKLOADS[name] == "gcn":
        return sum(csr_pass_bytes(adj, side, width, 4)
                   for adj in (*problem.gcn_spec.local, *problem.gcn_spec.remote)
                   for side in (adj.fwd, adj.bwd) for width in (HALO_GCN_HIDDEN, NUM_CLASSES))
    return sum(gat_pass_bytes(layout, kind, heads, units, 4, with_keep=True)
               for layout in problem.gat_spec.layouts for heads, units in HALO_GAT_DIMS
               for kind in range(3))


def _run_rank_workload(jobs, name: str, device, profile: bool):
    """Spawn the ranks of ``jobs`` on the card (gloo), after building the
    kernels once; returns every rank's results, the slowest rank's median
    step and, with ``profile``, each rank's device time over the profiled
    steps, the card's busy time (the ranks' sum) and its idle share."""
    from .ops import _build
    from .parallel import run_ranks
    if torch.device(device).type != "cuda":
        raise ValueError(f"the bench times on a CUDA device, got {device}")
    _build.build_all()  # once, before the ranks load the libraries
    if profile:
        jobs = [[job._replace(options=dict(job.options, profile_steps=PROFILE_STEPS))
                 for job in rank] for rank in jobs]
    results = run_ranks(jobs, backend="gloo", device=device)
    step_ms = max(float(np.median(rank[0]["step_ms"])) for rank in results)
    summary = None
    if profile:
        busy = [sum(k[1] for k in rank[0]["kernels"]) for rank in results]
        summary = {
            "profile": name, "step_ms": step_ms, "rank_busy_ms": [round(b, 4) for b in busy],
            "card_busy_ms": round(sum(busy), 4),
            "card_idle_share": round(1.0 - sum(busy) / step_ms, 4),
            "top_rank0": [[k[0][:90], round(k[1], 5), k[2]]
                          for k in results[0][0]["kernels"][:PROFILE_TOP]],
            "port_rank0": [[k[0][:90], round(k[1], 5), k[2]] for k in results[0][0]["kernels"]
                           if any(p in k[0] for p in PORT_KERNELS)]}
    return results, step_ms, summary


def run_halo_workload(problem: HaloProblem, name: str, steps: int = 20, device="cuda",
                      profile: bool = False) -> dict:
    """Train ``WARMUP_STEPS + steps`` steps of halo workload ``name`` on
    ``problem.num_parts`` spawned ranks sharing one card over gloo and time
    the last ``steps`` on each rank with CUDA events. Returns the JSON line
    (the slowest rank's median step), the step time, every rank's results
    (``parallel.runner.run_job``) and the number of steps taken; with
    ``profile``, also ``profile`` (``_run_rank_workload``)."""
    jobs = halo_jobs(problem, name, WARMUP_STEPS + steps, WARMUP_STEPS, True)
    results, step_ms, summary = _run_rank_workload(jobs, name, device, profile)
    gcn = HALO_WORKLOADS[name] == "gcn"
    part, spec = ((problem.gcn_part, problem.gcn_spec) if gcn
                  else (problem.gat_part, problem.gat_spec))
    edges = int((part.local_row < part.nodes_per_part).sum())
    line = {"metric": f"{name}_edges_per_sec_per_chip",
            "value": round(edges / step_ms * 1e3, 1), "unit": "edges/s",
            "vs_baseline": round(halo_pass_bytes(problem, name) / H100_HBM_BYTES_PER_S
                                 / (step_ms / 1e3), 4),
            "halo_fraction": round(spec.halo_fraction, 4), "cap": spec.capacity,
            "setup": f"{problem.num_parts} ranks sharing one card over gloo"}
    out = {"line": line, "step_ms": step_ms, "ranks": results,
           "steps_taken": WARMUP_STEPS + steps}
    if profile:
        out["profile"] = summary
    return out


# ---------------------------------------------------------------------------
# workload 13: the node-partitioned sampled SAGE on spawned ranks
# ---------------------------------------------------------------------------

class SampledSageProblem(NamedTuple):
    num_parts: int
    num_nodes: int                     # the graph's nodes (the metric counts them)
    x: np.ndarray                      # [n_pad, 128] float32, padding rows zero
    y: np.ndarray                      # [n_pad] int32
    mask: np.ndarray                   # [n_pad] float32, 1 on real nodes
    shards: Dict[str, np.ndarray]      # build_csr_shards' arrays, [P, ...]
    params: list                       # the initial weights (numpy)


def build_sampled_sage_problem(num_parts: int = HALO_PARTS, num_nodes: int = ARXIV_NODES,
                               num_edges: int = ARXIV_EDGES) -> SampledSageProblem:
    """``benchmarks/scaling.py``'s sampled-SAGE set-up on the host: the
    arxiv graph in its own order, nodes padded to a multiple of 128 ×
    ``num_parts``, the CSR shards, the weights (``default_rng(0)``)."""
    from .parallel.sampled_sage import build_csr_shards, init_sampled_sage_params
    graph = synthetic_ogbn_arxiv_like(num_nodes=num_nodes, num_edges=num_edges)
    n = graph.num_nodes
    multiple = SAMPLED_SAGE_ROW_MULTIPLE * num_parts
    n_pad = -(-n // multiple) * multiple
    x = np.zeros((n_pad, graph.x.shape[1]), np.float32)
    x[:n] = graph.x
    y = np.zeros(n_pad, np.int32)
    y[:n] = graph.y
    mask = np.zeros(n_pad, np.float32)
    mask[:n] = 1.0
    shards = build_csr_shards(graph.edge_index, n_pad, num_parts)
    params = init_sampled_sage_params(np.random.default_rng(0), x.shape[1], NUM_CLASSES,
                                      len(SAMPLED_SAGE_FANOUTS), SAMPLED_SAGE_HIDDEN)
    return SampledSageProblem(num_parts, n, x, y, mask, shards, params)


def sampled_sage_jobs(problem: SampledSageProblem, steps: int, warmup: int = 0,
                      timed: bool = False, plain: bool = False, seed: int = 0) -> list:
    """Per rank, the job list of workload 13: the rank's rows and its part
    of the CSR shards."""
    from .parallel import ShardJob
    n_local = problem.x.shape[0] // problem.num_parts
    options = {"k": SAMPLED_SAGE_FANOUTS, "learning_rate": 1e-2, "seed": seed, "plain": plain}
    jobs = []
    for r in range(problem.num_parts):
        rows = slice(r * n_local, (r + 1) * n_local)
        jobs.append([ShardJob(SAMPLED_SAGE_WORKLOAD, "sage", problem.params, problem.x[rows],
                              problem.y[rows], problem.mask[rows],
                              {name: a[r] for name, a in problem.shards.items()}, options,
                              steps, warmup, timed)])
    return jobs


def sampled_sage_pass_bytes(problem: SampledSageProblem) -> int:
    """Least bytes of one step's sparse passes over all ranks: per rank and
    layer the draw over its rows and column shard, the aggregation forward
    and backward against the gathered table (float32, ``hidden // 2``
    wide)."""
    n_table = problem.x.shape[0]
    n_local = n_table // problem.num_parts
    width = SAMPLED_SAGE_HIDDEN // 2
    total = 0
    for r in range(problem.num_parts):
        nnz = int(problem.shards["degree"][r].sum())
        for k in SAMPLED_SAGE_FANOUTS:
            total += (draw_pass_bytes(k, n_local, nnz, "sorted_weight" in problem.shards)
                      + aggregate_pass_bytes(n_table, k, n_local, width, 4)
                      + aggregate_pass_bytes(n_table, k, n_local, width, 4, backward=True))
    return total


def run_sampled_sage_workload(problem: SampledSageProblem, steps: int = 20, device="cuda",
                              profile: bool = False) -> dict:
    """Train ``WARMUP_STEPS + steps`` steps of workload 13 on
    ``problem.num_parts`` spawned ranks sharing one card over gloo, timed as
    ``run_halo_workload`` times them; the line counts ``num_nodes ·
    Σk`` sampled edges over the slowest rank's median step."""
    name = SAMPLED_SAGE_WORKLOAD
    jobs = sampled_sage_jobs(problem, WARMUP_STEPS + steps, WARMUP_STEPS, True)
    results, step_ms, summary = _run_rank_workload(jobs, name, device, profile)
    line = {"metric": f"{name}_sampled_edges_per_sec_per_chip",
            "value": round(problem.num_nodes * sum(SAMPLED_SAGE_FANOUTS) / step_ms * 1e3, 1),
            "unit": "sampled edges/s",
            "vs_baseline": round(sampled_sage_pass_bytes(problem) / H100_HBM_BYTES_PER_S
                                 / (step_ms / 1e3), 4),
            "setup": f"{problem.num_parts} ranks sharing one card over gloo"}
    out = {"line": line, "step_ms": step_ms, "ranks": results,
           "steps_taken": WARMUP_STEPS + steps}
    if profile:
        out["profile"] = summary
    return out

# ---------------------------------------------------------------------------
# workload 17: the edge-partitioned MinCutPool step on spawned ranks
# ---------------------------------------------------------------------------

class MincutProblem(NamedTuple):
    num_parts: int
    x: np.ndarray                      # [P·npp, 128] float32, padding rows zero
    y: np.ndarray                      # [P·npp] int32
    mask: np.ndarray                   # [P·npp] float32, 1 on real nodes
    part: "EdgePartition"              # the normalized adjacency's partition
    adjs: list                         # per rank its RankAdjacency, on the host
    params: tuple                      # the initial weights (numpy)
    num_edges: int                     # the normalized adjacency's nonzeros
    partition_s: float                 # host seconds of partition_order
    plan_s: float                      # host seconds of the normalization, partition, CSR


def build_mincut_problem(num_parts: int = HALO_PARTS, num_nodes: int = ARXIV_NODES,
                         num_edges: int = ARXIV_EDGES) -> MincutProblem:
    """``benchmarks/scaling.py``'s MinCut set-up on the host: the arxiv graph
    permuted by ``partition_order``, ``adj_norm_edge(...,
    add_self_loop=False)`` partitioned by rows, each rank's rectangular
    ``RankAdjacency`` and the weights (``default_rng(0)``)."""
    import time
    from .parallel import (apply_node_permutation, partition_edges_by_row, partition_order,
                           rank_adjacency)
    from .utils.graph_utils import adj_norm_edge
    graph = synthetic_ogbn_arxiv_like(num_nodes=num_nodes, num_edges=num_edges)
    n = graph.num_nodes
    t0 = time.perf_counter()
    perm = partition_order(graph.edge_index, n, num_parts)
    partition_s = time.perf_counter() - t0
    graph, _ = apply_node_permutation(graph, perm)
    t0 = time.perf_counter()
    index, value = adj_norm_edge(graph.edge_index, n, graph.edge_weight, add_self_loop=False)
    part = partition_edges_by_row(index.numpy(), value.numpy(), n, num_parts)
    npp, n_pad = part.nodes_per_part, part.num_nodes_padded
    adjs = [rank_adjacency(part.local_row[r], part.global_col[r], part.value[r], npp, n_pad,
                           device="cpu") for r in range(num_parts)]
    plan_s = time.perf_counter() - t0
    x = np.zeros((n_pad, graph.x.shape[1]), np.float32)
    x[:n] = graph.x
    y = np.zeros(n_pad, np.int32)
    y[:n] = graph.y
    mask = np.zeros(n_pad, np.float32)
    mask[:n] = 1.0
    rng = np.random.default_rng(0)

    def normal(*shape):
        return rng.normal(scale=0.1, size=shape).astype(np.float32)

    f, h, c = x.shape[1], MINCUT_HIDDEN, MINCUT_CLUSTERS
    params = ((normal(f, h), np.zeros(h, np.float32)), (normal(f, c), np.zeros(c, np.float32)),
              (normal(h, h), np.zeros(h, np.float32)),
              (normal(2 * h, NUM_CLASSES), np.zeros(NUM_CLASSES, np.float32)))
    edges = int((part.local_row < npp).sum())
    return MincutProblem(num_parts, x, y, mask, part, adjs, params, edges, partition_s, plan_s)


def mincut_jobs(problem: MincutProblem, steps: int, warmup: int = 0, timed: bool = False,
                plain: bool = False, variant: str = "min_cut") -> list:
    """Per rank, the job list of workload 17 (or its ``variant="diff"``
    twin): the rank's rows and its prebuilt ``RankAdjacency``; the mask
    flags the real rows for both the loss and the assignment."""
    from .parallel import ShardJob
    npp = problem.part.nodes_per_part
    options = {"learning_rate": 1e-2, "variant": variant, "plain": plain}
    return [[ShardJob(MINCUT_WORKLOAD, "mincut", problem.params, problem.x[r * npp:(r + 1) * npp],
                      problem.y[r * npp:(r + 1) * npp], problem.mask[r * npp:(r + 1) * npp],
                      problem.adjs[r], options, steps, warmup, timed)]
            for r in range(problem.num_parts)]


def mincut_pass_bytes(problem: MincutProblem) -> int:
    """Least bytes of one step's four Kernel A passes over all ranks: per
    rank the forward and ``dh`` at F = hidden + C and at F = C, float32."""
    widths = (MINCUT_HIDDEN + MINCUT_CLUSTERS, MINCUT_CLUSTERS)
    return sum(csr_pass_bytes(adj.csr, side, width, 4) for adj in problem.adjs
               for side in (adj.csr.fwd, adj.csr.bwd) for width in widths)


def run_mincut_workload(problem: MincutProblem, steps: int = 20, device="cuda",
                        profile: bool = False) -> dict:
    """Train ``WARMUP_STEPS + steps`` steps of workload 17 on
    ``problem.num_parts`` spawned ranks sharing one card over gloo, timed as
    ``run_halo_workload`` times them; the line counts the normalized
    adjacency's nonzeros over the slowest rank's median step."""
    name = MINCUT_WORKLOAD
    jobs = mincut_jobs(problem, WARMUP_STEPS + steps, WARMUP_STEPS, True)
    results, step_ms, summary = _run_rank_workload(jobs, name, device, profile)
    line = {"metric": f"{name}_edges_per_sec_per_chip",
            "value": round(problem.num_edges / step_ms * 1e3, 1), "unit": "edges/s",
            "vs_baseline": round(mincut_pass_bytes(problem) / H100_HBM_BYTES_PER_S
                                 / (step_ms / 1e3), 4),
            "setup": f"{problem.num_parts} ranks sharing one card over gloo"}
    out = {"line": line, "step_ms": step_ms, "ranks": results,
           "steps_taken": WARMUP_STEPS + steps}
    if profile:
        out["profile"] = summary
    return out


# ---------------------------------------------------------------------------
# the tiled A/B: X7 against the CSR path (benchmarks/tiled_spmm_ab.py)
# ---------------------------------------------------------------------------

# benchmarks/tiled_spmm_ab.py's constants: tile sizes counted, the tile timed,
# the width, the community graph's in-community share, the tiles' budget
TILED_AB_TILES, TILED_AB_TILE, TILED_AB_F, TILED_AB_INTRA = (128, 256), 128, 128, 0.95
TILED_AB_BUDGET_BYTES = 6e9
# the random graph at a size whose tiles fit the budget, at arxiv's mean degree
TILED_AB_SMALL = (32_768, 225_669)
TILED_AB_PATHS = ("csr_fwd", "tiled_fwd", "csr_fwd_bwd", "tiled_fwd_bwd")
# measure_step_time's runs per path (benchmarks/tiled_spmm_ab.py:141): lo, then hi steps
TILED_AB_TIMING = dict(lo=4, hi=16)


def community_graph(num_nodes: int = ARXIV_NODES, num_edges: int = ARXIV_EDGES) -> np.ndarray:
    """``benchmarks/tiled_spmm_ab.py``'s most favourable graph for the tiled
    formulation, bit for bit (seed 0): contiguous communities of
    ``TILED_AB_TILE`` nodes and ``TILED_AB_INTRA`` of the edges inside their
    community; [2, E] int32 (dst, src)."""
    rng = np.random.default_rng(0)
    size = TILED_AB_TILE
    src = rng.integers(0, num_nodes, size=num_edges)
    blk = src // size
    local = rng.integers(0, size, size=num_edges)
    intra_dst = np.minimum(blk * size + local, num_nodes - 1)
    dst = np.where(rng.random(num_edges) < TILED_AB_INTRA, intra_dst,
                   rng.integers(0, num_nodes, size=num_edges))
    return np.stack([dst, src]).astype(np.int32)


def tiled_ab_graphs(num_nodes: int = ARXIV_NODES, num_edges: int = ARXIV_EDGES):
    """(name, edge_index, num_nodes) of the A/B's graphs: the random arxiv
    graph, the community graph, and the random graph at
    ``TILED_AB_SMALL``."""
    small_n, small_e = TILED_AB_SMALL
    return [("random", synthetic_ogbn_arxiv_like(num_nodes, num_edges).edge_index, num_nodes),
            ("community", community_graph(num_nodes, num_edges), num_nodes),
            (f"random_n{small_n}", synthetic_ogbn_arxiv_like(small_n, small_e).edge_index,
             small_n)]


def tiled_ab_occupancy(index, num_nodes: int) -> dict:
    """``occupancy_t*``, ``B_t*`` and ``tile_GB_t*`` of the normalized
    adjacency's ``index`` at each of ``TILED_AB_TILES`` (bf16 tiles and one
    float32 operand tile each, as ``tiled_spmm_ab.py`` counts), no tile built."""
    out = {}
    for t in TILED_AB_TILES:
        b = count_occupied_tiles(index, (num_nodes, num_nodes), t)
        out[f"occupancy_t{t}"] = round(index.shape[1] / (b * t * t), 5)
        out[f"B_t{t}"] = b
        out[f"tile_GB_t{t}"] = round((b * t * t * 2 + b * t * TILED_AB_F * 4) / 1e9, 2)
    return out


class TiledAbProblem(NamedTuple):
    adj: CsrAdj                # the normalized adjacency, CSR, float32
    tiles: TiledSpmm           # its packing at TILED_AB_TILE, bf16 tiles
    h: torch.Tensor            # [N, TILED_AB_F] float32
    c: torch.Tensor            # [N, TILED_AB_F] float32, the fwd+bwd loss's weights


def build_tiled_ab(name: str, edge_index, num_nodes: int, device="cuda"):
    """The A/B's set-up of one graph (``tiled_spmm_ab.py``'s ``time_paths``):
    the normalized adjacency and its CSR, the occupancy line, and, when the
    tiles of both directions fit ``TILED_AB_BUDGET_BYTES`` in bf16, the tile
    packing and the inputs. Returns (problem or None, occupancy dict)."""
    n = num_nodes
    cache = {}
    normed = gcn_norm_adj(SparseMatrix(edge_index, np.ones(edge_index.shape[1], np.float32),
                                       (n, n), device=device), cache=cache)
    adj = maybe_compile_ell(normed, cache, compute_cache_key("both", True, True, True, False))
    idx, val = normed.index.cpu().numpy(), normed.value.cpu().numpy()
    occ = tiled_ab_occupancy(idx, n)
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in occ.items()), flush=True)
    t = TILED_AB_TILE
    est = 2 * occ[f"B_t{t}"] * t * t * 2
    if est > TILED_AB_BUDGET_BYTES:
        print(f"[{name}] SKIP timing: tile matrices would need {est / 1e9:.1f} GB "
              f"(> {TILED_AB_BUDGET_BYTES / 1e9:.0f} GB budget) — occupancy "
              f"{occ[f'occupancy_t{t}']} decides", flush=True)
        return None, occ
    ts = build_tiled_spmm(idx, val, (n, n), tile=t, dtype=torch.bfloat16, device=device,
                          max_bytes=TILED_AB_BUDGET_BYTES)
    rng = np.random.default_rng(1)
    h0 = torch.as_tensor(rng.normal(size=(n, TILED_AB_F)), dtype=torch.float32, device=device)
    c = torch.as_tensor(rng.normal(size=(n, TILED_AB_F)), dtype=torch.float32, device=device)
    return TiledAbProblem(adj, ts, h0, c), occ


def tiled_ab_steps(problem: TiledAbProblem) -> Dict[str, Callable]:
    """The four chained steps of the A/B (``tiled_spmm_ab.py:112-133``): the
    forward ``A·h·1e-6 + h`` and the gradient step ``h - 1e-9·∇(A·h · c)``,
    through the CSR SpMM and through X7."""
    spmms = {"csr": lambda h: csr_spmm(problem.adj, h),
             "tiled": lambda h: tiled_spmm(problem.tiles, h)}

    def fwd(spmm):
        return lambda h: (spmm(h) * 1e-6 + h,)

    def fwd_bwd(spmm):
        def step(h):
            hh = h.detach().requires_grad_()
            (g,) = torch.autograd.grad(torch.vdot(spmm(hh).flatten(), problem.c.flatten()), hh)
            return (h - 1e-9 * g,)
        return step

    return {"csr_fwd": fwd(spmms["csr"]), "tiled_fwd": fwd(spmms["tiled"]),
            "csr_fwd_bwd": fwd_bwd(spmms["csr"]), "tiled_fwd_bwd": fwd_bwd(spmms["tiled"])}


def tiled_ab(num_nodes: int = ARXIV_NODES, num_edges: int = ARXIV_EDGES, device="cuda") -> dict:
    """``benchmarks/tiled_spmm_ab.py`` on the card: per graph its occupancy
    line, then (when its tiles fit the budget) the four paths' step times
    (``measure_step_time``), then one ``VERDICT`` line per graph. Returns
    {graph: {"occupancy": ..., "ms": {path: ms} or None}}."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"the A/B times on a CUDA device, got {device}")
    out = {}
    for name, edge_index, n in tiled_ab_graphs(num_nodes, num_edges):
        problem, occ = build_tiled_ab(name, edge_index, n, device=device)
        out[name] = {"occupancy": occ, "ms": None}
        if problem is None:
            continue
        e = edge_index.shape[1]
        roofline = estimate_spmm_roofline(problem.adj.num_edges, n, TILED_AB_F)
        print(f"[{name}] one float32 SpMM pass at its byte bound: {roofline / 1e6:.1f}M "
              f"edges/s", flush=True)
        steps, ms = tiled_ab_steps(problem), {}
        for label in TILED_AB_PATHS:
            dt = measure_step_time(steps[label], (problem.h,), **TILED_AB_TIMING)
            ms[label] = dt * 1e3
            print(f"[{name}] {label}: {dt * 1e3:.4f} ms ({e / dt / 1e6:.1f}M edges/s)",
                  flush=True)
        out[name]["ms"] = ms
        del problem, steps
        torch.cuda.empty_cache()
    for name, res in out.items():
        if res["ms"] is None:
            print(f"VERDICT {name}: tiles don't fit memory — ELL wins by default "
                  f"(occupancy too low)", flush=True)
            continue
        speedup = res["ms"]["csr_fwd_bwd"] / res["ms"]["tiled_fwd_bwd"]
        res["speedup"] = speedup
        print(f"VERDICT {name}: tiled/ELL fwd+bwd speedup {speedup:.2f}x "
              f"({'tiled wins' if speedup > 1 else 'ELL wins'})", flush=True)
    return out


def main(num_nodes: int = ARXIV_NODES, num_edges: int = ARXIV_EDGES, steps: int = 20,
         device="cuda", spmm_bf16: bool = True, dense_bf16: bool = True,
         profile: bool = False) -> list:
    """Run the eighteen workloads on ``device`` and print their JSON lines;
    with ``profile``, also print each workload's per-kernel device time (for
    the multi-rank workloads, each rank's and the card's busy time).
    ``num_nodes``/``num_edges`` size the arxiv graph (the multi-rank
    workloads' too); the Reddit graph and the GIN batch (the pool
    workloads' too) are built at their full size, workload 18's host
    problem after the others of its kind."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"the bench times on a CUDA device, got {device}")
    problems = {"arxiv": build_problem(num_nodes, num_edges, device=device,
                                       spmm_bf16=spmm_bf16)}
    builders = {"reddit": build_sage_problem, "graphs": build_graph_problem,
                "reddit_host": build_host_sage_problem}
    results = []
    for name, wl in WORKLOADS.items():
        if wl.problem not in problems:
            problems[wl.problem] = builders[wl.problem](device=device)
        problem = problems[wl.problem]
        res = run_workload(problem, name, steps=steps, dense_bf16=dense_bf16)
        if wl.problem == "graphs":
            print(json.dumps({"workload": name, **gin_edge_rates(problem, res["step_ms"])}),
                  flush=True)
        elif wl.problem == "reddit_host":
            print(json.dumps({"workload": name, **host_sage_rates(problem, steps)}), flush=True)
        print(json.dumps(res["line"]), flush=True)
        results.append(res)
        if profile:
            print(json.dumps(profile_workload(problem, name, dense_bf16=dense_bf16)),
                  flush=True)
    halo = build_halo_problem(num_nodes=num_nodes, num_edges=num_edges)
    runs = [lambda name: run_halo_workload(halo, name, steps=steps, device=device,
                                           profile=profile)] * len(HALO_WORKLOADS)
    sampled = build_sampled_sage_problem(num_nodes=num_nodes, num_edges=num_edges)
    runs.append(lambda name: run_sampled_sage_workload(sampled, steps=steps, device=device,
                                                       profile=profile))
    mincut = build_mincut_problem(num_nodes=num_nodes, num_edges=num_edges)
    runs.append(lambda name: run_mincut_workload(mincut, steps=steps, device=device,
                                                 profile=profile))
    for name, run in zip([*HALO_WORKLOADS, SAMPLED_SAGE_WORKLOAD, MINCUT_WORKLOAD], runs):
        res = run(name)
        print(json.dumps(res["line"]), flush=True)
        if profile:
            print(json.dumps(res["profile"]), flush=True)
        results.append(res)
    return results


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--num-nodes", type=int, default=ARXIV_NODES)
    parser.add_argument("--num-edges", type=int, default=ARXIV_EDGES)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--no-spmm-bf16", action="store_true")
    parser.add_argument("--no-dense-bf16", action="store_true")
    parser.add_argument("--profile", action="store_true",
                        help="also print per-kernel device time (torch.profiler)")
    parser.add_argument("--tiled-ab", action="store_true",
                        help="run the tiled SpMM A/B (benchmarks/tiled_spmm_ab.py) instead")
    args = parser.parse_args()
    if args.tiled_ab:
        tiled_ab(args.num_nodes, args.num_edges, args.device)
    else:
        main(args.num_nodes, args.num_edges, args.steps, args.device,
             spmm_bf16=not args.no_spmm_bf16, dense_bf16=not args.no_dense_bf16,
             profile=args.profile)
