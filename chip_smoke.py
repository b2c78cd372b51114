#!/usr/bin/env python3
"""On-card check of the PyTorch / CUDA port (``tf_geometric_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:

1. Device: refuse to run without CUDA; print the card's name and power limit.
2. Build: compile every kernel source under ``tf_geometric_tpu_torch/csrc``
   with nvcc (all at once) and the native host library
   (``tf_geometric_tpu_torch/native/graph_ops.cpp``, g++) and print the
   build times; fail if either does not build.
3. Kernels: on the ogbn-arxiv-shaped graph's normalized ``CsrAdj`` (both
   product directions), at F in {40, 128, 256}, in float32 and bfloat16,
   hold Kernel A (``csr_spmm``) and Kernel B (``sorted_segment_sum``)
   against their plain PyTorch versions on the same inputs (float32:
   rtol = atol = 1e-4, order of summation only; bfloat16: rtol = atol =
   2e-2, one bf16 rounding of differently ordered float32 sums), and the
   composed product against ``torch.sparse.mm`` in float32, and Kernel A
   against a second run of the same call, bit for bit. Print each side's
   longest row beside the longest serial walks (the most edges one lane
   group of Kernel A reads, the most partials Kernel B adds into one row).
   Time each kernel, its plain version and ``torch.sparse.mm`` (the library
   yardstick, never called by the port) with CUDA events, beside its byte
   bound and, for Kernel A, the time every edge's gather would take from
   device memory; Kernel A (as the main path calls it: one launch, the hub
   merge included), Kernel B (on Kernel A's hub partials without the merge)
   and their library calls also by their device time under
   ``torch.profiler`` (CUDA events around back-to-back calls of a short
   kernel time the host's launches). Then Kernel A's hub merge: on the
   arxiv adjacency's forward side, the transposed adjacency's backward side
   and, after the halo problem is built, every halo block side with hub
   rows, at F = 40 and 256 (halo: 64 and 40), float32 and bfloat16, the
   merged launch against Kernel A without the merge followed by Kernel B
   (float32 bit for bit, bfloat16 2e-2), against the plain version and
   against a second run (bit for bit), the tickets all 0 after. Then time
   ``side_matmul`` on the forward side at hub split widths 32, 64
   (``SPLIT_WIDTH``), 128 and 256, at F = 40 float32 and F = 256 bfloat16
   (events and device time), each held against its plain version.
4. GAT kernels: on the self-looped arxiv graph's ``CsrGatLayout``, at
   H = 8, d = 32, at the odd shape H = 2, d = 20, at one wide head
   (H = 1, d = 256), at (H, d) = (4, 8), (8, 4), (4, 64), which give
   every other lane-group size (1, 2 and 16 lanes per head), and at an odd
   head width (H = 3, d = 5: one-element vectors), in float32 and
   bfloat16, with no dropout and with a 0.3 keep mask, hold the forward
   kernel and both backward kernels against their plain versions on the
   same inputs (float32: rtol = atol = 1e-4 for out and lse, 1e-3 for the
   gradients and D, whose sums chain through a recomputed softmax;
   bfloat16: 2e-2; the destination pass's per-edge weights w 1e-3 in both
   dtypes, as both sides compute them in float32), the plain source pass
   reading the kernel's w; the backward's dQ, D, w, dK and dV bit for bit
   against a second run, and the forward's out and lse too. The same on the
   transposed layout, whose source side holds the skewed destinations (518
   rows over 64 entries: the source pass's hub blocks). Time each kernel at H = 8, d = 32 with CUDA events
   and by device time beside its bound (the source pass's: its own gather,
   Q, dy and w read, dK and dV written), its plain version, its registers
   per thread and resident warps per SM, every gathered row read from
   device memory, the time of the w array's writes beside the destination
   pass (outside its bound) and, for the source pass, the library
   yardstick ``torch.bmm`` of the source
   side's per-head sparse COO weights with Q and dy (float32, built outside
   the timer; never called by the port); print the destination side's hub
   rows and longest row. Time the forward and the destination pass at
   H = 8, d = 32, bfloat16 with hub blocks for rows over 64, 128 and 256
   (``HUB_DEGREE``) edges and with none (the numbers behind the value).
5. SAGE kernels: on the Reddit-shaped graph's device sampler (232,965
   nodes, 11,606,919 edges), hold the draw kernel against its plain
   version at k = 25 on the same random integers, exactly (the main path's
   unweighted draw, and a draw with a weight table and self ids), and the
   fixed-k aggregation forward and backward against their plain versions
   at (k, F) in {(25, 128), (10, 128), (25, 602), (4, 41)}, float32
   (rtol = atol = 1e-4: order of summation) and bfloat16 (forward 2e-2;
   backward 1e-4, since both sides read the same ``dy`` and sum in
   float32), on draws made by the draw kernel, each against its own second
   run, bit for bit. Then the same at k = 25, F = 128 on two skewed draws
   over the arxiv-like graph (as built, and transposed, whose hub sources
   hold thousands of slots; the backward's sums within 1e-4 times their
   sum of magnitudes), and the forward and backward at three shapes
   off the main path (one source; three; 600,000 sources, two radix
   passes). Print the most slots one source holds beside
   the backward's longest serial walk, and each result's first SHA-256
   digits (to compare two trees of the code on one draw). Time each
   kernel (events; device time under the profiler, the draw's too, split
   into the backward's transpose and gather, by kernel) beside its plain version,
   its bound, every slot's row read from device memory, at F = 128 the
   forward gather over a table the L2 holds, and the library yardstick
   ``torch.sparse.mm`` (a CSR matrix of k entries per row built from the
   draw, and its transpose: prebuilt, and built from the draw inside the
   timer), in the case's dtype.
6. COO SpMM kernels (``csrc/spmm_heads.cu``, one head): on the arxiv
   graph's normalized COO, its edges shuffled by a seeded permutation, 1%
   sink edges (row = col = N) and a few in-range rows with out-of-range
   columns appended, at F in {4, 64, 128} with ``h`` float32 and bfloat16
   (values float32, so the result and ``dy`` are float32): the forward and
   ``dh`` SpMM and the ``dv`` SDDMM against their plain versions (float32
   1e-4, bfloat16 2e-2), ``dv`` in float32 also against
   ``torch.sparse.sampled_addmm`` (1e-4), all three against a second run of
   the same call, bit for bit, and the forward against itself with the
   weights gathered into view order first (the same bits), timed. Print each
   view's longest row beside the SpMM's and the SDDMM's longest serial walks
   (``row_split``; the SDDMM's 64-entry chunks). Time each kernel, its plain
   version and the library yardsticks the port never calls
   (``torch.sparse.mm`` on a prebuilt CSR, ``torch.sparse.sampled_addmm`` in
   float32; ``dv`` and its yardstick also by device time), and print the
   views' build (the stable sorts) beside the bounds.
7. Multi-head SpMM kernels: on the self-looped arxiv ``CsrGatLayout`` at
   (H, d_v) in {(8, 8), (8, 32), (4, 64)} (the first is workload 5's),
   float32 and bfloat16: the forward (SpMM, destination side), ``dV``
   (SpMM, source side) and ``d_att`` (SDDMM) against their plain versions,
   timed beside their bounds and, in float32, beside the library
   yardsticks the port never calls (``torch.bmm`` of the layout's
   [H, N, N] sparse COO with the values viewed [H, N, d] for the forward and
   ``dV``, a batched ``torch.sparse.sampled_addmm`` on its [H, N, N] CSR
   pattern for ``d_att``), whose results are held against the kernels'
   (1e-4); each kernel against a second run, bit for bit; ``d_att`` and its
   yardstick in float32 also by device time. PyTorch has no bfloat16 kernel
   for either call. The forward also runs with its weights gathered into
   view order (the same bits), timed.
8. GIN kernels: on the GIN batch's own padded edge list (values one, as
   ``gin`` makes them), the COO SpMM forward at widths 4 and 64 and its
   ``dh`` at 64 against their plain versions and ``torch.sparse.mm``
   (float32, 1e-4), timed by events and by device time (both calls are
   short enough for the host to set the events' pace).
9. Main path: zero the launch counters, build the bench problem and train
   ``bench`` workloads 1, 1b, 3 (the 8-head GAT), 5 (the GAT with
   d_q = 1, d_v = 8, the merged-head branch) and 10-12 (SGC, APPNP and SSGC
   at the widths of their early-stop benches) at full arxiv size, workload 4
   (the sampled GraphSAGE) at full Reddit size and workloads 6 and 7 (GIN
   with the sum-pool and the SortPool readout) and 14-16 (DiffPool,
   MinCutPool, hierarchical SAGPool at the pooling demos' widths) on the
   benchmark's batch of 128 graphs; check that the loss is finite and falls and that each
   kernel ran exactly as often as the layouts imply (GAT: one forward and
   two backward launches per step; SAGE: two draws, two aggregations
   forward and two backward calls per step, each backward call launching
   its sort's kernels and the gather; merged-head GAT: two SpMM and one
   SDDMM calls per step; GIN: five SpMM calls per step, three forward and
   two ``dh``, each SpMM call two launches (its chunks' and its rows',
   ``ops.spmm_heads.spmm_heads_launches``); SGC, APPNP and SSGC: Kernel A
   forward and ``dh`` per
   hop, 2, 10 and 10 hops, each launch merging its side's hubs: no Kernel B
   on any path; 14-16: per GCN a forward and a ``dh`` SpMM call, and the
   ``dv`` SDDMM for DiffPool's second-level GCNs, whose edge weights come
   from the first level's assignment, ``bench.pool_x6_calls``). Then train
   3 steps of each arxiv workload at a small size and of each GIN and pool
   workload on its batch through the kernels and through the plain versions on the
   card and compare the losses, the same for a TAGCN, a ChebyNet and an
   LEConv layer at 20,000 nodes, and run ``entry()`` on the card against its
   CPU run.

10. X2 kernels (``ell_spmm``): on the arxiv graph partitioned over 4 ranks
    (``bench.build_halo_problem``: ``partition_order``, whose host time is
    printed, then the packed halo plan), for every rank's local block
    (square, split diagonal) and remote block (rectangular, mostly empty
    rows), at F = 64 and 40, float32 and bfloat16: Kernel A and Kernel B
    forward and ``dh`` against their plain versions (float32 1e-4, bfloat16
    2e-2), Kernel A against a second run of the same call, bit for bit, and,
    in float32, the product against ``torch.sparse.mm`` on the same block;
    each block side's longest serial walks beside its longest row; Kernel A
    and ``torch.sparse.mm`` in float32 also by device time; the
    ``diff_values`` SDDMM (``ops.ell.side_value_grad``)
    against its plain version, a second run (bit for bit) and, in float32,
    ``torch.sparse.sampled_addmm`` on the block (1e-4); each block side's
    hub rows and rows without entries printed; timed beside the byte bound
    and ``torch.sparse.mm``; the ``dv`` call also by device time, on rank 0
    at F = 64 kernel by kernel.
11. X5 kernels (``gat_attention_ell``): on every rank's rectangular GAT
    layout (``npp`` rows reading ``npp + 4·cap``) at (H, d) = (8, 8),
    (1, 64), (8, 32), float32 and bfloat16, without dropout and with a 0.6
    dropout mask: the three attention kernels against their plain versions
    and the backward bit for bit, as in phase 4, and every row without
    entries exactly 0 (out, lse, dQ, D; dK, dV); hub and empty rows
    printed; the main path's float32 masked cases timed on rank 0, as in
    phase 4.
12. The graph-parallel main path, "4 ranks sharing one H100 over gloo":
    ``bench.run_halo_workload`` trains the halo GCN and the fused halo GAT
    (workloads 8 and 9) at full arxiv size on 4 spawned ranks with CUDA
    tensors, 3 warm-up and 20 timed steps each; the loss finite and falling
    on every rank and each kernel's launches per rank exactly as the plans
    imply (GCN per layer: Kernel A forward and ``dh`` on both blocks, no
    Kernel B; GAT per layer: one forward and two backward launches). The
    GCN's step-1 loss and gradients against the
    port's single-process GCN over the whole graph (1e-4); 3 steps of both
    at 20,000 nodes through the kernels and through the plain versions
    (losses within 1e-4); ``entry.dryrun_multichip(4)`` (GCN, GAT and the
    sampled SAGE).
14. The sampled SAGE on 4 ranks (``bench`` workload 13): the draw and S1 at
    rank 1's shapes (its CSR shard with global self ids, the gathered
    table of 169,472 rows, 64 wide) against their plain versions as in
    phase 5, timed; then workload 13 at full size, 3 warm-up, 20 timed and
    5 profiled steps (the card's busy time and idle share): the loss finite
    and falling on every rank, per rank and step exactly 2 draws, 2
    aggregations forward and 2 backward calls of 6 launches; 3 steps at
    20,000 nodes through the kernels and through the plain versions (rank
    0's losses within 1e-4).

15. Hierarchical pooling (``csrc/spmm_heads.cu``, X6, on the pooling path):
    before the main path, X6 on workload 14's second-level graph at its
    initial weights (level 0's DiffPool on the batch: 1,024 rows, 8,192
    pooled edges and 1,024 self-loops, normalized): the forward and ``dh``
    SpMM at the feature GCN's width 32 and ``dv`` at 32 and at the assign
    GCN's 4, float32, against their plain versions (1e-4), a second run (bit
    for bit) and the library calls (``torch.sparse.mm``,
    ``torch.sparse.sampled_addmm``; 1e-4), timed by events and device time
    beside the bound. After the main path: workloads 14-16 under the
    profiler (the card's busy time and idle share), then ASAP (the demo's
    16 graphs, k = 8, fixed mode) and Set2Set (128 graphs) 3 Adam steps
    through the kernels and through the plain versions (1e-4; the plain runs
    launch nothing), ASAP's pooling at k = 16 on the 16-graph batch (slots
    left invalid by graphs of fewer nodes: its reverse map's spare entry,
    cluster_pool's dropped assignment edges) kernel against plain, and a
    batch of graphs with SparseMatrix features (``BatchGraph.from_graphs``)
    through ``gcn``, whose sparse ``x @ W`` is X6 too (4 launches), against
    the plain versions and the dense features.

16. The edge-partitioned MinCut/DiffPool step (``bench`` workload 17,
    ``mincut_arxiv_p4_fwd_bwd``): Kernel A on rank 1's rectangular block
    ([42,336, 169,344], the normalized adjacency without self-loops, rows
    local, columns global) forward and ``dh`` at F = 96 (hidden + C) and
    F = 32 (C), float32, against its plain version and ``torch.sparse.mm``
    on the same CSR (1e-4) and a second run (bit for bit), timed by events
    and device time beside its byte bound; then workload 17 at full size,
    3 warm-up, 20 timed and 5 profiled steps (the card's busy time and idle
    share): the loss finite and falling on every rank, exactly 4 Kernel A
    launches per rank and step and no other kernel; 3 steps of both
    variants (``min_cut``, ``diff``) at 20,000 nodes and of the 2-D batch
    step (data 2 × graph 2, a 20,000-node batch) through the kernels and
    the plain versions (rank 0's losses within 1e-4); ``parallel.multihost``:
    4 processes through ``initialize``'s environment rendezvous on card 0
    over gloo, halo GCN on the packed plan at 20,000 nodes, two-level (data
    2 × graph 2) and flat (graph 4), each process's Kernel A launches as its
    plan implies and its losses those of ``run_ranks``; the dry run (its
    MinCut and 2-D parts too).

13. X7 (``tiled_spmm``, ``csrc/tiled_spmm.cu``), before the main path: the
    kernel against its plain version at the shapes and tiles of
    ``tests/test_tiled_spmm.py`` (t = 32, 64, 128) and at t = 16, 48, 192
    and 256, widths 1 to 300 (two F chunks of the bf16-tile kernel at
    t = 128 and 256), half the cases with row tiles that hold no tile; then
    on the A/B's community graph (t = 128, F = 128; tiles per row tile, the
    bf16-tile kernel's registers, shared memory, stages and resident blocks
    per SM printed); every pair of tile
    dtype (float32: SIMT, bf16: tensor cores) and ``h`` dtype, forward and
    ``dh``: float32 outputs within 1e-4 (both sides round ``h`` to the tiles'
    dtype and sum in float32), bf16 outputs 2e-2; a second run bit for bit;
    empty row tiles exactly 0; a tile that is not a multiple of 16 refused.
    Timed beside its byte bound, its plain version, ``torch.sparse.mm`` on
    the CSR of the same matrix (the library yardstick, never called by the
    port) and Kernel A on the same graph; bf16 tiles also by device time,
    and the wrapper's cast of the operand (inside the call) apart. After
    the main path, X7's one
    path: the A/B twin (``bench.tiled_ab``), its occupancy, timing and
    ``VERDICT`` lines, with exact launch counts (1 a forward step, 2 a
    forward-and-backward step); no training path launches X7.

17. Host-sampled SAGE (``bench`` workload 18, ``sage_reddit_dense_fwd_bwd``,
    S1 on draws made on the host by ``RandomNeighborSampler`` with the
    native draw), at Reddit size: the slots of two runs from the initial
    weights bit for bit equal, the host draw's and the copy's ms; 3 Adam
    steps through the kernels and through the plain versions on the same
    host draws (losses within 1e-4; the kernel run exactly 2 S1 forward and
    2 backward calls a step, no draw kernel); in the main path the
    workload's ms/step, sampled edges/s, host draw and copy ms, with exact
    launches. Then flat against dense on the arxiv-shaped graph (k = 25,
    F = 128): one draw state through ``sample(k, padding=True)`` and
    ``mean_graph_sage``, and through ``sample_dense(k)`` and
    ``mean_graph_sage_fixed_k`` (S1): outputs and gradients within float32
    1e-4 of each sum's magnitudes.
18. Graph auto-encoder link prediction (``demo/demo_gae.py``'s widths, X6):
    on the synthetic arxiv graph's train split (``edge_train_test_split``,
    15% held out, the test negatives drawn without replacement), X6 at the
    encoder's calls (forward and ``dh`` at F = 32 and 16, float32) against
    its plain version, ``torch.sparse.mm`` and a second run, timed by
    events and device time beside its bound; 3 Adam steps through the
    kernels and through the plain versions on the same negatives and keep
    masks (losses within 1e-4); 10 training steps drawing their negatives
    on the host each step (loss, step ms, negative sampling ms, exactly 4
    X6 calls a step), 3 profiled steps (the card's busy time), the test
    AUC (``binary_auc``, printed, not gated); ``gae:spmm_heads`` in the
    kernels line.
19. Planetoid-shaped node classification through the demo twins
    (``tf_geometric_tpu_torch/demos``: ``demo_gcn``, ``demo_gat``) on the
    hard-mode Pubmed set (``HardCitationDataset("pubmed", seed=0,
    model=...)``: 19,717 nodes, 500 features, 3 classes, built on the host,
    no file looked for): for each demo, 3 Adam steps through the kernels
    and through the plain versions from the same weights and keep masks
    (losses within 1e-4), exactly 4 Kernel A launches a GCN step and one
    forward, destination and source pass a GAT layer a step; Kernel A at
    F = 16 and F = 3, forward and ``dh``, and the attention kernels at
    (H, d) = (8, 8) with a 0.4 keep mask and (1, 3) without, against their
    plain versions (float32 1e-4, attention gradients 1e-3) and a second run
    (bit for bit), timed by events and device time beside the byte bound and
    ``torch.sparse.mm`` (the source pass: ``torch.bmm``); then
    ``train_node_classifier``'s 200 steps with the early stop (patience
    100): ms/step over the loop with its evaluations (events), edges/s, the
    stop step and test@best (printed, not gated) with exact launches; 10
    profiled training steps (the card's busy time and idle share);
    ``planetoid:<kernel>`` entries in the kernels line.
20. The accuracy head-to-head's models (``head_to_head_phase``): the five
    early-stop bench twins on hard Cora (and the GAT twin's pubmed
    architecture on hard Pubmed), 3 Adam steps through the kernels and
    through their plain versions from the same weights and draws (losses
    within 1e-4) with the launches a step and an evaluation counted on the
    CPU (``H2H_STEP_LAUNCHES``, ``H2H_EVAL_LAUNCHES``); each twin's full
    ``run(seed=0)`` (test@best beside JAX's committed mean, ms/step with
    its evaluations, exact launches); the hard arxiv cell, GCN (hidden 64)
    and SGC for seeds 0-4 under the 100-step protocol, each mean gated
    against ``results_{gcn,sgc}_arxiv_hard.txt`` by
    ``head_to_head_port.gate`` (a failure fails the run), the card's idle
    share over 5 profiled steps; Kernel A at the cell's F = 64 and 40
    (forward and ``dh``) and 128, and the multi-head SpMM and SDDMM at the
    GAT twin's shapes, against plain and the library; then each graph demo
    twin: kernel against plain on one batch (``H2H_GRAPH_STEP_LAUNCHES``)
    and one 300-step run. ``h2h:<kernel>`` entries in the kernels line.

Each phase prints its seconds. The second-to-last line of output is
``{"kernels": [...]}`` (X2 and X5 as ``ell_spmm:<kernel>`` and
``gat_attention_ell:<kernel>`` beside the single-process entries, the draw
and S1 on workload 13 as ``sampled_sage:<kernel>``, Kernel A on workload
17 as ``mincut:csr_spmm``, X6 on the GAE path as ``gae:spmm_heads``,
Kernel A and the attention kernels on the demo path as
``planetoid:<kernel>``, Kernel A and X3's kernels on the head-to-head path
as ``h2h:<kernel>``, X6
on the pooling path
(workload 14's pooled graph, launches over workloads 14-16) as
``pool:<kernel>``, X7 as ``tiled_spmm``
with the A/B's launches, Kernel B with 0 launches: every hub merge runs in
Kernel A's launch); the last is
``{"ok": true, "device": {...}}``.

With ``--against DIR`` (or ``--trial DIR``) the script instead times another
checkout's hub merge (P1) beside this one's, in turns on one card, through
each tree's own wrappers (``DIR/tf_geometric_tpu_torch``, built from its own
``csrc/``): ``side_matmul`` and Kernels A and B alone on the arxiv
adjacency and a halo block, the launch floor, and workloads 1, 1b and
10-12; ``--against`` also holds the two trees' products equal (float32 bit
for bit), ``--trial`` does not.
"""
import contextlib
import hashlib
import json
import math
import subprocess
import sys
import time

F32_TOL = dict(rtol=1e-4, atol=1e-4)
F32_GRAD_TOL = dict(rtol=1e-3, atol=1e-3)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# (heads, head width): the bench's, an odd width, one head over two slices,
# the lane groups the others miss (float32 / bfloat16 lanes per head:
# (4, 8) 2 / 1, (8, 4) 1 / 1, (4, 64) 16 / 8), and an odd head width, whose
# one-element vectors (4 / 2 bytes) take the destination pass's narrowest
# ring copies
GAT_SHAPES = ((8, 32), (2, 20), (1, 256), (4, 8), (8, 4), (4, 64), (3, 5))
GAT_KEEP_RATE = 0.3
WIDTHS = (40, 128, 256)
# SAGE aggregation cases (k, F): both layers of the bench (128-wide after the
# projection), the gather-first width of x, and a narrow odd width
SAGE_SHAPES = ((25, 128), (10, 128), (25, 602), (4, 41))
SAGE_DRAW_K = 25
X6_WIDTHS = (4, 64, 128)              # GIN's first layer, its hidden width, and wider
X6_SINK_SHARE, X6_BAD_COLS = 0.01, 8  # appended sink edges, in-range rows with bad cols
# (H, d_v): workload 5's (d_q = 1), the 8-head GAT's width, and wide heads
X3_SHAPES = ((8, 8), (8, 32), (4, 64))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
L2_TABLE_BYTES = 24 * 2 ** 20  # a gather table well inside the H100's 50 MB L2
TIMED_ITERS = 20


def _check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _cuda_ms(fn, iters=TIMED_ITERS, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_kernels(fn, iters=TIMED_ITERS, tries=3):
    """Device time of one call of ``fn`` by kernel, ``[(name, ms, launches)]``
    per call, under ``torch.profiler`` over ``iters`` calls. For calls so
    short that CUDA events around back-to-back calls time the host's
    launches instead, and to split a call's time between its kernels. A
    trace whose kernel count is not a whole number per call lost records
    and is taken again; None when no try gives a whole trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from tf_geometric_tpu_torch.utils.profiling import device_time_by_kernel
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        # a warm-up step while the tracer starts (it can miss the first
        # kernels), then the recorded step
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        kernels = device_time_by_kernel(prof, iters)
        per_call = sum(k[2] for k in kernels)
        if kernels and abs(per_call - round(per_call)) < 1e-6:
            return kernels
    return None


def _device_ms(fn, iters=TIMED_ITERS, tries=3):
    """Device time of one call of ``fn`` (``_device_kernels`` summed)."""
    kernels = _device_kernels(fn, iters, tries)
    return None if kernels is None else sum(k[1] for k in kernels)


def _max_err(got, want, tol, what):
    import torch
    got, want = got.float(), want.float()
    _check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    _check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    ok = torch.allclose(got, want, **tol)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    _check(ok, f"{what}: max abs err {err:.3e} outside rtol={tol['rtol']} atol={tol['atol']}")
    return err


def _library_csr(adj, index, value, side_name):
    """The full matrix of one product direction (diagonal included) as a
    torch CSR tensor, for the ``torch.sparse.mm`` yardstick."""
    import torch
    if side_name == "bwd":
        index = index.flip(0)
    n_rows = adj.shape[0] if side_name == "fwd" else adj.shape[1]
    n_cols = adj.shape[1] if side_name == "fwd" else adj.shape[0]
    coo = torch.sparse_coo_tensor(index, value, (n_rows, n_cols)).coalesce()
    return coo.to_sparse_csr()


def kernel_phase(problem, normed):
    import torch
    from tf_geometric_tpu_torch.ops.csr_spmm import (csr_spmm_plain, launch_csr_spmm,
                                                     side_matmul, side_matmul_plain)
    from tf_geometric_tpu_torch.ops.sorted_segment import (launch_sorted_segment_sum,
                                                           sorted_segment_sum_plain)
    adj = problem.adj
    diag = adj.diag_val
    gen = torch.Generator(device="cuda").manual_seed(0)
    library = {s: _library_csr(adj, normed.index, normed.value, s) for s in ("fwd", "bwd")}
    rows = []
    for side_name in ("fwd", "bwd"):
        side = getattr(adj, side_name)
        print(f"{side_name} side: rows={side.num_rows} hub_rows="
              f"{0 if side.owner_rows is None else int(side.owner_rows.shape[0])} "
              f"virtual_rows={side.num_virtual} nnz={int(side.col.shape[0])} "
              f"{_walk_line(side)}", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        elt = 4 if dtype == torch.float32 else 2
        for width in WIDTHS:
            for side_name in ("fwd", "bwd"):
                side = getattr(adj, side_name)
                n_src = adj.shape[1] if side_name == "fwd" else adj.shape[0]
                h = torch.randn(n_src, width, generator=gen, device="cuda").to(dtype)
                args = (side.row_ptr, side.col, side.val, h, diag, side.num_rows)
                out_k, part_k = launch_csr_spmm(*args)
                out_p, part_p = csr_spmm_plain(*args)
                torch.cuda.synchronize()
                tag = f"{side_name} F={width} {str(dtype)[6:]}"
                _check_same_bits(launch_csr_spmm, args, (out_k, part_k), f"csr_spmm {tag}")
                err_a = max(_max_err(out_k, out_p, tol, f"csr_spmm out {tag}"),
                            _max_err(part_k, part_p, F32_TOL, f"csr_spmm partial {tag}"))
                nnz = int(side.col.shape[0])
                # h read, out written, row pointers, columns, values and the
                # diagonal: the product's own traffic (the hub partials are
                # the launch's scratch)
                a_bytes = (n_src * width * elt + side.num_rows * width * elt
                           + 4 * side.row_ptr.shape[0] + 8 * nnz + 4 * side.num_rows)
                a_flops = 2 * (nnz + side.num_rows) * width
                lib = library[side_name].to(dtype)
                if dtype == torch.float32:
                    want = torch.sparse.mm(lib, h)
                    err_a = max(err_a, _max_err(side_matmul(side, h, diag), want, F32_TOL,
                                                f"A+B vs torch.sparse.mm {tag}"))
                else:
                    err_a = max(err_a, _max_err(side_matmul(side, h, diag),
                                                side_matmul_plain(side, h, diag), tol,
                                                f"A+B vs plain {tag}"))
                # the main path's call: one launch, the hub merge included
                rows.append(dict(
                    name="csr_spmm", side=side_name, width=width, dtype=str(dtype)[6:],
                    max_abs_err=err_a, ms=_cuda_ms(lambda: side_matmul(side, h, diag)),
                    plain_ms=_cuda_ms(lambda: side_matmul_plain(side, h, diag)),
                    library_ms=_cuda_ms(lambda: torch.sparse.mm(lib, h)),
                    bound_ms=1e3 * max(a_bytes / HBM_BYTES_PER_S, a_flops / F32_FLOPS_PER_S),
                    bound_by="bytes" if a_bytes / HBM_BYTES_PER_S >= a_flops / F32_FLOPS_PER_S
                    else "operations", gather_ms=_gather_ms(nnz, width, elt),
                    device_ms=_device_ms(lambda: side_matmul(side, h, diag)),
                    library_device_ms=_device_ms(lambda: torch.sparse.mm(lib, h))))
                if not side.num_virtual:
                    continue
                # Kernel B on the hubs' partials of Kernel A without the
                # merge, added into their owner rows of its output
                owner_ptr, owner_rows = side.owner_ptr, side.owner_rows
                base = out_k.clone()
                got = launch_sorted_segment_sum(part_k, owner_ptr, base.clone(), True,
                                                owner_rows)
                want = sorted_segment_sum_plain(part_k, owner_ptr, base.clone(), owner_rows)
                # and its dense form (one segment per output row, written fresh)
                fresh = torch.empty((owner_rows.shape[0], width), dtype=dtype, device="cuda")
                got_fresh = launch_sorted_segment_sum(part_k.to(dtype), owner_ptr, fresh, False)
                torch.cuda.synchronize()
                err_b = max(_max_err(got, want, tol, f"sorted_segment_sum accumulate {tag}"),
                            _max_err(got_fresh,
                                     sorted_segment_sum_plain(part_k.to(dtype), owner_ptr),
                                     tol, f"sorted_segment_sum fresh {tag}"))
                owners = int(owner_rows.shape[0])
                # partials read, owners' rows read and written, 2H + 1 indices
                b_bytes = (side.num_virtual * width * 4 + 2 * owners * width * elt
                           + 4 * (2 * owners + 1))
                b_flops = (side.num_virtual + owners) * width
                scratch = base.clone()
                lengths = owner_ptr.diff().long()
                rows.append(dict(
                    name="sorted_segment_sum", side=side_name, width=width,
                    dtype=str(dtype)[6:], max_abs_err=err_b,
                    ms=_cuda_ms(lambda: launch_sorted_segment_sum(part_k, owner_ptr, scratch,
                                                                  True, owner_rows)),
                    plain_ms=_cuda_ms(lambda: sorted_segment_sum_plain(part_k, owner_ptr,
                                                                       scratch, owner_rows)),
                    library_ms=_cuda_ms(lambda: torch.segment_reduce(part_k, "sum",
                                                                     lengths=lengths)),
                    bound_ms=1e3 * max(b_bytes / HBM_BYTES_PER_S, b_flops / F32_FLOPS_PER_S),
                    bound_by="bytes" if b_bytes / HBM_BYTES_PER_S >= b_flops / F32_FLOPS_PER_S
                    else "operations",
                    device_ms=_device_ms(lambda: launch_sorted_segment_sum(
                        part_k, owner_ptr, scratch, True, owner_rows)),
                    library_device_ms=_device_ms(lambda: torch.segment_reduce(
                        part_k, "sum", lengths=lengths))))
    print("kernel check (name side F dtype: max_abs_err, ms, plain_ms, library_ms, bound_ms; "
          "Kernel A: every row's gather from device memory; device ms of the kernel and the "
          "library call under the profiler)")
    for r in rows:
        gather = f", gather {r['gather_ms']:.4f}" if "gather_ms" in r else ""
        print(f"  {r['name']} {r['side']} F={r['width']} {r['dtype']}: "
              f"{r['max_abs_err']:.3e}, {r['ms']:.4f}, {r['plain_ms']:.4f}, "
              f"{r['library_ms']:.4f}, "
              f"{r['bound_ms']:.4f} ({r['bound_by']}){gather}{_device_note(r)}", flush=True)
    return rows


MERGE_WIDTHS = (40, 256)  # workloads 10-12's width and the canonical step's first layer


def _merge_case(side, h, diag, tag):
    """One side's hub merge in Kernel A's launch against Kernel A without
    it followed by Kernel B on its partials: float32 bit for bit, bfloat16
    within 2e-2 (one rounding where two launches round twice); both dtypes
    against ``side_matmul_plain`` (float32 1e-4, bfloat16 2e-2) and the
    merged launch bit for bit against a second run; the tickets all 0
    after the launches. Returns the largest error against the plain
    version."""
    import torch
    from tf_geometric_tpu_torch.ops.csr_spmm import launch_csr_spmm, side_matmul_plain
    from tf_geometric_tpu_torch.ops.sorted_segment import launch_sorted_segment_sum
    args = (side.row_ptr, side.col, side.val, h, diag, side.num_rows)
    hubs = (side.owner_rows, side.owner_ptr, side.tickets)
    merged = launch_csr_spmm(*args, hubs=hubs)[0]
    out, part = launch_csr_spmm(*args)
    two = launch_sorted_segment_sum(part, side.owner_ptr, out, True, side.owner_rows)
    again = launch_csr_spmm(*args, hubs=hubs)[0]
    torch.cuda.synchronize()
    _check(not bool(side.tickets.any()), f"{tag}: tickets left non-zero after the launch")
    _check(torch.equal(merged, again), f"{tag}: two runs of the merged launch differ")
    if h.dtype == torch.float32:
        _check(torch.equal(merged, two),
               f"{tag}: the merged launch differs from Kernel A + Kernel B")
        return _max_err(merged, side_matmul_plain(side, h, diag), F32_TOL, f"{tag} vs plain")
    _max_err(merged, two, BF16_TOL, f"{tag} vs Kernel A + Kernel B")
    return _max_err(merged, side_matmul_plain(side, h, diag), BF16_TOL, f"{tag} vs plain")


def merge_phase(adjs, widths):
    """Kernel A's hub merge (``_merge_case``) on every side with hub rows of
    ``adjs`` (``[(label, CsrAdj)]``) at ``widths``, float32 and bfloat16."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(11)
    checked, err = 0, 0.0
    for label, adj in adjs:
        for side_name, n_src in (("fwd", adj.shape[1]), ("bwd", adj.shape[0])):
            side = getattr(adj, side_name)
            if not side.num_virtual:
                continue
            for dtype in (torch.float32, torch.bfloat16):
                for width in widths:
                    h = torch.randn(n_src, width, generator=gen, device="cuda").to(dtype)
                    err = max(err, _merge_case(side, h, adj.diag_val,
                                               f"hub merge {label} {side_name} F={width} "
                                               f"{str(dtype)[6:]}"))
            checked += 1
    _check(checked > 0, "no side with hub rows to check the merge on")
    print(f"hub merge in Kernel A's launch: {checked} sides with hub rows at F in {widths}, "
          f"float32 bit for bit against Kernel A + Kernel B, bfloat16 within 2e-2; max abs err "
          f"against the plain version {err:.3e}", flush=True)


def _device_note(r):
    if "device_ms" not in r:
        return ""
    return (f"; device {_ms_text(r['device_ms'])}, "
            f"library device {_ms_text(r['library_device_ms'])}")


def _ms_text(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def _check_same_bits(launch, args, first, what):
    """A second run of the same call gives the same bits (a fixed summation
    order, no float atomics)."""
    import torch
    again = launch(*args)
    torch.cuda.synchronize()
    _check(all(torch.equal(a, b) for a, b in zip(first, again)),
           f"{what}: two runs on the same inputs differ")


def _gather_ms(nnz, width, elt):
    """Every entry's row of h read from device memory, the traffic of a
    gather the 50 MB L2 does not absorb (the byte bound reads each row once)."""
    return 1e3 * nnz * width * elt / HBM_BYTES_PER_S


def _gat_case(layout, Q, K, V, dy, heads, keep, tag):
    """The three attention kernels against their plain versions on one case
    (float32: 1e-4 for out and lse, 1e-3 for the gradients and D; bfloat16
    2e-2; w 1e-3 in both, as both sides compute it in float32): out and
    lse; dQ, D and w on the side's edges; dK and dV, the plain source pass
    reading the kernel's w as the kernel does. out, lse, dQ, D, w, dK and dV
    must give the same bits in a second run. Returns the
    largest error of each kernel, each kernel's (kernel, plain, args) and the
    outputs."""
    import torch
    from tf_geometric_tpu_torch.ops import gat_attention as ga
    f32 = Q.dtype == torch.float32
    fwd_tol, grad_tol = (F32_TOL, F32_GRAD_TOL) if f32 else (BF16_TOL, BF16_TOL)
    eids = layout.dst.eid.long()
    fwd_args = (layout.dst, Q, K, V, heads, keep)
    out, lse = ga.launch_gat_forward(*fwd_args)
    out_p, lse_p = ga.gat_forward_plain(*fwd_args)
    dst_args = (layout.dst, Q, K, V, out, lse, dy, heads, keep)
    dQ, D, w = ga.launch_gat_backward_dst(*dst_args)
    dQ_p, D_p, w_p = ga.gat_backward_dst_plain(*dst_args)
    src_args = (layout.src, Q, dy, w, heads)
    dK, dV = ga.launch_gat_backward_src(*src_args)
    dK_p, dV_p = ga.gat_backward_src_plain(*src_args)
    torch.cuda.synchronize()
    errs = (
        max(_max_err(out, out_p, fwd_tol, f"gat forward out {tag}"),
            _max_err(lse, lse_p, fwd_tol, f"gat forward lse {tag}")),
        max(_max_err(dQ, dQ_p, grad_tol, f"gat backward dQ {tag}"),
            _max_err(D, D_p, grad_tol, f"gat backward D {tag}"),
            _max_err(w[eids], w_p[eids], F32_GRAD_TOL, f"gat backward w {tag}")),
        max(_max_err(dK, dK_p, grad_tol, f"gat backward dK {tag}"),
            _max_err(dV, dV_p, grad_tol, f"gat backward dV {tag}")))
    del out_p, lse_p, dQ_p, D_p, w_p, dK_p, dV_p
    out2, lse2 = ga.launch_gat_forward(*fwd_args)
    dQ2, D2, w2 = ga.launch_gat_backward_dst(*dst_args)
    dK2, dV2 = ga.launch_gat_backward_src(*src_args)
    torch.cuda.synchronize()
    _check(torch.equal(out, out2) and torch.equal(lse, lse2),
           f"gat forward {tag}: two runs on the same inputs differ")
    _check(torch.equal(dQ, dQ2) and torch.equal(D, D2) and torch.equal(w[eids], w2[eids])
           and torch.equal(dK, dK2) and torch.equal(dV, dV2),
           f"gat backward {tag}: two runs on the same inputs differ")
    del out2, lse2, dQ2, D2, w2, dK2, dV2
    calls = ((ga.launch_gat_forward, ga.gat_forward_plain, fwd_args),
             (ga.launch_gat_backward_dst, ga.gat_backward_dst_plain, dst_args),
             (ga.launch_gat_backward_src, ga.gat_backward_src_plain, src_args))
    return errs, calls, dict(out=out, lse=lse, dQ=dQ, D=D, w=w, dK=dK, dV=dV)


def _src_library(layout, Q, dy, w, heads):
    """The library yardstick of the source pass (never called by the port):
    given w, dK and dV are per-head weighted SpMMs, ``torch.bmm`` of the
    source side's [H, S, N] sparse COO weights (built here, outside the
    timer) with Q and dy viewed [H, N, d], in float32 (PyTorch has no
    bfloat16 kernel for it). Returns the call and a function that lays its
    results out as the kernel's [S, H·d]."""
    import torch
    from tf_geometric_tpu_torch.ops.spmm_heads import view_entries
    cols, rows, eids = view_entries(layout.src)
    n, S, width = Q.shape[0], layout.num_src, Q.shape[1]
    d = width // heads
    hh = torch.arange(heads, device=Q.device).repeat_interleave(cols.shape[0])
    index = torch.stack([hh, cols.repeat(heads), rows.repeat(heads)])
    we = w[eids]
    ak, av = (torch.sparse_coo_tensor(index, we[:, part].t().reshape(-1), (heads, S, n)).coalesce()
              for part in (slice(heads, None), slice(None, heads)))
    q3, dy3 = (t.float().view(n, heads, d).transpose(0, 1).contiguous() for t in (Q, dy))

    def call():
        return torch.bmm(ak, q3), torch.bmm(av, dy3)

    def layout_of(res):
        return [r.transpose(0, 1).reshape(S, width) for r in res]
    return call, layout_of


def _gat_rows(layout, heads, width, dtype, keep, errs, calls, outs, timed, **key):
    """One row per attention kernel of a checked case; a timed case adds its
    times (``_gat_timing``) and, for the source pass, its library yardstick
    (checked against the kernel's dK and dV, 1e-3)."""
    import torch
    from tf_geometric_tpu_torch import bench
    f32 = dtype == torch.float32
    rows = []
    for kind, ((kernel, plain, args), err) in enumerate(zip(calls, errs)):
        # the source pass's own function reads w in place of K, V, lse, D
        bound_ms, bound_by = _bound(*(
            bench.gat_src_gather_work(layout, heads, width, 4 if f32 else 2) if kind == 2 else
            (bench.gat_pass_bytes(layout, kind, heads, width, 4 if f32 else 2, keep is not None),
             bench.gat_pass_flops(layout, kind, heads, width))))
        row = dict(name=("gat_forward", "gat_backward_dst", "gat_backward_src")[kind],
                   heads=heads, width=width, dtype=str(dtype)[6:], keep=keep is not None,
                   max_abs_err=err, ms=None, plain_ms=None, library_ms=None, bound_ms=bound_ms,
                   bound_by=bound_by, **key)
        if timed:
            row.update(_gat_timing(kernel, plain, args, kind, layout, heads, width, dtype))
            if kind == 2:
                call, layout_of = _src_library(layout, args[1], args[2], args[3], heads)
                for got, want, what in zip((outs["dK"], outs["dV"]), layout_of(call()),
                                           ("dK", "dV")):
                    row["max_abs_err"] = max(row["max_abs_err"], _max_err(
                        got, want, F32_GRAD_TOL if f32 else BF16_TOL,
                        f"gat backward {what} vs the library call"))
                row["library_ms"] = _cuda_ms(call)
        rows.append(row)
    return rows


def _gat_timing(kernel, plain, args, kind, layout, heads, width, dtype):
    """A timed attention pass: its events and device time, its plain
    version's time, its instance's registers per thread and resident warps
    per SM, every gathered row (two per entry) read from device memory, and
    for the destination pass the time of writing the [E, 2H] float32 weight
    array (the design's bytes, outside its bound; the source pass's bound
    holds its read)."""
    import torch
    from tf_geometric_tpu_torch.ops import gat_attention as ga
    regs, warps = ga.kernel_info(kind, heads, width, dtype)
    elt = 2 if dtype == torch.bfloat16 else 4
    nnz = int(layout.dst.nbr.shape[0])
    return dict(ms=_cuda_ms(lambda: kernel(*args)), device_ms=_device_ms(lambda: kernel(*args)),
                plain_ms=_cuda_ms(lambda: plain(*args), iters=3, warmup=1), regs=regs,
                warps_per_sm=warps, hbm_gather_ms=_gather_ms(nnz, 2 * heads * width, elt),
                w_ms=_gather_ms(nnz, 2 * heads, 4) if kind == 1 else 0.0)


def _gat_row_text(r):
    """The timing part of a GAT check line (``_gat_timing``'s fields)."""
    if r["ms"] is None:
        return "not timed, not timed"
    lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.4f} (float32)"
    w = f", w written {r['w_ms']:.4f}" if r["w_ms"] else ""
    return (f"{r['ms']:.4f} (device {_ms_text(r['device_ms'])}), {r['plain_ms']:.4f}{lib}, "
            f"{r['regs']} regs, {r['warps_per_sm']} warps/SM, every gathered row from HBM "
            f"{r['hbm_gather_ms']:.4f}{w}")


def _walk_line(side):
    """A CSR side's longest row beside the longest serial walks of Kernel A
    (edges one lane group reads, partials its hub merge adds into one row)."""
    import torch
    from tf_geometric_tpu_torch.ops.csr_spmm import serial_walks
    rows = _side_rows(side)
    longest = int(torch.bincount(rows).max()) if rows.numel() else 0
    edges, partials = serial_walks(side)
    return (f"max_row_len={longest} longest serial walk: Kernel A {edges} edges, "
            f"hub merge {partials} partials")


def split_sweep(normed):
    """``side_matmul`` (Kernel A, hub merge included) on the forward side at
    hub split widths around ``SPLIT_WIDTH``, at the propagation family's
    F = 40 float32 and the canonical step's F = 256 bf16, each against its
    plain version: the card's numbers behind the split width."""
    import torch
    from tf_geometric_tpu_torch.ops.csr_spmm import (SPLIT_WIDTH, CsrAdj, side_matmul,
                                                     side_matmul_plain)
    gen = torch.Generator(device="cuda").manual_seed(8)
    n = normed.shape[0]
    cases = [(40, torch.float32, F32_TOL), (256, torch.bfloat16, BF16_TOL)]
    hs = {w: torch.randn(n, w, generator=gen, device="cuda").to(dt) for w, dt, _ in cases}
    for split in (32, SPLIT_WIDTH, 128, 256):
        adj = CsrAdj.from_coo(normed.index, normed.value, normed.shape, split_diag=True,
                              split_width=split, device="cuda")
        times = []
        for width, dtype, tol in cases:
            h = hs[width]
            _max_err(side_matmul(adj.fwd, h, adj.diag_val),
                     side_matmul_plain(adj.fwd, h, adj.diag_val), tol,
                     f"split {split} side_matmul F={width}")
            def call():
                return side_matmul(adj.fwd, h, adj.diag_val)
            times.append(f"F={width} {str(dtype)[6:]} {_cuda_ms(call):.4f} ms "
                         f"(device {_ms_text(_device_ms(call))})")
        print(f"split width {split}: {adj.fwd.num_virtual} virtual rows, {_walk_line(adj.fwd)};"
              f" side_matmul {', '.join(times)}", flush=True)


def gat_kernel_phase(layout, edges):
    """The three attention kernels against their plain versions at each GAT
    shape, dtype and dropout setting (``_gat_case``), on the self-looped
    arxiv layout and on its transpose, whose source side holds the skewed
    destinations (rows over ``CHUNK`` (64) entries: the source pass's hub
    blocks); returns one row per kernel and case of the first. Also times
    the bench-shape forward and destination-side backward at other hub
    degrees (``_hub_degree_sweep``)."""
    import torch
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch.ops import gat_attention as ga
    n = layout.num_nodes
    flipped = ga.CsrGatLayout.build(edges.flip(0), n, device="cuda")
    hub_sweep = None
    for what, lay in (("gat layout", layout), ("transposed gat layout", flipped)):
        print(f"{what}: {lay}; destination side: {int(lay.dst.hubs.shape[0])} hub rows "
              f"(> {lay.dst.hub_degree} edges), longest row {int(lay.dst.row_ptr.diff().max())}; "
              f"source side: {int(lay.src.hubs.shape[0])} hub rows (> {lay.src.hub_degree} "
              f"entries), longest row {int(lay.src.row_ptr.diff().max())}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, flipped_errs = [], []
    for heads, width in GAT_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            Q, K, V, dy = (torch.randn(n, heads * width, generator=gen, device="cuda").to(dtype)
                           for _ in range(4))
            for with_keep in (False, True):
                keep = None
                if with_keep:
                    keep = ((torch.rand(layout.num_edges, heads, generator=gen, device="cuda")
                             >= GAT_KEEP_RATE).float() / (1.0 - GAT_KEEP_RATE))
                tag = (f"H={heads} d={width} {str(dtype)[6:]} "
                       f"{'keep 0.7' if with_keep else 'no dropout'}")
                errs, calls, outs = _gat_case(layout, Q, K, V, dy, heads, keep, tag)
                timed = heads == bench.GAT_HEADS and width == bench.GAT_UNITS // bench.GAT_HEADS
                rows += _gat_rows(layout, heads, width, dtype, keep, errs, calls, outs, timed)
                if timed and not f32 and not with_keep:
                    hub_sweep = _hub_degree_sweep(layout, edges, Q, K, V, dy, outs, heads)
                del outs
                flipped_errs.append(max(_gat_case(flipped, Q, K, V, dy, heads, keep,
                                                  f"transposed {tag}")[0]))
                torch.cuda.empty_cache()
    print(f"gat hub degree sweep (H=8, d=32, bfloat16, no dropout; forward, backward dst: ms "
          f"(device)): {'; '.join(hub_sweep)}", flush=True)
    print(f"gat kernels on the transposed layout, every shape, dtype and dropout setting: "
          f"max abs err {max(flipped_errs):.3e}", flush=True)
    print("gat kernel check (name H d dtype dropout: max_abs_err, ms, plain_ms, bound_ms)")
    for r in rows:
        print(f"  {r['name']} H={r['heads']} d={r['width']} {r['dtype']} "
              f"{'keep' if r['keep'] else 'none'}: {r['max_abs_err']:.3e}, {_gat_row_text(r)}, "
              f"{r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    return rows


def _hub_degree_sweep(layout, edges, Q, K, V, dy, outs, heads):
    """The forward and the destination pass at the bench's shape (bf16, no
    dropout) with hub blocks for the destination rows of more than 64, 128
    and 256 (``HUB_DEGREE``) edges, and with none (every row one warp): the
    card's numbers behind ``HUB_DEGREE``, events and device time. Each
    layout's out and dQ are held against the default layout's (hub blocks
    change the order of the sums only: 2e-2)."""
    import torch
    from tf_geometric_tpu_torch.ops import gat_attention as ga
    n = layout.num_nodes
    lines = []
    for hub_degree in (64, 128, ga.HUB_DEGREE, None):
        lay = layout if hub_degree == ga.HUB_DEGREE else ga.CsrGatLayout.build(
            edges, n, hub_degree=n + 1 if hub_degree is None else hub_degree, device="cuda")
        calls = (lambda: ga.launch_gat_forward(lay.dst, Q, K, V, heads),
                 lambda: ga.launch_gat_backward_dst(lay.dst, Q, K, V, outs["out"], outs["lse"],
                                                    dy, heads))
        tag = f"hub degree {hub_degree}"
        _max_err(calls[0]()[0], outs["out"], BF16_TOL, f"gat forward out, {tag}")
        _max_err(calls[1]()[0], outs["dQ"], BF16_TOL, f"gat backward dQ, {tag}")
        times = ", ".join(f"{_cuda_ms(c):.4f} ({_ms_text(_device_ms(c))})" for c in calls)
        lines.append(f"{hub_degree or 'none'} ({int(lay.dst.hubs.shape[0])} hub rows): {times}")
        del lay
    return lines


def _draw_csr(idx, w, num_src):
    """The draw as a torch CSR matrix ``[S, n]``, k entries per row (ids
    clipped): the forward's ``torch.sparse.mm`` yardstick. Its rows are the
    draw's, so it needs no sort."""
    import torch
    k, S = idx.shape
    cols = idx.t().reshape(-1).long().clamp(0, num_src - 1)
    crow = torch.arange(0, k * S + 1, k, device=idx.device)
    return torch.sparse_csr_tensor(crow, cols, w.t().reshape(-1), (S, num_src))


def _draw_csr_t(idx, w, num_src):
    """The transposed draw as a torch CSR matrix ``[n, S]`` built from the
    draw (``to_sparse_csr`` of its COO, which sorts by source): the
    backward's yardstick, timed with its build or prebuilt."""
    import torch
    k, S = idx.shape
    cols = idx.reshape(-1).long().clamp(0, num_src - 1)
    rows = torch.arange(S, device=idx.device).repeat(k)
    return torch.sparse_coo_tensor(torch.stack([cols, rows]), w.reshape(-1),
                                   (num_src, S)).to_sparse_csr()


def _s1_device_split(fn):
    """Device ms of one S1 call, of its transpose (every kernel but the
    gather) and of its gather, by kernel name, and the per-kernel text
    (``name ms``); None and "" where not measured."""
    kernels = _device_kernels(fn)
    if kernels is None:
        return None, None, None, ""
    gather = sum(ms for name, ms, _ in kernels if _is_s1_gather(name))
    total = sum(ms for _, ms, _ in kernels)
    text = ", ".join(f"{_short_name(name)} {ms:.4f}" for name, ms, _ in kernels)
    return total, total - gather, gather, text


def _is_s1_gather(name):
    return any(part in name for part in ("gather_kernel", "tile_kernel"))


def _short_name(name):
    """A kernel's function name out of the profiler's signature."""
    import re
    found = re.search(r"(\w+_kernel)", name)
    return found.group(1) if found else name[:40]


def _sum_err(got, want, scale, tol, what):
    """``_max_err`` for sums of many terms: |got - want| <= atol + rtol *
    scale, where ``scale`` is the same sum over the terms' magnitudes (a
    float32 sum's rounding grows with it, not with the result, which can
    cancel to near 0)."""
    import torch
    got, want = got.float(), want.float()
    _check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    _check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    diff = (got - want).abs()
    ok = bool((diff <= tol["atol"] + tol["rtol"] * scale).all())
    err = float(diff.max()) if got.numel() else 0.0
    _check(ok, f"{what}: max abs err {err:.3e} outside atol={tol['atol']} + "
               f"rtol={tol['rtol']} x the sum of magnitudes")
    return err


def _digest(t):
    """The first hex digits of a tensor's bytes' SHA-256: bits to compare
    across trees of the code on the same draw."""
    import torch
    return hashlib.sha256(t.cpu().view(torch.uint8).numpy().tobytes()).hexdigest()[:12]


def _s1_rows(fk, n, k, width, dtype, idx, w, gen, tag, graph, timed=True, long_sums=False):
    """The S1 forward and backward at one case (``n`` sources; the draw
    ``idx`` [k, S] may have fewer rows), each against its plain
    version (forward: float32 1e-4, bfloat16 2e-2; backward: 1e-4 in both
    dtypes, since both sides read the same ``dy`` and sum in float32; with
    ``long_sums``, where a source sums thousands of slots, the backward
    within 1e-4 times its sum of magnitudes, ``_sum_err``) and a second run
    of the same call (bit for bit); in float32 also against
    ``torch.sparse.mm``. Timed (CUDA events, and device time split into
    transpose and gather) beside the plain version, the library calls
    (prebuilt CSR, and the CSR built from the draw inside the timer), the
    bound, every slot's row gathered from device memory and, at F = 128,
    the same gather over a table the L2 holds (the floor of any scheme
    that keeps the table in the L2)."""
    import torch
    f32 = dtype == torch.float32
    tol, elt = (F32_TOL, 4) if f32 else (BF16_TOL, 2)
    rows_out = idx.shape[1]   # the draw's rows (n where every source draws)
    src = torch.randn(n, width, generator=gen, device="cuda").to(dtype)
    dy = torch.randn(rows_out, width, generator=gen, device="cuda").to(dtype)
    wd = w.to(dtype)
    fwd_lib, bwd_lib = _draw_csr(idx, wd, n), _draw_csr_t(idx, wd, n)
    scale = fk.fixed_k_backward_plain(dy.abs(), idx, w.abs(), n) if long_sums else None

    def err_of(backward, got, want, what):
        if not backward:
            return _max_err(got, want, tol, what)
        if long_sums:
            return _sum_err(got, want, scale, F32_TOL, what)
        return _max_err(got, want, F32_TOL, what)
    calls = ((fk.launch_fixed_k_forward, fk.fixed_k_forward_plain, (src, idx, w), fwd_lib, src,
              lambda: torch.sparse.mm(_draw_csr(idx, wd, n), src)),
             (fk.launch_fixed_k_backward, fk.fixed_k_backward_plain, (dy, idx, w, n), bwd_lib,
              dy, lambda: torch.sparse.mm(_draw_csr_t(idx, wd, n), dy)))
    flops = fk.aggregate_pass_flops(k, rows_out, width)
    rows = []
    for backward, (kernel, plain, args, lib, dense, from_draw) in enumerate(calls):
        name = "fixed_k_backward" if backward else "fixed_k_forward"
        what = f"{name} {tag}"
        want = plain(*args)

        def call():
            return kernel(*args)
        got = call()
        torch.cuda.synchronize()
        _check_same_bits(lambda: (call(),), (), (got,), what)
        err = err_of(backward, got, want, what)
        if f32:
            err = max(err, err_of(backward, got, torch.sparse.mm(lib, dense),
                                  f"{what} vs torch.sparse.mm"))
        nbytes = fk.aggregate_pass_bytes(n, k, rows_out, width, elt, backward=bool(backward))
        bound_ms, bound_by = _bound(nbytes, flops)
        row = dict(name=name, graph=graph, k=k, width=width, dtype=str(dtype)[6:],
                   max_abs_err=err, sha256=_digest(got), bound_ms=bound_ms, bound_by=bound_by,
                   hbm_gather_ms=_gather_ms(k * rows_out, width, elt))
        del got
        if timed:
            device, transpose, gathered, by_kernel = _s1_device_split(call)
            row.update(ms=_cuda_ms(call), device_ms=device, device_transpose_ms=transpose,
                       device_gather_ms=gathered, device_kernels=by_kernel,
                       plain_ms=_cuda_ms(lambda: plain(*args), iters=3, warmup=1),
                       library_ms=_cuda_ms(lambda: torch.sparse.mm(lib, dense)),
                       library_from_draw_ms=_cuda_ms(from_draw))
            if not backward and width == 128:
                rows_l2 = L2_TABLE_BYTES // (width * elt)
                idx_l2, src_l2 = idx % rows_l2, src[:rows_l2]
                row.update(l2_table_ms=_cuda_ms(lambda: kernel(src_l2, idx_l2, w)))
        rows.append(row)
    return rows


def _skew_graphs(graph):
    """The arxiv-like graph's edges for the skewed draws: as built (rows are
    the skewed destinations, the drawn columns uniform: the most slots one
    source holds stays near a hundred) and transposed (the drawn columns are
    the skewed ones: hub sources hold thousands of slots)."""
    import numpy as np
    edge_index = np.asarray(graph.edge_index)
    return [("arxiv", edge_index, graph.num_nodes),
            ("arxiv transposed", edge_index[::-1].copy(), graph.num_nodes)]


# S1 backward shapes off the main path: (sources, rows, k, F): every slot
# on one source (hub segments over several chunks), three sources, and more
# tiles than one radix digit holds (two passes and the tiles' run starts)
S1_EDGE_CASES = ((1, 4096, 3, 8), (3, 1000, 5, 128), (600_000, 600_000, 4, 16))


def s1_edge_cases(fk, gen):
    """The S1 forward and backward on uniform draws at S1_EDGE_CASES,
    float32, against their plain versions (the backward within 1e-4 times
    its sum of magnitudes) and their own second runs, bit for bit."""
    import torch
    for n, S, k, width in S1_EDGE_CASES:
        idx = torch.randint(0, n, (k, S), generator=gen, device="cuda", dtype=torch.int32)
        w = torch.rand((k, S), generator=gen, device="cuda")
        src = torch.randn(n, width, generator=gen, device="cuda")
        dy = torch.randn(S, width, generator=gen, device="cuda")
        tag = f"n={n} S={S} k={k} F={width}"
        out = fk.launch_fixed_k_forward(src, idx, w)
        d_src = fk.launch_fixed_k_backward(dy, idx, w, n)
        torch.cuda.synchronize()
        _check_same_bits(lambda: (fk.launch_fixed_k_forward(src, idx, w),
                                  fk.launch_fixed_k_backward(dy, idx, w, n)), (), (out, d_src),
                         f"fixed_k {tag}")
        err = _max_err(out, fk.fixed_k_forward_plain(src, idx, w), F32_TOL, f"forward {tag}")
        scale = fk.fixed_k_backward_plain(dy.abs(), idx, w, n)
        err = max(err, _sum_err(d_src, fk.fixed_k_backward_plain(dy, idx, w, n), scale,
                                F32_TOL, f"backward {tag}"))
        print(f"fixed_k {tag} (passes {fk.backward_plan(n, width, 4, 4).passes}): "
              f"max_abs_err {err:.3e}, {_walk_text(fk, idx, n)}", flush=True)


def sage_skew_rows(fk, label, edge_index, num_nodes, gen):
    """S1 on a skewed draw: k = 25 over an arxiv-like graph (the
    Reddit-shaped graph's in-degrees are Poisson): the draw kernel exactly
    against its plain version, the aggregations as ``_s1_rows`` at F = 128
    in float32 (timed) and bfloat16, the backward's sums of thousands of
    slots within 1e-4 times their sum of magnitudes; prints the
    most slots one source holds beside the backward's longest serial walk."""
    import torch
    from tf_geometric_tpu_torch.nn.sampling.device_sampler import (DeviceNeighborSampler,
                                                                    _random_ints)
    sampler = DeviceNeighborSampler(edge_index, num_nodes=num_nodes, device="cuda")
    csr = sampler.csr()
    r = _random_ints(gen, SAGE_DRAW_K, num_nodes, "cuda")
    args = (r, csr["row_start"], sampler.degree, csr["sorted_col"])
    idx, w = fk.launch_draw_fixed_k(*args)
    idx_p, w_p = fk.draw_fixed_k_plain(*args)
    torch.cuda.synchronize()
    _check(torch.equal(idx, idx_p) and torch.equal(w, w_p),
           f"fixed_k draw on the {label} graph differs from plain")
    print(f"skewed draw ({label}, k={SAGE_DRAW_K}): {_walk_text(fk, idx, num_nodes)}",
          flush=True)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        rows += _s1_rows(fk, num_nodes, SAGE_DRAW_K, 128, dtype, idx, w, gen,
                         f"{label} k={SAGE_DRAW_K} F=128 {str(dtype)[6:]}", label,
                         timed=dtype == torch.float32, long_sums=True)
    return rows


def _walk_text(fk, idx, num_src):
    import torch
    most = int(torch.bincount(idx.reshape(-1).long().clamp(0, num_src - 1),
                              minlength=num_src).max())
    walk, partials = fk.serial_walks(idx, num_src)
    return (f"most slots one source holds {most}, longest serial walk of the backward "
            f"{walk} slots and {partials} partials")


def _print_s1_rows(rows):
    """One line per S1 case."""
    for r in rows:
        head = f"  {r['name']} {r.get('graph', 'reddit')} k={r['k']} F={r.get('width', '-')} " \
               f"{r.get('dtype', 'int32')}"
        if r["name"] == "fixed_k_draw":
            print(f"{head}: {r['max_abs_err']:.3e}, {r['ms']:.4f}, {r['plain_ms']:.4f}, none, "
                  f"{r['bound_ms']:.4f} ({r['bound_by']}), device {_ms_text(r['device_ms'])}",
                  flush=True)
            continue
        if "ms" not in r:
            print(f"{head}: {r['max_abs_err']:.3e} (checked, not timed), bits {r['sha256']}",
                  flush=True)
            continue
        line = (f"{head}: {r['max_abs_err']:.3e}, {r['ms']:.4f}, {r['plain_ms']:.4f}, "
                f"{r['library_ms']:.4f} / {r['library_from_draw_ms']:.4f}, "
                f"{r['bound_ms']:.4f} ({r['bound_by']}), HBM gather {r['hbm_gather_ms']:.4f}, "
                f"device {_ms_text(r['device_ms'])} / {_ms_text(r['device_transpose_ms'])} / "
                f"{_ms_text(r['device_gather_ms'])}")
        if "l2_table_ms" in r:
            line += f", the gather over a table the L2 holds {r['l2_table_ms']:.4f}"
        if r["name"] == "fixed_k_backward" and r["device_kernels"]:
            line += f" ({r['device_kernels']})"
        print(f"{line}, bits {r['sha256']}", flush=True)


def sage_kernel_phase(sage_problem, skew_graphs):
    """The draw kernel and both aggregation kernels against their plain
    versions on the Reddit-shaped graph, and the aggregations on skewed
    draws over ``skew_graphs`` (``(label, edge_index, num_nodes)``, from
    ``_skew_graphs``); returns one row per kernel and case."""
    import torch
    from tf_geometric_tpu_torch.nn.sampling.device_sampler import _random_ints
    from tf_geometric_tpu_torch.ops import fixed_k as fk
    sampler = sage_problem.sampler
    csr = sampler.csr()
    n, nnz = sampler.num_nodes, int(sampler.sorted_col.shape[0])
    deg = sampler.degree
    print(f"reddit sampler: {n} rows, {nnz} edges, {int((deg == 0).sum())} rows without "
          f"edges, largest degree {int(deg.max())}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows, draws = [], {}
    weighted = dict(csr, sorted_weight=torch.rand(nnz, generator=gen, device="cuda"))
    self_ids = torch.randperm(n, generator=gen, device="cuda").int()
    for k in sorted({k for k, _ in SAGE_SHAPES}, reverse=True):
        r = _random_ints(gen, k, n, "cuda")
        idx, w = fk.launch_draw_fixed_k(r, csr["row_start"], deg, csr["sorted_col"])
        idx_p, w_p = fk.draw_fixed_k_plain(r, csr["row_start"], deg, csr["sorted_col"])
        widx, ww = fk.launch_draw_fixed_k(r, weighted["row_start"], deg, weighted["sorted_col"],
                                          weighted["sorted_weight"], self_ids)
        widx_p, ww_p = fk.draw_fixed_k_plain(r, weighted["row_start"], deg,
                                             weighted["sorted_col"],
                                             weighted["sorted_weight"], self_ids)
        torch.cuda.synchronize()
        for got, want, what in ((idx, idx_p, "idx"), (w, w_p, "weight"), (widx, widx_p, "idx"),
                                (ww, ww_p, "weight")):
            _check(torch.equal(got, want), f"fixed_k draw k={k}: {what} differs from plain")
        draws[k] = (idx, w)
        print(f"reddit draw k={k}: {_walk_text(fk, idx, n)}", flush=True)
        if k == SAGE_DRAW_K:
            args = (r, csr["row_start"], deg, csr["sorted_col"])
            nbytes = fk.draw_pass_bytes(k, n, nnz, False)
            rows.append(dict(name="fixed_k_draw", k=k, weighted=False, max_abs_err=0.0,
                             ms=_cuda_ms(lambda: fk.launch_draw_fixed_k(*args)),
                             device_ms=_device_ms(lambda: fk.launch_draw_fixed_k(*args)),
                             plain_ms=_cuda_ms(lambda: fk.draw_fixed_k_plain(*args), iters=3,
                                               warmup=1),
                             library_ms=None, bound_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                             bound_by="bytes"))
        del r, widx, ww, widx_p, ww_p, idx_p, w_p
    print("sage kernel check (name graph k F dtype: max_abs_err, ms, plain_ms, library_ms "
          "prebuilt / from the draw, bound_ms, every gather from HBM, device ms total / "
          "transpose / gather, bits)")
    _print_s1_rows(rows)
    for k, width in SAGE_SHAPES:
        idx, w = draws[k]
        for dtype in (torch.float32, torch.bfloat16):
            case = _s1_rows(fk, n, k, width, dtype, idx, w, gen,
                            f"k={k} F={width} {str(dtype)[6:]}", "reddit")
            _print_s1_rows(case)
            rows += case
            torch.cuda.empty_cache()
    for skew in skew_graphs:
        case = sage_skew_rows(fk, *skew, gen)
        _print_s1_rows(case)
        rows += case
        torch.cuda.empty_cache()
    s1_edge_cases(fk, gen)
    return rows


def _bound(nbytes, flops):
    byte_ms, flop_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOPS_PER_S
    return max(byte_ms, flop_ms), "bytes" if byte_ms >= flop_ms else "operations"


def _x6_edges(normed, num_nodes):
    """The normalized COO with its edges shuffled by a seeded permutation,
    1% sink edges (row = col = N) and a few in-range rows with out-of-range
    columns appended."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(3)
    index, value = normed.index, normed.value.float()
    perm = torch.randperm(index.shape[1], generator=gen, device="cuda")
    sinks = int(index.shape[1] * X6_SINK_SHARE)
    bad = torch.stack([torch.randint(0, num_nodes, (X6_BAD_COLS,), generator=gen, device="cuda"),
                       num_nodes + torch.randint(0, 5, (X6_BAD_COLS,), generator=gen,
                                                 device="cuda")])
    index = torch.cat([index[:, perm], torch.full((2, sinks), num_nodes, device="cuda"), bad],
                      dim=1)
    value = torch.cat([value[perm], torch.rand(sinks + X6_BAD_COLS, generator=gen,
                                               device="cuda")])
    return index, value


def _x6_library(view, value, num_rows, num_cols):
    """A view's matrix as a torch CSR tensor (duplicates summed), for the
    ``torch.sparse.mm`` and ``sampled_addmm`` yardsticks."""
    import torch
    from tf_geometric_tpu_torch.ops.spmm_heads import view_entries
    rows, nbr, eid = view_entries(view)
    coo = torch.sparse_coo_tensor(torch.stack([rows, nbr]), value[eid], (num_rows, num_cols))
    return coo.coalesce().to_sparse_csr()


def spmm_kernel_phase(normed, num_nodes):
    """The one-head SpMM (forward and ``dh``) and SDDMM (``dv``) of the COO
    SpMM against their plain versions on the arxiv COO with shuffled,
    padded and out-of-range edges; returns one row per kernel and case."""
    import torch
    from tf_geometric_tpu_torch.ops import spmm_heads as sh
    n = num_nodes
    index, value = _x6_edges(normed, n)
    w = value[:, None].contiguous()
    views = {"fwd": lambda: sh.build_csr_view(index[0], index[1], n, n),
             "dh": lambda: sh.build_csr_view(index[1], index[0], n, n)}
    view_ms = {k: _cuda_ms(f, iters=5, warmup=1) for k, f in views.items()}
    fwd, bwd = views["fwd"](), views["dh"]()
    nnz_f, nnz_b = int(fwd.row_ptr[-1]), int(bwd.row_ptr[-1])
    print(f"x6 edges: {index.shape[1]} ({int(index.shape[1] * X6_SINK_SHARE)} sinks, "
          f"{X6_BAD_COLS} out-of-range cols); forward view {nnz_f} entries, "
          f"{_view_walk_line(fwd)}; dh view {nnz_b}, {_view_walk_line(bwd)}", flush=True)
    lib_fwd = _x6_library(fwd, value, n, n)
    lib_bwd = _x6_library(bwd, value, n, n)
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        tol, elt = (F32_TOL, 4) if f32 else (BF16_TOL, 2)
        lib_h = lib_fwd.to(dtype)
        for width in X6_WIDTHS:
            tag = f"F={width} {str(dtype)[6:]}"
            h = torch.randn(n, width, generator=gen, device="cuda").to(dtype)
            dy = torch.randn(n, width, generator=gen, device="cuda")  # float32, as the result
            h32 = h.float()
            cases = (
                ("spmm_heads", "x6 forward", nnz_f,
                 lambda: sh.launch_spmm_heads(fwd, w, h, 1, torch.float32),
                 lambda: sh.spmm_heads_plain(fwd, w, h, 1, torch.float32),
                 lambda: torch.sparse.mm(lib_h, h),
                 sh.spmm_pass_bytes(nnz_f, n, n, width, 1, elt, 4)),
                ("spmm_heads", "x6 dh", nnz_b,
                 lambda: sh.launch_spmm_heads(bwd, w, dy, 1),
                 lambda: sh.spmm_heads_plain(bwd, w, dy, 1),
                 lambda: torch.sparse.mm(lib_bwd, dy),
                 sh.spmm_pass_bytes(nnz_b, n, n, width, 1, 4, 4)),
                ("sddmm_heads", "x6 dv", nnz_f,
                 lambda: sh.launch_sddmm_heads(fwd, dy, h32, 1, torch.zeros_like(w)),
                 lambda: sh.sddmm_heads_plain(fwd, dy, h32, 1, torch.zeros_like(w)),
                 (lambda: torch.sparse.sampled_addmm(lib_fwd, dy, h32.t(), beta=0.0))
                 if f32 else None,
                 sh.sddmm_pass_bytes(nnz_f, n, n, width, 1, 4)))
            bounds = []
            for name, case, nnz, kernel, plain, library, nbytes in cases:
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                err = _max_err(got, want, tol, f"{name} {case} {tag}")
                _check(torch.equal(got, kernel()),
                       f"{name} {case} {tag}: two runs on the same inputs differ")
                if name == "sddmm_heads" and library is not None:
                    err = max(err, _max_err(got[fwd.eid[:nnz_f].long(), 0],
                                            _sampled_by_entry(fwd, library(), n), F32_TOL,
                                            f"{name} {case} {tag} vs the library call"))
                bound_ms, bound_by = _bound(nbytes, sh.pass_flops(nnz, width))
                bounds.append(f"{case} {bound_ms:.4f} ms")
                rows.append(dict(
                    name=name, case=case, width=width, dtype=str(dtype)[6:], heads=1,
                    max_abs_err=err, ms=_cuda_ms(kernel),
                    plain_ms=_cuda_ms(plain, iters=3, warmup=1),
                    library_ms=None if library is None else _cuda_ms(library),
                    bound_ms=bound_ms, bound_by=bound_by))
                if name == "sddmm_heads":
                    rows[-1].update(device_ms=_device_ms(kernel), library_device_ms=None
                                    if library is None else _device_ms(library))
                if case == "x6 forward":
                    rows[-1]["view_order_ms"] = _view_order_ms(fwd, w, h, 1, torch.float32, got,
                                                               f"{case} {tag}")
                del got, want
            print(f"x6 {tag}: view build {view_ms['fwd']:.4f} ms (forward, dv), "
                  f"{view_ms['dh']:.4f} ms (dh); bounds {', '.join(bounds)}", flush=True)
    del lib_fwd, lib_bwd, lib_h
    torch.cuda.empty_cache()
    print("x6 kernel check (name case F dtype: max_abs_err, ms, plain_ms, library_ms, bound_ms; "
          "forward: with the weights in view order; dv: device ms under the profiler)")
    for r in rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  {r['name']} {r['case']} F={r['width']} {r['dtype']}: {r['max_abs_err']:.3e}, "
              f"{r['ms']:.4f}, {r['plain_ms']:.4f}, {lib}, {r['bound_ms']:.4f} "
              f"({r['bound_by']}){_view_order_note(r)}{_device_note(r)}", flush=True)
    return rows


def _view_walk_line(view):
    """A view's longest row beside the SpMM kernel's longest serial walks
    (``row_split``): the most entries one lane group reads in sequence and
    the most chunk partials it adds into one row; and the SDDMM's
    (``_sddmm_walk``)."""
    from tf_geometric_tpu_torch.ops.spmm_heads import CHUNK, row_split
    plan = row_split(view.row_ptr)
    lens = view.row_ptr.diff()
    direct = int((plan.direct_end - view.row_ptr[:-1].long()).max())
    merge = int((plan.chunk_hi - plan.chunk_lo).max())
    return (f"max_row_len={int(lens.max())} longest serial walk: "
            f"{max(direct, CHUNK if merge else 0)} entries, {merge} partials "
            f"({int((lens > CHUNK).sum())} rows over {CHUNK}); SDDMM {_sddmm_walk(view)} entries")


def _sddmm_walk(view):
    """The SDDMM kernel's longest serial walk: the most entries one lane
    group reads in sequence (a chunk of ``CHUNK`` consecutive entries of the
    view, whatever their rows)."""
    from tf_geometric_tpu_torch.ops.spmm_heads import CHUNK
    return min(CHUNK, int(view.row_ptr[-1]))


def _sampled_by_entry(view, res, num_cols):
    """A ``sampled_addmm`` result on the coalesced pattern of ``view``'s
    matrix (``_x6_library``), one value per stored entry of the view, in
    view order."""
    import torch
    from tf_geometric_tpu_torch.ops.spmm_heads import view_entries
    rows, nbr, _ = view_entries(view)
    pos = torch.unique(rows * num_cols + nbr, return_inverse=True)[1]
    return res.values()[pos]


def _view_order_ms(view, w, src, heads, out_dtype, got, what):
    """The SpMM with each entry's weights gathered into view order first
    (identity edge ids, so the kernel reads them in sequence): the same bits
    as ``got``; returns its time, the weight gather's cost read off against
    the kernel's."""
    import torch
    from tf_geometric_tpu_torch.ops import spmm_heads as sh
    ids = torch.arange(view.eid.shape[0], dtype=torch.int32, device=view.eid.device)
    view_vo = sh.CsrView(view.row_ptr, view.nbr, ids, view.row)
    w_vo = w[view.eid.long()].contiguous()
    _check(torch.equal(sh.launch_spmm_heads(view_vo, w_vo, src, heads, out_dtype), got),
           f"spmm_heads {what}: weights in view order change the result")
    return _cuda_ms(lambda: sh.launch_spmm_heads(view_vo, w_vo, src, heads, out_dtype))


def _view_order_note(r):
    return f", view order {r['view_order_ms']:.4f}" if "view_order_ms" in r else ""


def _x3_library(layout, w, heads):
    """The layout's per-head matrices for the library yardsticks: the
    forward's [H, N, N] sparse COO (values ``w[:, h]``, duplicate edges
    summed) and its transpose (``dV``) for ``torch.bmm``, the [H, N, N]
    batched CSR pattern for ``torch.sparse.sampled_addmm`` (``d_att``), and
    each stored entry's position in that pattern and its edge id."""
    import torch
    from tf_geometric_tpu_torch.ops.spmm_heads import view_entries
    n, dev = layout.num_nodes, w.device
    rows, nbr, eid = view_entries(layout.dst)
    uniq, pos = torch.unique(rows * n + nbr, return_inverse=True)
    m = uniq.shape[0]
    urow, ucol = uniq // n, uniq % n
    vals = torch.zeros(m, heads, device=dev).index_add_(0, pos, w[eid]).t().reshape(-1)
    hh = torch.arange(heads, device=dev).repeat_interleave(m)
    fwd = torch.sparse_coo_tensor(torch.stack([hh, urow.repeat(heads), ucol.repeat(heads)]),
                                  vals, (heads, n, n), is_coalesced=True)
    bwd = torch.sparse_coo_tensor(torch.stack([hh, ucol.repeat(heads), urow.repeat(heads)]),
                                  vals, (heads, n, n)).coalesce()
    crow = torch.searchsorted(urow, torch.arange(n + 1, device=dev))
    pattern = torch.sparse_csr_tensor(crow.expand(heads, -1).contiguous(),
                                      ucol.expand(heads, -1).contiguous(),
                                      torch.ones(heads, m, device=dev), (heads, n, n))
    return fwd, bwd, pattern, pos, eid


def multihead_kernel_phase(layout, shapes=X3_SHAPES, label="x3", bf16=True, keep=None):
    """The multi-head SpMM (forward on the destination side, ``dV`` on the
    source side) and SDDMM (``d_att``) against their plain versions on
    ``layout`` (the self-looped arxiv layout by default) at each (H, d_v) of
    ``shapes``, float32 and (``bf16``) bfloat16, and in float32 against the
    library calls; ``keep``: the weights' keep rate (zeros elsewhere, the
    kept scaled), as an attention dropout leaves them. Returns one row per
    kernel and case."""
    import torch
    from tf_geometric_tpu_torch.ops import spmm_heads as sh
    n, E = layout.num_nodes, layout.num_edges
    nnz = int(layout.dst.nbr.shape[0])
    print(f"{label} destination side: {_view_walk_line(layout.dst)}; source side: "
          f"{_view_walk_line(layout.src)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for heads, d in shapes:
        width = heads * d
        for dtype in (torch.float32, torch.bfloat16) if bf16 else (torch.float32,):
            f32 = dtype == torch.float32
            tol, elt = (F32_TOL, 4) if f32 else (BF16_TOL, 2)
            tag = f"H={heads} d_v={d} {str(dtype)[6:]}"
            att = torch.rand(E, heads, generator=gen, device="cuda")
            if keep is not None:
                att = att * (torch.rand(E, heads, generator=gen, device="cuda") < keep) / keep
            w = att.to(dtype).float()  # the weights in v's dtype, as the op casts them
            v = torch.randn(n, width, generator=gen, device="cuda").to(dtype)
            dy = torch.randn(n, width, generator=gen, device="cuda").to(dtype)
            # per head, [H, N, d]: the library calls' dense operands
            v3, dy3 = (t.view(n, heads, d).transpose(0, 1).contiguous() for t in (v, dy))
            lib = _x3_library(layout, w, heads) if f32 else None

            def heads_last(got, res):  # [H, N, d] back to [N, H·d]
                return got, res.transpose(0, 1).reshape(n, width)

            def by_edge(got, res):  # the pattern's entries back to edge ids
                return got[lib[4]], res.values()[:, lib[3]].t()

            cases = (
                ("spmm_heads", f"{label} forward",
                 lambda: sh.launch_spmm_heads(layout.dst, w, v, heads),
                 lambda: sh.spmm_heads_plain(layout.dst, w, v, heads),
                 (lambda: torch.bmm(lib[0], v3)) if f32 else None, heads_last,
                 sh.spmm_pass_bytes(nnz, n, n, width, heads, elt, elt)),
                ("spmm_heads", f"{label} dV",
                 lambda: sh.launch_spmm_heads(layout.src, w, dy, heads),
                 lambda: sh.spmm_heads_plain(layout.src, w, dy, heads),
                 (lambda: torch.bmm(lib[1], dy3)) if f32 else None, heads_last,
                 sh.spmm_pass_bytes(nnz, n, n, width, heads, elt, elt)),
                ("sddmm_heads", f"{label} d_att",
                 lambda: sh.launch_sddmm_heads(layout.dst, dy, v, heads, torch.zeros_like(w)),
                 lambda: sh.sddmm_heads_plain(layout.dst, dy, v, heads, torch.zeros_like(w)),
                 (lambda: torch.sparse.sampled_addmm(lib[2], dy3, v3.transpose(1, 2), beta=0.0))
                 if f32 else None, by_edge,
                 sh.sddmm_pass_bytes(nnz, n, n, width, heads, elt)))
            for name, case, kernel, plain, library, align, nbytes in cases:
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                err = _max_err(got, want, tol, f"{name} {case} {tag}")
                _check(torch.equal(got, kernel()),
                       f"{name} {case} {tag}: two runs on the same inputs differ")
                if library is not None:
                    err = max(err, _max_err(*align(got, library()), F32_TOL,
                                            f"{name} {case} {tag} vs the library call"))
                bound_ms, bound_by = _bound(nbytes, sh.pass_flops(nnz, width))
                rows.append(dict(
                    name=name, case=case, width=d, dtype=str(dtype)[6:], heads=heads,
                    max_abs_err=err, ms=_cuda_ms(kernel),
                    plain_ms=_cuda_ms(plain, iters=3, warmup=1),
                    library_ms=None if library is None else _cuda_ms(library),
                    bound_ms=bound_ms, bound_by=bound_by))
                if name == "sddmm_heads" and f32:
                    rows[-1].update(device_ms=_device_ms(kernel),
                                    library_device_ms=_device_ms(library))
                if case == f"{label} forward":
                    rows[-1]["view_order_ms"] = _view_order_ms(layout.dst, w, v, heads, v.dtype,
                                                               got, f"{case} {tag}")
                del got, want
            del att, w, v, dy, v3, dy3, lib
            torch.cuda.empty_cache()
    print(f"{label} kernel check (name case H d_v dtype: max_abs_err, ms, plain_ms, library_ms, "
          "bound_ms; library: torch.bmm / sampled_addmm, float32 only; d_att float32: device "
          "ms under the profiler)")
    for r in rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  {r['name']} {r['case']} H={r['heads']} d_v={r['width']} {r['dtype']}: "
              f"{r['max_abs_err']:.3e}, {r['ms']:.4f}, {r['plain_ms']:.4f}, {lib}, "
              f"{r['bound_ms']:.4f} ({r['bound_by']}){_view_order_note(r)}"
              f"{_device_note(r)}", flush=True)
    return rows


def gin_kernel_phase(graph_problem):
    """The COO SpMM kernel at the GIN step's own calls: the batch's padded
    edge list with values one (sink edges dropped by the views), the forward
    at the input width and at ``GIN_UNITS``, ``dh`` at ``GIN_UNITS``, against
    the plain version and ``torch.sparse.mm`` (float32); returns one row per
    call."""
    import torch
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch.ops import spmm_heads as sh
    index, n = graph_problem.edge_index, graph_problem.x.shape[0]
    w = torch.ones(index.shape[1], 1, device="cuda")
    fwd = sh.build_csr_view(index[0], index[1], n, n)
    bwd = sh.build_csr_view(index[1], index[0], n, n)
    gen = torch.Generator(device="cuda").manual_seed(6)
    hidden, dy = (torch.randn(n, bench.GIN_UNITS, generator=gen, device="cuda")
                  for _ in range(2))
    rows = []
    for case, view, src in (("gin forward", fwd, graph_problem.x), ("gin forward", fwd, hidden),
                            ("gin dh", bwd, dy)):
        width, nnz = src.shape[1], int(view.row_ptr[-1])
        lib = _x6_library(view, w[:, 0], n, n)
        tag = f"{case} F={width}"
        got, want = sh.launch_spmm_heads(view, w, src, 1), sh.spmm_heads_plain(view, w, src, 1)
        torch.cuda.synchronize()
        err = max(_max_err(got, want, F32_TOL, f"spmm_heads {tag}"),
                  _max_err(got, torch.sparse.mm(lib, src), F32_TOL,
                           f"spmm_heads {tag} vs torch.sparse.mm"))
        bound_ms, bound_by = _bound(sh.spmm_pass_bytes(nnz, n, n, width, 1, 4, 4),
                                    sh.pass_flops(nnz, width))
        rows.append(dict(
            name="spmm_heads", case=case, width=width, dtype="float32", heads=1,
            max_abs_err=err, ms=_cuda_ms(lambda: sh.launch_spmm_heads(view, w, src, 1)),
            plain_ms=_cuda_ms(lambda: sh.spmm_heads_plain(view, w, src, 1), iters=3, warmup=1),
            library_ms=_cuda_ms(lambda: torch.sparse.mm(lib, src)),
            bound_ms=bound_ms, bound_by=bound_by,
            device_ms=_device_ms(lambda: sh.launch_spmm_heads(view, w, src, 1)),
            library_device_ms=_device_ms(lambda: torch.sparse.mm(lib, src))))
    print(f"gin kernel check ({int(fwd.row_ptr[-1])} of {index.shape[1]} edges in the views; "
          f"name case F: max_abs_err, ms, plain_ms, library_ms, bound_ms; device ms under the "
          f"profiler)")
    for r in rows:
        print(f"  {r['name']} {r['case']} F={r['width']}: {r['max_abs_err']:.3e}, "
              f"{r['ms']:.4f}, {r['plain_ms']:.4f}, {r['library_ms']:.4f}, "
              f"{r['bound_ms']:.4f} ({r['bound_by']}){_device_note(r)}", flush=True)
    return rows


# ---------------------------------------------------------------------------
# the host samplers (workload 18, flat against dense) and the graph
# auto-encoder (demo/demo_gae.py)
# ---------------------------------------------------------------------------

FLAT_DENSE_K, FLAT_DENSE_UNITS, FLAT_DENSE_SEED = 25, 128, 1
GAE_TRAIN_STEPS, GAE_PROFILE_STEPS = 10, 3


def host_sage_phase(problem, gpu):
    """Workload 18's host draws and S1 on them, at Reddit size: two runs
    from the initial weights draw the same slots, bit for bit (SHA-256
    digits printed), with the host draw's and the copy's ms; then 3 Adam
    steps through the kernels and through the plain versions on the same
    host draws: the losses within 1e-4, the kernel run launching exactly 2
    S1 forward and 2 backward calls a step and no draw kernel, the plain run
    nothing."""
    import torch
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch.ops import config as kernel_config
    from tf_geometric_tpu_torch.ops import fixed_k as fk
    wl = bench.WORKLOADS[bench.HOST_SAGE_WORKLOAD]
    digests = []
    for _ in range(2):
        wl.init(problem)
        digests.append([_digest(t) for pair in bench.host_sage_draws(problem) for t in pair])
    torch.cuda.synchronize()
    _check(digests[0] == digests[1], f"host draws differ run to run: {digests}")
    rates = bench.host_sage_rates(problem, 2)
    print(f"host sage: slots bit for bit run to run ({' '.join(digests[0])}); host draw "
          f"{rates['host_draw_ms']:.2f} ms, copy {rates['copy_ms']:.4f} ms for "
          f"{rates['copy_bytes']} bytes a step on {gpu}", flush=True)
    layers, steps = len(problem.fanouts), 3
    per_call = fk.fixed_k_backward_launches(problem.x.shape[0])
    losses = {}
    for label in ("kernel", "plain"):
        _zero_launch_counts()
        step = bench.make_step(lambda p: wl.loss(p, problem), wl.init(problem), wl.lr)
        with (kernel_config.use_plain_versions() if label == "plain"
              else contextlib.nullcontext()):
            losses[label] = torch.stack([step() for _ in range(steps)])
        expected = dict.fromkeys(_KERNELS, 0)
        if label == "kernel":
            expected.update(fixed_k_forward=steps * layers,
                            fixed_k_backward=steps * layers * per_call)
        counts = dict(zip(_KERNELS, _launch_counts()))
        _check(counts == expected, f"host sage {label}: launches {counts} != {expected}")
    err = _max_err(losses["kernel"], losses["plain"], F32_TOL, "host sage 3-step losses")
    print(f"host sage kernel vs plain: {losses['kernel'].tolist()} / {losses['plain'].tolist()}, "
          f"max abs err {err:.3e}", flush=True)


def flat_dense_phase(graph, gpu):
    """One host draw state feeds ``sample(k, padding=True)`` into
    ``mean_graph_sage`` (the flat edge list through the segment core) and
    ``sample_dense(k)`` into ``mean_graph_sage_fixed_k`` (S1), on the
    arxiv-shaped graph at k = 25, F = 128 (at Reddit size the flat gather
    would take 14 GB): outputs and the gradients of x and both kernels
    agree within float32 1e-4 of each sum's magnitudes (``_sum_err``), S1
    launched once forward and once backward."""
    import torch
    from tf_geometric_tpu_torch.nn.conv.graph_sage import mean_graph_sage, mean_graph_sage_fixed_k
    from tf_geometric_tpu_torch.ops import fixed_k as fk
    from tf_geometric_tpu_torch.utils.graph_utils import RandomNeighborSampler
    sampler = RandomNeighborSampler(graph.edge_index, rng=FLAT_DENSE_SEED)
    state = sampler.rng.bit_generator.state
    t0 = time.perf_counter()
    flat = sampler.sample(k=FLAT_DENSE_K, padding=True)
    flat_s = time.perf_counter() - t0
    sampler.rng.bit_generator.state = state
    t0 = time.perf_counter()
    dense = sampler.sample_dense(FLAT_DENSE_K)
    dense_s = time.perf_counter() - t0
    n, f = graph.x.shape
    gen = torch.Generator(device="cuda").manual_seed(FLAT_DENSE_SEED)
    x = torch.as_tensor(graph.x, device="cuda")
    ws, wn = (0.05 * torch.randn(f, FLAT_DENSE_UNITS, generator=gen, device="cuda")
              for _ in range(2))
    c = torch.randn(n, 2 * FLAT_DENSE_UNITS, generator=gen, device="cuda")
    outs, grads = [], []
    for fn, (a, b) in ((mean_graph_sage, flat), (mean_graph_sage_fixed_k, dense)):
        _zero_launch_counts()
        leaves = [t.clone().requires_grad_() for t in (x, ws, wn)]
        # no activation: at a ReLU's kink the two sides' rounding-level
        # difference in an output flips its gradient, whatever the sums
        out = fn(leaves[0], torch.as_tensor(a, device="cuda"), torch.as_tensor(b, device="cuda"),
                 leaves[1], leaves[2])
        (out * c).sum().backward()
        outs.append(out.detach())
        grads.append([leaf.grad for leaf in leaves])
        counts = dict(zip(_KERNELS, _launch_counts()))
        dense_run = fn is mean_graph_sage_fixed_k
        want = dict.fromkeys(_KERNELS, 0)
        if dense_run:
            want.update(fixed_k_forward=1, fixed_k_backward=fk.fixed_k_backward_launches(n))
        _check(counts == want, f"flat/dense {'dense' if dense_run else 'flat'}: launches "
                               f"{counts} != {want}")
    # each result is a float32 sum over many terms (a hub row of x gathers
    # thousands of slots' gradients), in another order on each side: held
    # within 1e-4 of the same sum over the terms' magnitudes (_sum_err)
    idx, w = (torch.as_tensor(a, device="cuda") for a in dense)
    k, units = idx.shape[0], FLAT_DENSE_UNITS
    agg_abs = fk.fixed_k_forward_plain(x.abs(), idx, w.abs()) / k
    d_self, d_neigh = c[:, :units], c[:, units:]
    d_acc = d_neigh @ wn.t() / k
    scales = (torch.cat([x.abs() @ ws.abs(), agg_abs @ wn.abs()], dim=1),
              fk.fixed_k_backward_plain(d_acc.abs().contiguous(), idx, w.abs(), n)
              + d_self.abs() @ ws.abs().t(),
              x.abs().t() @ d_self.abs(), agg_abs.t() @ d_neigh.abs())
    pairs = [(outs[1], outs[0], "output")] + list(zip(
        grads[1], grads[0], ("gradient of x", "gradient of the self kernel",
                             "gradient of the neighbor kernel")))
    errs = [_sum_err(got, want, scale, F32_TOL, f"dense vs flat {what}")
            for (got, want, what), scale in zip(pairs, scales)]
    print(f"flat vs dense (arxiv, k={FLAT_DENSE_K}, F={f}): host draws {flat_s * 1e3:.1f} ms "
          f"(flat) / {dense_s * 1e3:.1f} ms (dense); max abs err output {errs[0]:.3e}, "
          f"gradients {', '.join(f'{e:.3e}' for e in errs[1:])} on {gpu}", flush=True)


def _gae_normed(problem):
    """The GAE encoder's normalized adjacency, as each GCN call builds it."""
    from tf_geometric_tpu_torch.nn.conv.gcn import gcn_norm_adj
    from tf_geometric_tpu_torch.sparse import SparseMatrix
    n = problem.x.shape[0]
    return gcn_norm_adj(SparseMatrix(problem.edge_index, problem.edge_weight, (n, n)))


def gae_kernel_phase(problem):
    """X6 at the GAE encoder's calls on the arxiv train split (normalized,
    self-loops added): the forward and ``dh`` SpMM at F = 32 and 16,
    float32, against their plain versions and ``torch.sparse.mm`` (1e-4)
    and a second run (bit for bit), timed by events and device time beside
    the byte bound. Returns one row per call."""
    import torch
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch.ops import spmm_heads as sh
    normed = _gae_normed(problem)
    n, index = normed.shape[0], normed.index
    w = normed.value.float()[:, None].contiguous()
    fwd = sh.build_csr_view(index[0], index[1], n, n)
    bwd = sh.build_csr_view(index[1], index[0], n, n)
    nnz = int(fwd.row_ptr[-1])
    print(f"gae x6: the train split's normalized adjacency, {n} rows, {nnz} entries; "
          f"{_view_walk_line(fwd)}", flush=True)
    lib_fwd, lib_bwd = _x6_library(fwd, w[:, 0], n, n), _x6_library(bwd, w[:, 0], n, n)
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    for width in bench.GAE_UNITS:
        h, dy = (torch.randn(n, width, generator=gen, device="cuda") for _ in range(2))
        for case, view, lib, arg in (("gae forward", fwd, lib_fwd, h),
                                     ("gae dh", bwd, lib_bwd, dy)):
            tag = f"spmm_heads {case} F={width}"
            kernel = (lambda v=view, a=arg: sh.launch_spmm_heads(v, w, a, 1))
            plain = (lambda v=view, a=arg: sh.spmm_heads_plain(v, w, a, 1))
            library = (lambda m=lib, a=arg: torch.sparse.mm(m, a))
            got = kernel()
            err = _max_err(got, plain(), F32_TOL, tag)
            _check(torch.equal(got, kernel()), f"{tag}: two runs on the same inputs differ")
            err = max(err, _max_err(got, library(), F32_TOL, f"{tag} vs the library call"))
            bound_ms, bound_by = _bound(sh.spmm_pass_bytes(nnz, n, n, width, 1, 4, 4),
                                        sh.pass_flops(nnz, width))
            rows.append(dict(name="spmm_heads", case=case, width=width, dtype="float32",
                             heads=1, max_abs_err=err, ms=_cuda_ms(kernel),
                             plain_ms=_cuda_ms(plain, iters=3, warmup=1),
                             library_ms=_cuda_ms(library), bound_ms=bound_ms,
                             bound_by=bound_by, device_ms=_device_ms(kernel),
                             library_device_ms=_device_ms(library)))
    print("gae x6 kernel check (case F: max_abs_err, ms, plain_ms, library_ms, bound_ms; "
          "device ms under the profiler)")
    for r in rows:
        print(f"  {r['case']} F={r['width']}: {r['max_abs_err']:.3e}, {r['ms']:.4f}, "
              f"{r['plain_ms']:.4f}, {r['library_ms']:.4f}, {r['bound_ms']:.4f} "
              f"({r['bound_by']}){_device_note(r)}", flush=True)
    return rows


def _gae_step(model, opt, problem, neg, keep_mask=None):
    """One Adam step of the GAE on the negatives ``neg``; the loss."""
    from tf_geometric_tpu_torch import bench
    opt.zero_grad(set_to_none=True)
    loss = bench.gae_loss(model, problem, neg, keep_mask=keep_mask)
    loss.backward()
    opt.step()
    return loss.detach()


def gae_phase(problem, gpu):
    """The graph auto-encoder of ``demo_gae.py`` on the synthetic arxiv
    graph: 3 Adam steps through the kernels and through the plain versions
    on the same negatives and explicit dropout keep masks (losses within
    1e-4); then ``GAE_TRAIN_STEPS`` steps, each drawing its negatives on the
    host (``negative_sampling(T, N, train, rng=step)``), with the loss, the
    step's ms (CUDA events) and the host's negative sampling ms printed and
    exactly 2 GCNs × (forward + ``dh``) X6 calls a step launched; the card's
    busy time over ``GAE_PROFILE_STEPS`` profiled steps; the test AUC
    (``binary_auc``), printed and not gated. Returns the X6 launches."""
    import numpy as np
    import torch
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch.ops import config as kernel_config
    from tf_geometric_tpu_torch.ops import spmm_heads as sh
    from tf_geometric_tpu_torch.utils.profiling import device_time_by_kernel
    n, t = problem.x.shape[0], problem.train_index.shape[1]
    print(f"gae: {t} train pairs, {problem.test_index.shape[1]} test pairs, "
          f"{problem.edge_index.shape[1]} directed train edges", flush=True)
    negs = [bench.gae_negatives(problem, s) for s in range(3)]
    gen = torch.Generator(device="cuda").manual_seed(bench.GAE_SEED)
    masks = [torch.rand(n, bench.GAE_UNITS[0], generator=gen, device="cuda")
             >= bench.GAE_DROP_RATE for _ in range(3)]
    losses = {}
    for label in ("kernel", "plain"):
        model = bench.init_gae_model(problem)
        opt = torch.optim.Adam(model.parameters(), lr=bench.GAE_LR)
        with (kernel_config.use_plain_versions() if label == "plain"
              else contextlib.nullcontext()):
            losses[label] = torch.stack([_gae_step(model, opt, problem, neg, mask)
                                         for neg, mask in zip(negs, masks)])
    err = _max_err(losses["kernel"], losses["plain"], F32_TOL, "gae 3-step losses")
    print(f"gae kernel vs plain: {losses['kernel'].tolist()} / {losses['plain'].tolist()}, "
          f"max abs err {err:.3e}", flush=True)

    model = bench.init_gae_model(problem)
    opt = torch.optim.Adam(model.parameters(), lr=bench.GAE_LR)
    _zero_launch_counts()
    step_ms, neg_ms, losses = [], [], []
    for s in range(GAE_TRAIN_STEPS):
        t0 = time.perf_counter()
        neg = bench.gae_negatives(problem, s)
        neg_ms.append((time.perf_counter() - t0) * 1e3)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        losses.append(_gae_step(model, opt, problem, neg))
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    counts = dict(zip(_KERNELS, _launch_counts()))
    entries = _gae_normed(problem).index.shape[1]
    want = dict.fromkeys(_KERNELS, 0)
    want.update(spmm_heads=GAE_TRAIN_STEPS * 2 * 2 * sh.spmm_heads_launches(entries))
    _check(counts == want, f"gae: launches {counts} != expected {want}")
    losses = torch.stack(losses).tolist()
    _check(all(math.isfinite(v) for v in losses), f"gae: non-finite loss {losses}")
    _check(losses[-1] < losses[0], f"gae: loss did not fall: {losses}")

    from torch.profiler import ProfilerActivity, profile
    prof_negs = [bench.gae_negatives(problem, GAE_TRAIN_STEPS + s)
                 for s in range(GAE_PROFILE_STEPS)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for neg in prof_negs:
            _gae_step(model, opt, problem, neg)
        end.record()
        end.synchronize()
    kernels = device_time_by_kernel(prof, GAE_PROFILE_STEPS)
    busy_ms = sum(k[1] for k in kernels)
    span_ms = start.elapsed_time(end) / GAE_PROFILE_STEPS
    auc = bench.gae_test_auc(model, problem)
    neg_med = float(np.median(neg_ms))
    print(f"gae: losses {[round(v, 5) for v in losses]}; step {np.median(step_ms):.4f} ms "
          f"(events, median of {GAE_TRAIN_STEPS}; {[round(v, 3) for v in step_ms]}), host "
          f"negative sampling {neg_med:.2f} ms a step (median; "
          f"{[round(v, 1) for v in neg_ms]}); profiled: device busy {busy_ms:.4f} ms of a "
          f"{span_ms:.4f} ms step span ({sum(k[2] for k in kernels):.0f} kernels a step), "
          f"{busy_ms / (span_ms + neg_med):.4f} of a step with its negatives; "
          f"test AUC {auc:.4f} (not gated); launches {counts} on {gpu}", flush=True)
    print(json.dumps({"gae_top": [[k[0][:90], round(k[1], 5), k[2]] for k in kernels[:8]]}),
          flush=True)
    return counts["spmm_heads"]


def gae_kernel_entry(gae_rows, launches):
    """The ``{"kernels"}`` entry of X6 on the GAE path, at its heaviest
    call (the first GCN's forward, F = 32); its launches are the GAE
    training run's."""
    _check(launches > 0, "spmm_heads was not launched on the GAE path")
    rep = next(r for r in gae_rows if r["case"] == "gae forward" and r["width"] == 32)
    return {"name": "gae:spmm_heads", "route": "cuda",
            "source": "tf_geometric_tpu_torch/csrc/spmm_heads.cu",
            "replaces": "tf_geometric_tpu/ops/spmm.py:67", "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in gae_rows), "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            "shape": "the GAE's arxiv train split, normalized: forward F=32, float32; launches "
                     f"over {GAE_TRAIN_STEPS} training steps"}


# ---------------------------------------------------------------------------
# Planetoid node classification through the demo twins (phase 19)
# ---------------------------------------------------------------------------

PLANETOID_NAME, PLANETOID_SEED = "pubmed", 0
PLANETOID_STEPS, PLANETOID_PATIENCE, PLANETOID_PROFILE_STEPS = 200, 100, 10
PLANETOID_CHECK_STEPS = 3
# the keep rate of the demo GAT's attention dropout (rate 0.6)
PLANETOID_GAT_KEEP = 0.4
# kernel launches of one training step and of one evaluation, by model
PLANETOID_STEP_LAUNCHES = {"gcn": dict(csr_spmm=4),
                           "gat": dict(gat_forward=2, gat_backward_dst=2, gat_backward_src=2)}
PLANETOID_EVAL_LAUNCHES = {"gcn": dict(csr_spmm=2), "gat": dict(gat_forward=2)}


def _planetoid_problem(name):
    """The hard-mode Pubmed-shaped set for demo ``name`` ("gcn" or "gat"),
    built on the host (no file is looked for), moved to the card: the graph,
    the splits, the class count, the demo module, and a function that
    builds the model from its seed and returns it with its
    ``forward(training, generator, keep_masks)``."""
    import numpy as np
    import torch
    from tf_geometric_tpu_torch.datasets.synthetic_citation import HardCitationDataset
    from tf_geometric_tpu_torch.demos import demo_gat, demo_gcn
    graph, splits = HardCitationDataset(PLANETOID_NAME, seed=PLANETOID_SEED,
                                        model=name).load_data()
    graph.convert_data_to_tensor(device="cuda")
    splits = tuple(torch.as_tensor(np.asarray(s, np.int64), device="cuda") for s in splits)
    num_classes = int(graph.y.max()) + 1
    demo = demo_gcn if name == "gcn" else demo_gat
    if name == "gcn":
        def build():
            model, adj, cache = demo_gcn.build_model(graph, num_classes)
            return model, (lambda training, gen, masks=(None, None):
                           model(graph.x, adj, cache, gen, masks))
    else:
        def build():
            model, cache = demo_gat.build_model(graph, num_classes)
            return model, (lambda training, gen, masks=(None, None, None):
                           model(graph.x, graph.edge_index, cache, gen, masks))
    return graph, splits, num_classes, demo, build


def _planetoid_masks(name, graph, model, gen):
    """Dropout keep masks for one step of demo ``name``: x's and the hidden
    layer's (bool), and for the GAT the first layer's attention mask
    ([E, 8] float, scaled, in the cached layout's edge order)."""
    import torch
    n, rate = graph.x.shape[0], model.drop_rate
    x_mask = torch.rand(graph.x.shape, generator=gen, device="cuda") >= rate
    if name == "gcn":
        return x_mask, torch.rand(n, 16, generator=gen, device="cuda") >= rate
    layout = graph.cache[f"gat_edges_{n}"][2]
    att = ((torch.rand(layout.num_edges, 8, generator=gen, device="cuda") >= rate).float()
           / (1.0 - rate))
    return x_mask, att, torch.rand(n, 64, generator=gen, device="cuda") >= rate


def _normed_csr_rows(label, graph, cases, gen, gpu):
    """Kernel A on ``graph``'s cached normalized adjacency at each (side,
    F) of ``cases``, float32, against its plain version (1e-4), a second
    run (bit for bit) and ``torch.sparse.mm``; timed by events and device
    time beside its byte bound and the library call. Returns the rows."""
    import torch
    from tf_geometric_tpu_torch.nn.conv.gcn import compute_cache_key
    from tf_geometric_tpu_torch.ops.csr_spmm import side_matmul, side_matmul_plain
    key = compute_cache_key("both", True, True, True, False)
    adj = graph.cache[key + ":ell"]
    index, value, _ = graph.cache[key]
    n, diag = adj.shape[0], adj.diag_val
    library = {s: _library_csr(adj, index, value, s) for s in ("fwd", "bwd")}
    for side_name in ("fwd", "bwd"):
        side = getattr(adj, side_name)
        print(f"{label} {side_name} side: rows={side.num_rows} "
              f"virtual_rows={side.num_virtual} nnz={int(side.col.shape[0])} "
              f"{_walk_line(side)}", flush=True)
    rows = []
    for side_name, width in cases:
        side, lib = getattr(adj, side_name), library[side_name]
        h = torch.randn(n, width, generator=gen, device="cuda")
        tag = f"{label} {side_name} F={width}"
        got = side_matmul(side, h, diag)
        err = _max_err(got, side_matmul_plain(side, h, diag), F32_TOL, f"csr_spmm {tag}")
        _check(torch.equal(got, side_matmul(side, h, diag)),
               f"csr_spmm {tag}: two runs on the same inputs differ")
        err = max(err, _max_err(got, torch.sparse.mm(lib, h), F32_TOL,
                                f"csr_spmm {tag} vs torch.sparse.mm"))
        nnz = int(side.col.shape[0])
        nbytes = (2 * n * width * 4 + 4 * side.row_ptr.shape[0] + 8 * nnz + 4 * n)
        bound_ms, bound_by = _bound(nbytes, 2 * (nnz + n) * width)
        rows.append(dict(
            name="csr_spmm", side=side_name, width=width, dtype="float32",
            max_abs_err=err, ms=_cuda_ms(lambda: side_matmul(side, h, diag)),
            plain_ms=_cuda_ms(lambda: side_matmul_plain(side, h, diag)),
            library_ms=_cuda_ms(lambda: torch.sparse.mm(lib, h)),
            bound_ms=bound_ms, bound_by=bound_by,
            device_ms=_device_ms(lambda: side_matmul(side, h, diag)),
            library_device_ms=_device_ms(lambda: torch.sparse.mm(lib, h))))
    print(f"{label} kernel check, Kernel A (side F: max_abs_err, ms, plain_ms, "
          f"library_ms, bound_ms; device ms under the profiler) on {gpu}")
    for r in rows:
        print(f"  {r['side']} F={r['width']}: {r['max_abs_err']:.3e}, {r['ms']:.4f}, "
              f"{r['plain_ms']:.4f}, {r['library_ms']:.4f}, {r['bound_ms']:.4f} "
              f"({r['bound_by']}){_device_note(r)}", flush=True)
    return rows


def _planetoid_kernel_rows(name, graph, gpu):
    """Each kernel of demo ``name`` at the shapes the demo gives it, against
    its plain version and a second run: Kernel A on the normalized Pubmed
    adjacency at F = 16 and F = C, forward and ``dh`` (1e-4, bit for bit),
    timed by events and device time beside its byte bound and
    ``torch.sparse.mm``; the three attention kernels on the self-looped
    layout at (H, d) = (8, 8) with a 0.4 keep mask and (1, C) without,
    float32 (``_gat_case``'s tolerances), timed."""
    import torch
    n, c = graph.x.shape[0], int(graph.y.max()) + 1
    gen = torch.Generator(device="cuda").manual_seed(19)
    rows = []
    if name == "gcn":
        return _normed_csr_rows("planetoid gcn", graph, [(s, w) for w in (16, c)
                                                         for s in ("fwd", "bwd")], gen, gpu)
    layout = graph.cache[f"gat_edges_{n}"][2]
    print(f"planetoid gat layout: {layout}", flush=True)
    for heads, width in ((8, 8), (1, c)):
        keep = None
        if heads == 8:
            keep = ((torch.rand(layout.num_edges, heads, generator=gen, device="cuda")
                     < PLANETOID_GAT_KEEP).float() / PLANETOID_GAT_KEEP)
        Q, K, V, dy = (torch.randn(n, heads * width, generator=gen, device="cuda")
                       for _ in range(4))
        tag = f"planetoid H={heads} d={width}"
        errs, calls, outs = _gat_case(layout, Q, K, V, dy, heads, keep, tag)
        rows += _gat_rows(layout, heads, width, torch.float32, keep, errs, calls, outs, True,
                          case=tag)
    print(f"planetoid gat kernel check (name H d keep: max_abs_err, ms (device), plain_ms, "
          f"...) on {gpu}")
    for r in rows:
        print(f"  {r['name']} H={r['heads']} d={r['width']} keep={r['keep']}: "
              f"{r['max_abs_err']:.3e}, {_gat_row_text(r)}; bound {r['bound_ms']:.4f} "
              f"({r['bound_by']})", flush=True)
    return rows


def planetoid_phase(gpu):
    """Phase 19: Planetoid-shaped node classification through the demo twins
    (``tf_geometric_tpu_torch/demos``) on the hard-mode Pubmed set (19,717
    nodes, 500 features, 3 classes), for the GCN and the GAT demo:
    ``PLANETOID_CHECK_STEPS`` Adam steps through the kernels and through
    their plain versions from the same weights and keep masks (losses
    within 1e-4) with exact launches a step; each kernel at the demo's
    shapes (``_planetoid_kernel_rows``); then ``train_node_classifier``'s
    full loop, ``PLANETOID_STEPS`` steps with the early stop (patience
    ``PLANETOID_PATIENCE``), with its ms a step (CUDA events over the loop,
    its evaluations included), edges/s, the stop step and test@best
    (printed, not gated) and exact launches; the card's busy time over
    ``PLANETOID_PROFILE_STEPS`` profiled training steps. Returns the kernel
    rows and the loop's launches by kernel, by model."""
    import numpy as np
    import torch
    from tf_geometric_tpu_torch.demos.demo_utils import (dropout_seed, train_node_classifier,
                                                         train_step)
    from tf_geometric_tpu_torch.nn.conv.gcn import compute_cache_key
    from tf_geometric_tpu_torch.ops import config as kernel_config
    from tf_geometric_tpu_torch.utils.profiling import device_time_by_kernel
    out = {}
    for name in ("gcn", "gat"):
        t0 = time.perf_counter()
        graph, splits, c, demo, build = _planetoid_problem(name)
        train_index = splits[0]
        y = graph.y.long()
        lr, l2 = demo.LEARNING_RATE, demo.L2_COEF
        print(f"planetoid {name}: HardCitationDataset({PLANETOID_NAME!r}, "
              f"seed={PLANETOID_SEED}, model={name!r}) built in "
              f"{time.perf_counter() - t0:.1f} s: {graph.x.shape[0]} nodes, "
              f"{graph.x.shape[1]} features, {c} classes, {graph.edge_index.shape[1]} edges; "
              f"splits {[int(s.shape[0]) for s in splits]}", flush=True)

        # kernels against plain versions, same weights and keep masks
        losses, per_step = {}, []
        masks = None
        for label in ("kernel", "plain"):
            model, forward = build()
            opt = torch.optim.Adam(model.parameters(), lr=lr)
            if masks is None:
                model.eval()
                with torch.no_grad():
                    forward(False, None)  # builds the cached layout the masks index
                gen = torch.Generator(device="cuda").manual_seed(dropout_seed(PLANETOID_SEED))
                masks = [_planetoid_masks(name, graph, model, gen)
                         for _ in range(PLANETOID_CHECK_STEPS)]
            steps = []
            with (kernel_config.use_plain_versions() if label == "plain"
                  else contextlib.nullcontext()):
                for m in masks:
                    _zero_launch_counts()
                    steps.append(train_step(model, opt, forward, y, train_index, l2, None, m))
                    torch.cuda.synchronize()
                    if label == "kernel":
                        per_step.append(dict(zip(_KERNELS, _launch_counts())))
            losses[label] = torch.stack(steps)
        err = _max_err(losses["kernel"], losses["plain"], F32_TOL,
                       f"planetoid {name} {PLANETOID_CHECK_STEPS}-step losses")
        want = dict.fromkeys(_KERNELS, 0)
        want.update(PLANETOID_STEP_LAUNCHES[name])
        _check(all(p == want for p in per_step),
               f"planetoid {name}: launches a step {per_step} != {want}")
        print(f"planetoid {name} kernel vs plain: {losses['kernel'].tolist()} / "
              f"{losses['plain'].tolist()}, max abs err {err:.3e}; launches a step "
              f"{PLANETOID_STEP_LAUNCHES[name]}", flush=True)

        rows = _planetoid_kernel_rows(name, graph, gpu)

        # the demo's full loop
        model, forward = build()
        stats = {}
        _zero_launch_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        test_acc = train_node_classifier(forward, model, y, splits, num_steps=PLANETOID_STEPS,
                                         learning_rate=lr, l2_coef=l2,
                                         patience=PLANETOID_PATIENCE, seed=PLANETOID_SEED,
                                         stats=stats)
        end.record()
        end.synchronize()
        counts = dict(zip(_KERNELS, _launch_counts()))
        steps = stats["steps"]
        want = dict.fromkeys(_KERNELS, 0)
        for k, v in PLANETOID_STEP_LAUNCHES[name].items():
            want[k] += v * steps
        for k, v in PLANETOID_EVAL_LAUNCHES[name].items():
            want[k] += v * steps  # eval_every 1: one evaluation a step
        _check(counts == want, f"planetoid {name} loop: launches {counts} != {want}")
        losses = torch.stack(stats["losses"]).tolist()
        _check(all(math.isfinite(v) for v in losses), f"planetoid {name}: non-finite loss")
        _check(losses[-1] < losses[0], f"planetoid {name}: loss did not fall: {losses[::20]}")
        loop_ms = start.elapsed_time(end)
        edges = (graph.cache[f"gat_edges_{graph.x.shape[0]}"][2].num_edges if name == "gat"
                 else graph.cache[compute_cache_key("both", True, True, True, False)
                                  + ":ell"].num_edges)

        # the card's busy time over training steps alone
        opt = torch.optim.Adam(model.parameters(), lr=lr)
        gen = torch.Generator(device="cuda").manual_seed(PLANETOID_SEED + 1)
        from torch.profiler import ProfilerActivity, profile
        train_step(model, opt, forward, y, train_index, l2, gen)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pstart, pend = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            pstart.record()
            for _ in range(PLANETOID_PROFILE_STEPS):
                train_step(model, opt, forward, y, train_index, l2, gen)
            pend.record()
            pend.synchronize()
        kernels = device_time_by_kernel(prof, PLANETOID_PROFILE_STEPS)
        busy_ms = sum(k[1] for k in kernels)
        span_ms = pstart.elapsed_time(pend) / PLANETOID_PROFILE_STEPS
        train_ms = _cuda_ms(lambda: train_step(model, opt, forward, y, train_index, l2, gen),
                            iters=20, warmup=2)
        print(f"planetoid {name}: {steps} steps (stop step {stats['stop_step']}), "
              f"{loop_ms / steps:.4f} ms/step over the loop with its evaluations (events), "
              f"{edges * steps / (loop_ms / 1e3):.1f} edges/s ({edges} edges a step); "
              f"a training step alone {train_ms:.4f} ms (events, 20 steps); profiled: device "
              f"busy {busy_ms:.4f} ms of a {span_ms:.4f} ms step span, idle share "
              f"{1 - busy_ms / span_ms:.4f} ({sum(k[2] for k in kernels):.0f} kernels a "
              f"step); best valid {stats['best_valid']:.4f}, test@best {test_acc:.4f} "
              f"(not gated); launches {counts} on {gpu}", flush=True)
        print(json.dumps({f"planetoid_{name}_top": [[k[0][:90], round(k[1], 5), k[2]]
                                                     for k in kernels[:8]]}), flush=True)
        out[name] = dict(rows=rows, launches=counts)
        del graph, model
        torch.cuda.empty_cache()
    return out


def planetoid_kernel_entries(res):
    """The ``{"kernels"}`` entries of the demo path: Kernel A at the GCN's
    F = 16 forward, the attention kernels at the GAT's first layer (H = 8,
    d = 8, keep mask 0.4); launches over each demo's full loop."""
    entries = []
    for name, model in (("csr_spmm", "gcn"), ("gat_forward", "gat"),
                        ("gat_backward_dst", "gat"), ("gat_backward_src", "gat")):
        rows = [r for r in res[model]["rows"] if r["name"] == name]
        launches = res[model]["launches"][name]
        _check(launches > 0, f"{name} was not launched on the planetoid {model} path")
        if name == "csr_spmm":
            rep = next(r for r in rows if r["side"] == "fwd" and r["width"] == 16)
            source = ("tf_geometric_tpu_torch/csrc/csr_spmm.cu",
                      "tf_geometric_tpu/ops/ell_bucketed.py:214")
            shape = "GCN demo on hard Pubmed: forward F=16, float32"
        else:
            rep = next(r for r in rows if r["heads"] == 8)
            source = ("tf_geometric_tpu_torch/csrc/gat_attention.cu",
                      "tf_geometric_tpu/ops/ell_attention_bucketed.py:933")
            shape = "GAT demo on hard Pubmed: H=8, d=8, keep mask 0.4, float32"
        entries.append({
            "name": f"planetoid:{name}", "route": "cuda", "source": source[0],
            "replaces": source[1], "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows), "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            "shape": shape + f"; launches over the demo's {PLANETOID_STEPS}-step loop"})
    return entries


# ---------------------------------------------------------------------------
# the accuracy head-to-head: the early-stop bench twins and the graph demo
# twins against the JAX package's committed results (phase 20)
# ---------------------------------------------------------------------------

H2H_CHECK_STEPS = 3
H2H_MODELS = ("gcn", "sgc", "appnp", "ssgc", "gat")
H2H_ARXIV_SEEDS, H2H_PROFILE_STEPS = 5, 5
# kernel launches of one training step and of one evaluation of each bench
# twin (counted on the CPU by tests/test_torch_bench_twins.py)
H2H_STEP_LAUNCHES = {"gcn": dict(csr_spmm=4), "sgc": dict(csr_spmm=4),
                     "appnp": dict(csr_spmm=20), "ssgc": dict(csr_spmm=20),
                     "gat": dict(spmm_heads=8, sddmm_heads=2)}
H2H_EVAL_LAUNCHES = {"gcn": dict(csr_spmm=2), "sgc": dict(csr_spmm=2),
                     "appnp": dict(csr_spmm=10), "ssgc": dict(csr_spmm=10),
                     "gat": dict(spmm_heads=4)}
# kernel launches of one training step of each graph demo twin on the
# check batch (the shared split's first padded batch; counted on the CPU by
# tests/test_torch_graph_demos.py)
H2H_GRAPH_STEP_LAUNCHES = {"mean_pool": dict(spmm_heads=8), "gin": dict(spmm_heads=10),
                           "sag_pool": dict(spmm_heads=16), "sort_pool": dict(spmm_heads=8),
                           "diff_pool": dict(spmm_heads=16, sddmm_heads=2),
                           "min_cut_pool": dict(spmm_heads=12)}


def _h2h_kernel_vs_plain(label, build, step, want_launches):
    """``H2H_CHECK_STEPS`` steps ``step(model, optimizer, generator) ->
    loss`` through the kernels and then through their plain versions
    (``use_plain_versions``), each side from ``build() -> (model,
    optimizer)`` (the same weights) and a generator seeded alike (the same
    dropout draws): the losses within 1e-4, and ``want_launches`` kernel
    launches in each kernel step. Returns the largest loss difference."""
    import torch
    from tf_geometric_tpu_torch.ops import config as kernel_config
    losses, per_step = {}, []
    for side in ("kernel", "plain"):
        model, opt = build()
        gen = torch.Generator(device="cuda").manual_seed(20)
        steps = []
        with (kernel_config.use_plain_versions() if side == "plain"
              else contextlib.nullcontext()):
            for _ in range(H2H_CHECK_STEPS):
                _zero_launch_counts()
                steps.append(step(model, opt, gen))
                torch.cuda.synchronize()
                if side == "kernel":
                    per_step.append(dict(zip(_KERNELS, _launch_counts())))
        losses[side] = torch.stack(steps)
    err = _max_err(losses["kernel"], losses["plain"], F32_TOL,
                   f"{label} {H2H_CHECK_STEPS}-step losses")
    want = dict.fromkeys(_KERNELS, 0)
    want.update(want_launches)
    _check(all(p == want for p in per_step), f"{label}: launches a step {per_step} != {want}")
    print(f"{label} kernel vs plain: {losses['kernel'].tolist()} / "
          f"{losses['plain'].tolist()}, max abs err {err:.3e}; launches a step "
          f"{want_launches}", flush=True)
    return err


def _h2h_node_check(model, shape, data):
    """The bench twin ``model`` on ``data`` (its ``shape`` protocol):
    kernel against plain, ``_h2h_kernel_vs_plain``."""
    import torch
    from tf_geometric_tpu_torch.benchmarks.node_classification import head_to_head_port as h2h
    from tf_geometric_tpu_torch.demos.demo_utils import train_step
    twin = h2h.twin(model)
    graph, splits = data
    y, l2 = graph.y.long(), twin.protocol(shape)["l2"]
    built = {}

    def build():
        net, forward = twin.build(graph, 0, shape, "cuda")
        built["forward"] = forward
        return net, torch.optim.Adam(net.parameters(), lr=twin.LEARNING_RATE)

    def step(net, opt, gen):
        return train_step(net, opt, lambda training, g: built["forward"](training, g), y,
                          splits[0], l2, gen)

    return _h2h_kernel_vs_plain(f"h2h {model}_{shape}", build, step, H2H_STEP_LAUNCHES[model])


def _h2h_evaluations(steps, eval_every, log_every=20):
    """Evaluations ``train_node_classifier`` runs in ``steps`` steps with an
    early stop: every ``eval_every``-th step and the last, and each logged
    step besides."""
    return sum(1 for s in range(steps) if (s + 1) % eval_every == 0 or s % log_every == 0
               or s == steps - 1)


def _h2h_full_run(model, shape, data, seed, gpu, profile=False):
    """One full ``run(seed)`` of bench twin ``model`` on ``data``: test@best,
    ms a step over the loop with its evaluations (CUDA events), the stop
    step, exact launches; with ``profile``, the card's busy time and idle
    share over ``H2H_PROFILE_STEPS`` profiled training steps after it."""
    import torch
    from tf_geometric_tpu_torch.benchmarks.node_classification import head_to_head_port as h2h
    from tf_geometric_tpu_torch.demos.demo_utils import train_step
    from tf_geometric_tpu_torch.utils.profiling import device_time_by_kernel
    twin, stats = h2h.twin(model), {}
    proto = twin.protocol(shape)
    _zero_launch_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    acc = twin.run(seed, device="cuda", dataset=shape, data=data, stats=stats)
    end.record()
    end.synchronize()
    counts = dict(zip(_KERNELS, _launch_counts()))
    steps = stats["steps"]
    evals = _h2h_evaluations(steps, proto["eval_every"])
    want = dict.fromkeys(_KERNELS, 0)
    for k, v in H2H_STEP_LAUNCHES[model].items():
        want[k] += v * steps
    for k, v in H2H_EVAL_LAUNCHES[model].items():
        want[k] += v * evals
    _check(counts == want, f"h2h {model}_{shape} seed {seed}: launches {counts} != {want}")
    losses = torch.stack(stats["losses"]).tolist()
    _check(all(math.isfinite(v) for v in losses), f"h2h {model}_{shape}: non-finite loss")
    out = dict(acc=float(acc), steps=steps, stop_step=stats["stop_step"],
               ms_per_step=start.elapsed_time(end) / steps, launches=counts, evals=evals)
    if profile:
        graph, splits = data
        net, forward = twin.build(graph, seed, shape, "cuda")
        opt = torch.optim.Adam(net.parameters(), lr=twin.LEARNING_RATE)
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        y, l2 = graph.y.long(), proto["l2"]

        def one():
            train_step(net, opt, lambda training, g: forward(training, g), y, splits[0], l2, gen)

        one()
        torch.cuda.synchronize()
        from torch.profiler import ProfilerActivity, profile as tprofile
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pstart, pend = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            pstart.record()
            for _ in range(H2H_PROFILE_STEPS):
                one()
            pend.record()
            pend.synchronize()
        kernels = device_time_by_kernel(prof, H2H_PROFILE_STEPS)
        busy = sum(k[1] for k in kernels)
        span = pstart.elapsed_time(pend) / H2H_PROFILE_STEPS
        out.update(busy_ms=busy, span_ms=span, idle_share=1 - busy / span,
                   top=[[k[0][:90], round(k[1], 5), k[2]] for k in kernels[:6]])
    return out


def _h2h_graph_check(name, split):
    """Graph demo twin ``name`` on the check batch: kernel against plain
    (``_h2h_kernel_vs_plain``), the model drawing its own dropout."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from tf_geometric_tpu_torch.benchmarks.graph_classification import \
        head_to_head_graph_port as gh2h
    from tf_geometric_tpu_torch.demos.demo_utils import padded_batch_generator
    train = split[0]
    batch, real = next(padded_batch_generator(train, gh2h.BATCH, seed=0))
    args = tuple(torch.as_tensor(np.asarray(a), device="cuda")
                 for a in (batch.x, batch.edge_index, batch.edge_weight, batch.node_graph_index))
    y = torch.as_tensor(np.asarray(batch.y).flatten()[:real], device="cuda").long()
    make, lr, aux = gh2h.make_model(name, train[0].x.shape[1], 0, "cuda")

    def build():
        net = make(2, gh2h.BATCH)
        return net, torch.optim.Adam(net.parameters(), lr=lr)

    def step(net, opt, gen):
        net.train()
        opt.zero_grad(set_to_none=True)
        out = net(*args)
        logits = out[0] if aux else out
        loss = F.cross_entropy(logits[:real], y)
        if aux:
            loss = loss + aux(out[1])
        loss.backward()
        opt.step()
        return loss.detach()

    return _h2h_kernel_vs_plain(f"h2h graph {name}", build, step, H2H_GRAPH_STEP_LAUNCHES[name])


def head_to_head_phase(gpu):
    """Phase 20: the accuracy head-to-head's models on the card. (1) Each
    bench twin on its hard-cora graph, and the GAT twin's pubmed
    architecture on hard pubmed: ``H2H_CHECK_STEPS`` Adam steps through the
    kernels and through their plain versions, the same weights and draws
    (losses within 1e-4), exact launches a step. (2) Each twin's full
    ``run(seed=0)`` on hard cora: test@best beside JAX's committed mean,
    ms a step, stop step, exact launches. (3) The arxiv hard cell: the GCN
    (hidden 64) and SGC twins, seeds 0-4 under the 100-step protocol,
    test@best, ms a step, the card's idle share over ``H2H_PROFILE_STEPS``
    profiled steps, each mean gated against JAX's committed results by
    ``head_to_head_port.gate``. (4) Kernel A at the arxiv cell's widths and
    the multi-head SpMM / SDDMM at the GAT twin's, against plain versions
    and the library. (5) Each graph demo twin: kernel against plain on one
    batch, then one 300-step run. Returns the kernel rows and launches."""
    import torch
    from tf_geometric_tpu_torch.benchmarks.graph_classification import \
        head_to_head_graph_port as gh2h
    from tf_geometric_tpu_torch.benchmarks.node_classification import head_to_head_port as h2h
    out = {"rows": [], "launches": dict.fromkeys(_KERNELS, 0), "runs": {}}

    def add(launches):
        for k, v in launches.items():
            out["launches"][k] += v

    cache = {}
    for model in H2H_MODELS:
        _h2h_node_check(model, "cora", h2h.cell_data(model, "cora", "cuda", cache))
    pubmed = h2h.cell_data("gat", "pubmed", "cuda")
    _h2h_node_check("gat", "pubmed", pubmed)
    layouts = {}
    for shape, data in (("cora", h2h.cell_data("gat", "cora", "cuda", cache)),
                        ("pubmed", pubmed)):
        graph = data[0]
        layouts[shape] = graph.cache[f"gat_edges_{graph.x.shape[0]}"][2]
    print(f"h2h: {len(cache)} hard cora graph(s) and hard pubmed (gat) built", flush=True)

    print(f"h2h full runs on hard cora, seed 0 (test@best against JAX's committed mean; "
          f"ms/step with the evaluations, CUDA events) on {gpu}", flush=True)
    for model in H2H_MODELS:
        r = _h2h_full_run(model, "cora", h2h.cell_data(model, "cora", "cuda", cache), 0, gpu)
        add(r["launches"])
        jax = h2h.jax_results(f"{model}_cora")
        out["runs"][f"{model}_cora"] = r
        print(f"  {model}_cora: test@best {r['acc']:.4f} (JAX mean {sum(jax) / len(jax):.4f} "
              f"over {len(jax)} seeds), {r['steps']} steps (stop step {r['stop_step']}), "
              f"{r['ms_per_step']:.4f} ms/step, launches "
              f"{ {k: v for k, v in r['launches'].items() if v} }", flush=True)
    del cache, pubmed
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    arxiv = h2h.cell_data("gcn", "arxiv", "cuda")
    graph = arxiv[0]
    print(f"h2h arxiv: HardCitationDataset('arxiv', seed=0) built and moved in "
          f"{time.perf_counter() - t0:.1f} s: {graph.x.shape[0]} nodes, {graph.x.shape[1]} "
          f"features, {int(graph.y.max()) + 1} classes, {graph.edge_index.shape[1]} edge-index "
          f"entries; splits {[int(s.shape[0]) for s in arxiv[1]]}", flush=True)
    for model in ("gcn", "sgc"):
        runs = [_h2h_full_run(model, "arxiv", arxiv, seed, gpu, profile=seed == 0)
                for seed in range(H2H_ARXIV_SEEDS)]
        for r in runs:
            add(r["launches"])
        accs = [r["acc"] for r in runs]
        jax = h2h.jax_results(f"{model}_arxiv")
        g = h2h.gate(jax, accs)
        out["runs"][f"{model}_arxiv"] = dict(accs=accs, gate=g, profile=runs[0])
        p = runs[0]
        print(f"h2h {model}_arxiv: test@best {[round(a, 4) for a in accs]}, mean "
              f"{g['port_mean']:.4f} against JAX's {g['jax_mean']:.4f} (n={len(jax)}), bounds "
              f"[{g['lower']:.4f}, {g['upper']:.4f}]; ms/step "
              f"{[round(r['ms_per_step'], 4) for r in runs]} (evaluations every 2 steps "
              f"included); steps {[r['steps'] for r in runs]}; profiled training step: device "
              f"busy {p['busy_ms']:.4f} ms of {p['span_ms']:.4f} ms, idle share "
              f"{p['idle_share']:.4f}; top {p['top'][:3]} on {gpu}", flush=True)
        _check(g["ok"], f"h2h {model}_arxiv fails the gate: {g['failed']}")
    gen = torch.Generator(device="cuda").manual_seed(20)
    out["rows"] += _normed_csr_rows("h2h arxiv", graph, [("fwd", 64), ("bwd", 64),
                                                          ("fwd", 40), ("bwd", 40),
                                                          ("fwd", 128)], gen, gpu)
    del arxiv, graph
    torch.cuda.empty_cache()
    out["rows"] += multihead_kernel_phase(layouts["cora"], ((8, 8), (1, 7)), "h2h gat cora",
                                          bf16=False, keep=0.3)
    out["rows"] += multihead_kernel_phase(layouts["pubmed"], ((1, 64), (8, 3)),
                                          "h2h gat pubmed", bf16=False)
    del layouts

    split = gh2h.shared_split()
    print(f"h2h graph demo twins: {len(split[0])} training and {len(split[1])} test graphs; "
          f"{gh2h.STEPS} steps at batch {gh2h.BATCH} on {gpu}", flush=True)
    for name in gh2h.MODELS:
        _h2h_graph_check(name, split)
        stats = {}
        _zero_launch_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        acc = gh2h.run(name, 0, split, "cuda", stats)
        end.record()
        end.synchronize()
        counts = dict(zip(_KERNELS, _launch_counts()))
        add(counts)
        losses = torch.stack(stats["losses"]).tolist()
        _check(all(math.isfinite(v) for v in losses), f"h2h graph {name}: non-finite loss")
        jax = gh2h.jax_results(name)
        out["runs"][name] = dict(acc=acc, ms_per_step=start.elapsed_time(end) / gh2h.STEPS)
        print(f"  {name}: test accuracy {acc:.4f} (JAX mean {sum(jax) / len(jax):.4f} over "
              f"{len(jax)} seeds), {start.elapsed_time(end) / gh2h.STEPS:.4f} ms/step over the "
              f"loop with its test pass, launches { {k: v for k, v in counts.items() if v} }",
              flush=True)
    return out


def head_to_head_kernel_entries(res):
    """The ``{"kernels"}`` entries of the head-to-head path: Kernel A at the
    arxiv GCN's first layer (F = 64, forward), the multi-head SpMM and SDDMM
    at the cora GAT twin's first layer (H = 8, d_v = 8, keep 0.3); launches
    over phase 20's full runs."""
    entries = []
    picks = (("csr_spmm", dict(side="fwd", width=64), "tf_geometric_tpu_torch/csrc/csr_spmm.cu",
              "tf_geometric_tpu/ops/ell_bucketed.py:214",
              "GCN twin on the hard arxiv cell: forward F=64, float32"),
             ("spmm_heads", dict(case="h2h gat cora forward", heads=8),
              "tf_geometric_tpu_torch/csrc/spmm_heads.cu", "tf_geometric_tpu/ops/ell.py:325",
              "GAT twin on hard cora, layer 1: H=8, d_v=8, keep 0.3, float32"),
             ("sddmm_heads", dict(case="h2h gat cora d_att", heads=8),
              "tf_geometric_tpu_torch/csrc/spmm_heads.cu", "tf_geometric_tpu/ops/ell.py:325",
              "GAT twin on hard cora, layer 1: d_att, H=8, d_v=8, float32"))
    for name, key, source, replaces, shape in picks:
        rows = [r for r in res["rows"] if r["name"] == name]
        rep = next(r for r in rows if all(r.get(k) == v for k, v in key.items()))
        launches = res["launches"][name]
        _check(launches > 0, f"{name} was not launched on the head-to-head path")
        entries.append({
            "name": f"h2h:{name}", "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            "shape": shape + "; launches over phase 20's full runs"})
    return entries


# ---------------------------------------------------------------------------
# hierarchical pooling (workloads 14-16, ASAP, Set2Set)
# ---------------------------------------------------------------------------

def _pooled_adjacency(graph_problem):
    """Workload 14's second-level adjacency at its initial weights, as its
    GCNs take it: level 0's DiffPool on the batch (8 clusters a graph), its
    G·C² pooled edges normalized with the self-loops added."""
    import torch
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch import nn as tnn
    from tf_geometric_tpu_torch.sparse import SparseMatrix
    pr = graph_problem
    p = bench.init_pool_params(pr, "diff_pool")
    n = pr.x.shape[0]
    adj = SparseMatrix(pr.edge_index, pr.edge_weight, (n, n))
    with torch.no_grad():
        h = tnn.gcn(pr.x, adj, p["feature_gnn_0.kernel"], p["feature_gnn_0.bias"],
                    activation=torch.relu)
        s = torch.softmax(tnn.gcn(pr.x, adj, p["assign_gnn_0.kernel"],
                                  p["assign_gnn_0.bias"]), dim=-1)
        _, ei, ew, _ = tnn.diff_pool_coarsen(h, pr.edge_index, pr.edge_weight,
                                             pr.node_graph_index, s, num_graphs=pr.num_graphs)
    m = pr.num_graphs * bench.DIFF_POOL_CLUSTERS[0]
    return tnn.gcn_norm_adj(SparseMatrix(ei, ew, (m, m)))


def pool_kernel_phase(graph_problem):
    """X6 on workload 14's pooled graph (1,024 rows, 8,192 pooled edges and
    1,024 self-loops, every row 9 entries): the forward and ``dh`` SpMM at
    the feature GCN's width 32 and ``dv`` at 32 and at the assign GCN's 4,
    float32, against their plain versions (1e-4) and a second run (bit for
    bit), ``dv`` also against ``torch.sparse.sampled_addmm`` (1e-4); each
    timed by events and device time beside its bound, its plain version
    and the library call. Returns one row per call."""
    import torch
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch.ops import spmm_heads as sh
    normed = _pooled_adjacency(graph_problem)
    n, index = normed.shape[0], normed.index
    w = normed.value.float()[:, None].contiguous()
    fwd = sh.build_csr_view(index[0], index[1], n, n)
    bwd = sh.build_csr_view(index[1], index[0], n, n)
    nnz = int(fwd.row_ptr[-1])
    degrees = (fwd.row_ptr[1:] - fwd.row_ptr[:-1]).long()
    _check(nnz == index.shape[1] and bool((degrees == degrees[0]).all()),
           f"pooled graph: {nnz} of {index.shape[1]} entries stored, row lengths "
           f"{int(degrees.min())}-{int(degrees.max())}")
    print(f"pool x6: workload 14's pooled graph, {n} rows, {nnz} entries, {int(degrees[0])} a "
          f"row; {_view_walk_line(fwd)}", flush=True)
    lib_fwd, lib_bwd = _x6_library(fwd, w[:, 0], n, n), _x6_library(bwd, w[:, 0], n, n)
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = []
    for width in (bench.POOL_UNITS, bench.DIFF_POOL_CLUSTERS[1]):
        h, dy = (torch.randn(n, width, generator=gen, device="cuda") for _ in range(2))
        cases = [("sddmm_heads", "pool dv", lambda: sh.launch_sddmm_heads(
                      fwd, dy, h, 1, torch.zeros_like(w)),
                  lambda: sh.sddmm_heads_plain(fwd, dy, h, 1, torch.zeros_like(w)),
                  lambda: torch.sparse.sampled_addmm(lib_fwd, dy, h.t(), beta=0.0),
                  sh.sddmm_pass_bytes(nnz, n, n, width, 1, 4))]
        if width == bench.POOL_UNITS:
            cases += [("spmm_heads", "pool forward", lambda: sh.launch_spmm_heads(fwd, w, h, 1),
                       lambda: sh.spmm_heads_plain(fwd, w, h, 1),
                       lambda: torch.sparse.mm(lib_fwd, h),
                       sh.spmm_pass_bytes(nnz, n, n, width, 1, 4, 4)),
                      ("spmm_heads", "pool dh", lambda: sh.launch_spmm_heads(bwd, w, dy, 1),
                       lambda: sh.spmm_heads_plain(bwd, w, dy, 1),
                       lambda: torch.sparse.mm(lib_bwd, dy),
                       sh.spmm_pass_bytes(nnz, n, n, width, 1, 4, 4))]
        for name, case, kernel, plain, library, nbytes in cases:
            tag = f"{name} {case} F={width}"
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = _max_err(got, want, F32_TOL, tag)
            _check(torch.equal(got, kernel()), f"{tag}: two runs on the same inputs differ")
            lib_out = library()
            if name == "sddmm_heads":
                lib_out = _sampled_by_entry(fwd, lib_out, n)
                got = got[fwd.eid[:nnz].long(), 0]
            err = max(err, _max_err(got, lib_out, F32_TOL, f"{tag} vs the library call"))
            bound_ms, bound_by = _bound(nbytes, sh.pass_flops(nnz, width))
            rows.append(dict(name=name, case=case, width=width, dtype="float32", heads=1,
                             max_abs_err=err, ms=_cuda_ms(kernel),
                             plain_ms=_cuda_ms(plain, iters=3, warmup=1),
                             library_ms=_cuda_ms(library), bound_ms=bound_ms,
                             bound_by=bound_by, device_ms=_device_ms(kernel),
                             library_device_ms=_device_ms(library)))
    print("pool x6 kernel check (name case F: max_abs_err, ms, plain_ms, library_ms, bound_ms; "
          "device ms under the profiler)")
    for r in rows:
        print(f"  {r['name']} {r['case']} F={r['width']}: {r['max_abs_err']:.3e}, "
              f"{r['ms']:.4f}, {r['plain_ms']:.4f}, {r['library_ms']:.4f}, "
              f"{r['bound_ms']:.4f} ({r['bound_by']}){_device_note(r)}", flush=True)
    return rows


def pool_profile_phase(graph_problem, results, gpu):
    """Workloads 14-16 under ``torch.profiler`` (``bench.profile_workload``:
    the device's busy time and idle share per step), beside their timed
    runs of the main path."""
    from tf_geometric_tpu_torch import bench
    for name in bench.POOL_WORKLOADS:
        prof = bench.profile_workload(graph_problem, name)
        res = results[name]
        print(f"{name}: {res['step_ms']:.4f} ms/step, {res['line']['value']} graphs/s, "
              f"vs_baseline {res['line']['vs_baseline']}; profiled {prof['step_ms']:.4f} "
              f"ms/step, device busy {prof['device_busy_ms']:.4f} ms, idle share "
              f"{prof['device_idle_share']:.4f}, {prof['kernels_per_step']} kernels a step "
              f"on {gpu}", flush=True)
        print(json.dumps(prof), flush=True)


def _pool_kernel_vs_plain(problem, name, what):
    """3 Adam steps of pool model ``name`` through the kernels and through
    the plain versions on the card (the same dropout masks): the losses
    within 1e-4, the kernel run launching the COO SpMM, the plain run
    nothing."""
    import torch
    from tf_geometric_tpu_torch import bench
    losses = {}
    for label in ("kernel", "plain"):
        _zero_launch_counts()
        with (_plain() if label == "plain" else contextlib.nullcontext()):
            step = bench.make_step(lambda p: bench.pool_loss(p, problem, name),
                                   bench.init_pool_params(problem, name), bench.POOL_LR)
            losses[label] = torch.stack([step() for _ in range(3)])
        counts = dict(zip(_KERNELS, _launch_counts()))
        if label == "kernel":
            _check(counts["spmm_heads"] > 0, f"{what}: spmm_heads was not launched")
        else:
            _check(sum(counts.values()) == 0, f"{what} plain run launched {counts}")
    err = _max_err(losses["kernel"], losses["plain"], F32_TOL, f"3-step losses {what}")
    print(f"{what}: kernel {losses['kernel'].tolist()} plain {losses['plain'].tolist()} max abs "
          f"err {err:.3e}", flush=True)


def pool_small_phase(graph_problem):
    """ASAP (the demo's batch of 16 graphs, k = 8, fixed mode) and Set2Set
    (the 128-graph batch) train 3 steps kernel against plain; ASAP's
    pooling at k = 16 on the 16-graph batch, where graphs of 10-15 nodes
    leave slots invalid (its reverse map's spare entry, cluster_pool's
    dropped assignment edges), kernel against plain; then a batch of
    graphs with SparseMatrix features (``BatchGraph.from_graphs``, one-hot
    rows) through ``gcn``, whose sparse ``x @ W`` is X6 too, against the
    plain versions and the dense features."""
    import torch
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch import nn as tnn
    from tf_geometric_tpu_torch.data import BatchGraph, Graph
    from tf_geometric_tpu_torch.datasets import synthetic_graph_classification
    from tf_geometric_tpu_torch.sparse import SparseMatrix
    asap_problem = bench.build_graph_problem(batch=bench.ASAP_BATCH, device="cuda")
    _pool_kernel_vs_plain(asap_problem, "asap", f"ASAP ({bench.ASAP_BATCH} graphs, "
                                                f"k={bench.ASAP_K})")
    _pool_kernel_vs_plain(graph_problem, "set2set", f"Set2Set ({graph_problem.num_graphs} graphs)")

    pr, k = asap_problem, 2 * bench.ASAP_K
    p = bench.init_pool_params(pr, "asap")
    # the layer's 12 tensors in its order, which is asap's
    params = [v for key, v in p.items() if key.startswith("ASAP_0.")]
    n = pr.x.shape[0]
    outs = {}
    for label in ("kernel", "plain"):
        _zero_launch_counts()
        with torch.no_grad(), (_plain() if label == "plain" else contextlib.nullcontext()):
            h = tnn.gcn(pr.x, SparseMatrix(pr.edge_index, pr.edge_weight, (n, n)),
                        p["GCN_0.kernel"], p["GCN_0.bias"], activation=torch.relu)
            outs[label] = tnn.asap(h, pr.edge_index, pr.edge_weight, pr.node_graph_index,
                                   *params, k=k, num_graphs=pr.num_graphs)
        if label == "kernel":
            _check(_launch_counts()[_KERNELS.index("spmm_heads")] > 0,
                   "ASAP k=16: spmm_heads was not launched")
    invalid = int((outs["kernel"][3] == pr.num_graphs).sum())
    _check(invalid > 0, "ASAP k=16: no invalid slot")
    for i, (a, b) in enumerate(zip(outs["kernel"], outs["plain"])):
        if a.is_floating_point():
            _max_err(a, b, F32_TOL, f"ASAP k=16 output {i}")
        else:
            _check(torch.equal(a, b), f"ASAP k=16 output {i}: kernel and plain differ")
    print(f"ASAP k={k} ({pr.num_graphs} graphs): {invalid} of {outs['kernel'][3].shape[0]} "
          f"cluster slots invalid, {outs['kernel'][1].shape[1]} pooled edges; kernel = plain",
          flush=True)

    graphs = synthetic_graph_classification()[0][:bench.ASAP_BATCH]
    dense = BatchGraph.from_graphs(graphs)
    batch = BatchGraph.from_graphs([Graph(SparseMatrix.from_dense(
        torch.as_tensor(g.x, device="cuda")), g.edge_index, g.y) for g in graphs])
    _check(isinstance(batch.x, SparseMatrix) and torch.equal(
        batch.x.to_dense().cpu(), torch.as_tensor(dense.x)), "sparse batch features differ")
    kernel = torch.randn(dense.x.shape[1], bench.POOL_UNITS,
                         generator=torch.Generator(device="cuda").manual_seed(9), device="cuda")
    adj = batch.adj(device="cuda")
    _zero_launch_counts()
    got = tnn.gcn(batch.x, adj, kernel)
    launches = _launch_counts()[_KERNELS.index("spmm_heads")]
    _check(launches == 2 * 2, f"sparse-feature gcn: {launches} spmm_heads launches != 4")
    with _plain():
        want = tnn.gcn(batch.x, adj, kernel)
    err = max(_max_err(got, want, F32_TOL, "sparse-feature gcn vs plain"),
              _max_err(got, tnn.gcn(torch.as_tensor(dense.x, device="cuda"), adj, kernel),
                       F32_TOL, "sparse-feature gcn vs dense features"))
    print(f"sparse features: {batch.x.nnz} entries over {batch.num_nodes} nodes, gcn "
          f"{tuple(got.shape)}, {launches} spmm_heads launches, max abs err {err:.3e}",
          flush=True)


def pool_kernel_entries(pool_rows, results):
    """The ``{"kernels"}`` entries of X6 on the pooling path: the SpMM at
    the pooled graph's forward (F = 32) and ``dv`` at F = 32, launches over
    workloads 14-16 of the main path."""
    from tf_geometric_tpu_torch import bench
    launches = {k: sum(results[w]["launches"][k] for w in bench.POOL_WORKLOADS)
                for k in ("spmm_heads", "sddmm_heads")}
    entries = []
    for name, case, replaces in (("spmm_heads", "pool forward", "tf_geometric_tpu/ops/spmm.py:67"),
                                 ("sddmm_heads", "pool dv", "tf_geometric_tpu/ops/spmm.py:80")):
        _check(launches[name] > 0, f"{name} was not launched on the pooling path")
        mine = [r for r in pool_rows if r["name"] == name]
        rep = next(r for r in mine if r["case"] == case and r["width"] == bench.POOL_UNITS)
        entries.append({
            "name": f"pool:{name}", "route": "cuda",
            "source": "tf_geometric_tpu_torch/csrc/spmm_heads.cu", "replaces": replaces,
            "launches": launches[name], "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            "shape": "workload 14's pooled graph: 1,024 rows, 9,216 entries, F=32, float32; "
                     "launches over workloads 14-16"})
    return entries


# every kernel wrapper of the main path, in the order of the counts below
_KERNELS = ("csr_spmm", "sorted_segment_sum", "gat_forward", "gat_backward_dst",
            "gat_backward_src", "fixed_k_draw", "fixed_k_forward", "fixed_k_backward",
            "spmm_heads", "sddmm_heads", "tiled_spmm")


def _wrappers():
    from tf_geometric_tpu_torch.ops import fixed_k as fk
    from tf_geometric_tpu_torch.ops import gat_attention as ga
    from tf_geometric_tpu_torch.ops import spmm_heads as sh
    from tf_geometric_tpu_torch.ops.csr_spmm import launch_csr_spmm
    from tf_geometric_tpu_torch.ops.sorted_segment import launch_sorted_segment_sum
    from tf_geometric_tpu_torch.ops.tiled_spmm import launch_tiled_spmm
    return (launch_csr_spmm, launch_sorted_segment_sum, ga.launch_gat_forward,
            ga.launch_gat_backward_dst, ga.launch_gat_backward_src, fk.launch_draw_fixed_k,
            fk.launch_fixed_k_forward, fk.launch_fixed_k_backward, sh.launch_spmm_heads,
            sh.launch_sddmm_heads, launch_tiled_spmm)


def _launch_counts():
    return [w.launches for w in _wrappers()]


def _zero_launch_counts():
    from tf_geometric_tpu_torch.ops import fixed_k as fk
    for w in _wrappers():
        w.launches = 0
    fk.launch_fixed_k_backward.calls = 0


def main_path_phase(gpu, sage_problem, graph_problem, host_sage_problem):
    """Workloads 1, 1b, 3, 5 and 10-12 (SGC, APPNP, SSGC) at full arxiv
    size, 4 (SAGE) and 18 (SAGE on host draws) at full Reddit size, 6 and 7
    (GIN) and 14-16 (DiffPool, MinCutPool, SAGPool) on the benchmark's
    batch through the kernels;
    returns the launch totals of the run and the bench results, each with
    its own launches."""
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch.ops import fixed_k as fk
    from tf_geometric_tpu_torch.ops import spmm_heads as sh
    _zero_launch_counts()
    problem = bench.build_problem(device="cuda")
    adj = problem.adj
    # the precompute P = Â·x is one forward product: one launch, hub merge
    # included
    expected = [1] + [0] * (len(_KERNELS) - 1)
    _check(_launch_counts() == expected,
           f"precompute launches {_launch_counts()} != {expected}")
    totals = _launch_counts()
    results = {}
    problems = {"arxiv": problem, "reddit": sage_problem, "graphs": graph_problem,
                "reddit_host": host_sage_problem}
    for name, wl in bench.WORKLOADS.items():
        _zero_launch_counts()
        res = bench.run_workload(problems[wl.problem], name)
        counts = _launch_counts()
        steps = res["steps_taken"]
        expected = dict.fromkeys(_KERNELS, 0)
        if name in bench.SPMM_PAIRS:
            # per step and SpMM: Kernel A forward + backward, each merging its
            # side's hubs in its own launch (no Kernel B)
            spmms = bench.SPMM_PAIRS[name]
            expected.update(csr_spmm=steps * spmms * 2)
        elif name == "gat_merged_arxiv_fwd_bwd":
            # per step: the multi-head SpMM forward and dV (each its chunks'
            # and its rows' launch), the d_att SDDMM
            layout = problem.gat_layout
            expected.update(spmm_heads=steps * (sh.spmm_heads_launches(layout.dst.nbr.shape[0])
                                                + sh.spmm_heads_launches(layout.src.nbr.shape[0])),
                            sddmm_heads=steps)
        elif wl.problem == "arxiv":
            # per step: one forward and two backward attention launches (hub
            # rows are blocks of the same launches)
            expected.update(gat_forward=steps, gat_backward_dst=steps, gat_backward_src=steps)
        elif name in bench.POOL_WORKLOADS:
            # per step and GCN: the forward SpMM and dh, each its chunks' and
            # its rows' launch; dv where the values need a gradient
            # (DiffPool's second level)
            calls = bench.pool_x6_calls(graph_problem, bench.POOL_WORKLOADS[name])
            expected.update(spmm_heads=steps * sum(2 * sh.spmm_heads_launches(c[0])
                                                   for c in calls),
                            sddmm_heads=steps * sum(c[4] for c in calls))
        elif wl.problem == "graphs":
            # per step: each GIN layer's forward SpMM, dh for layers 2 and 3
            # (layer 1's input is data); the values are constants: no dv
            layers = bench.GIN_LAYERS
            per_call = sh.spmm_heads_launches(graph_problem.edge_index.shape[1])
            expected.update(spmm_heads=steps * (2 * layers - 1) * per_call)
        elif wl.problem == "reddit_host":
            # per step and layer: the draw is the host's; one aggregation
            # forward, one backward call
            layers = len(host_sage_problem.fanouts)
            per_call = fk.fixed_k_backward_launches(host_sage_problem.x.shape[0])
            expected.update(fixed_k_forward=steps * layers,
                            fixed_k_backward=steps * layers * per_call)
            calls = fk.launch_fixed_k_backward.calls
            _check(calls == steps * layers,
                   f"{name}: {calls} backward calls != expected {steps * layers}")
        else:
            # per step and layer: one draw, one aggregation forward, one
            # backward call (its sort's launches and the gather)
            layers = len(sage_problem.fanouts)
            per_call = fk.fixed_k_backward_launches(sage_problem.sampler.num_nodes)
            expected.update(fixed_k_draw=steps * layers, fixed_k_forward=steps * layers,
                            fixed_k_backward=steps * layers * per_call)
            calls = fk.launch_fixed_k_backward.calls
            _check(calls == steps * layers,
                   f"{name}: {calls} backward calls != expected {steps * layers}")
        expected = list(expected.values())
        _check(counts == expected, f"{name}: launches {counts} != expected {expected}")
        if wl.problem == "graphs":
            print(json.dumps({"workload": name,
                              **bench.gin_edge_rates(graph_problem, res["step_ms"])}), flush=True)
        elif wl.problem == "reddit_host":
            rates = bench.host_sage_rates(host_sage_problem,
                                          res["steps_taken"] - bench.WARMUP_STEPS)
            res["host"] = rates
            print(json.dumps({"workload": name, **rates}), flush=True)
        losses = res["losses"]
        _check(all(math.isfinite(v) for v in losses), f"{name}: non-finite loss {losses}")
        _check(losses[-1] < losses[0], f"{name}: loss did not fall: {losses}")
        totals = [t + c for t, c in zip(totals, counts)]
        res["launches"] = dict(zip(_KERNELS, counts))
        results[name] = res
        print(f"{name}: step {res['step_ms']:.4f} ms, {res['line']['value']} "
              f"{res['line']['unit']}, "
              f"vs_baseline {res['line']['vs_baseline']}, loss {losses[0]:.5f} -> "
              f"{losses[-1]:.5f}, launches {dict(zip(_KERNELS, counts))} on {gpu}", flush=True)
        print(json.dumps(res["line"]), flush=True)
    return totals, results


def _kernel_vs_plain_losses(wl, problem, spmm_bf16, tol, what):
    import torch
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch.ops import config as kernel_config
    losses = {}
    for label in ("kernel", "plain"):
        step = bench.make_step(lambda p: wl.loss(p, problem, spmm_bf16), wl.init(problem),
                               wl.lr)
        with (kernel_config.use_plain_versions() if label == "plain"
              else contextlib.nullcontext()):
            losses[label] = torch.stack([step() for _ in range(3)])
    err = _max_err(losses["kernel"], losses["plain"], tol, f"3-step losses {what}")
    print(f"small {what}: kernel {losses['kernel'].tolist()} plain "
          f"{losses['plain'].tolist()} max abs err {err:.3e}", flush=True)


def small_plain_phase(graph_problem):
    """3 steps of each workload at a small size (GIN: on its batch) through
    the kernels and through the plain versions on the card: the losses must
    agree (SAGE: both runs draw from the same integers, the generator being
    reseeded with the weights)."""
    from tf_geometric_tpu_torch import bench
    for spmm_bf16, tol in ((False, F32_TOL), (True, BF16_TOL)):
        problem = bench.build_problem(20_000, 140_000, device="cuda", spmm_bf16=spmm_bf16)
        _check(problem.adj.fwd.num_virtual > 0, "small problem has no hub rows")
        _check(problem.gat_layout.dst.hubs.numel() > 0, "small GAT layout has no hub rows")
        for name, wl in bench.WORKLOADS.items():
            if wl.problem == "arxiv":
                _kernel_vs_plain_losses(wl, problem, spmm_bf16, tol,
                                        f"{name} bf16={spmm_bf16}")
    sage = bench.build_sage_problem(20_000, 1_000_000, device="cuda")
    for name, wl in bench.WORKLOADS.items():
        if wl.problem == "reddit":
            _kernel_vs_plain_losses(wl, sage, False, F32_TOL, f"{name} (20,000 nodes)")
        elif wl.problem == "graphs":
            _kernel_vs_plain_losses(wl, graph_problem, False, F32_TOL,
                                    f"{name} ({graph_problem.num_graphs} graphs)")


def propagation_small_phase():
    """3 Adam steps of a TAGCN (k = 3, renorm off: its own CSR twin), a
    ChebyNet (k = 3, the COO SpMM over the scaled Laplacian) and an LEConv
    (the segment core) layer to the 40 classes at 20,000 nodes through the
    kernels and through the plain versions on the card: the losses must
    agree (1e-4), the kernel runs must launch their kernels and the plain
    runs none."""
    import torch
    import torch.nn.functional as F
    from tf_geometric_tpu_torch import bench, layers
    problem = bench.build_problem(20_000, 140_000, device="cuda", spmm_bf16=False)
    f = problem.x.shape[1]
    models = {"TAGCN": (lambda g: layers.TAGCN(f, bench.NUM_CLASSES, k=3, generator=g),
                        "csr_spmm"),
              "ChebyNet": (lambda g: layers.ChebyNet(f, bench.NUM_CLASSES, k=3, generator=g),
                           "spmm_heads"),
              "LEConv": (lambda g: layers.LEConv(f, bench.NUM_CLASSES, generator=g), None)}
    for name, (make, kernel) in models.items():
        losses = {}
        for label in ("kernel", "plain"):
            model = make(torch.Generator().manual_seed(0))
            opt = torch.optim.Adam(model.parameters(), lr=1e-2)
            cache = {}
            _zero_launch_counts()
            with (_plain() if label == "plain" else contextlib.nullcontext()):
                run = []
                for _ in range(3):
                    opt.zero_grad()
                    loss = F.cross_entropy(model([problem.x, problem.edge_index], cache=cache),
                                           problem.y)
                    loss.backward()
                    opt.step()
                    run.append(loss.detach())
            counts = dict(zip(_KERNELS, _launch_counts()))
            if kernel is not None and label == "kernel":
                _check(counts[kernel] > 0, f"small {name}: {kernel} was not launched")
            if label == "plain":
                _check(sum(counts.values()) == 0, f"small {name} plain run launched {counts}")
            losses[label] = torch.stack(run)
        err = _max_err(losses["kernel"], losses["plain"], F32_TOL, f"3-step losses {name}")
        print(f"small {name} (20,000 nodes): kernel {losses['kernel'].tolist()} plain "
              f"{losses['plain'].tolist()} max abs err {err:.3e}", flush=True)


def entry_phase():
    from tf_geometric_tpu_torch.entry import entry
    fn, args = entry()
    out = fn(*args)
    fn_cpu, args_cpu = entry(device="cpu")
    err = _max_err(out.cpu(), fn_cpu(*args_cpu), F32_TOL, "entry() on the card vs the CPU")
    print(f"entry(): output {tuple(out.shape)}, max abs err vs CPU {err:.3e}", flush=True)


# ---------------------------------------------------------------------------
# X7 (tiled_spmm): the block-sparse SpMM over occupied tiles, and its A/B
# ---------------------------------------------------------------------------

# (shape, tile, F): the three of tests/test_tiled_spmm.py's first test, its
# padded-edge case (t = 32), its bf16 case, the largest tile with one column,
# a tile of 48 (a k-chunk cut at the tile's edge) over 130 columns, and
X7_CASES = (((300, 260), 64, 24), ((130, 130), 128, 24), ((64, 64), 64, 24), ((96, 96), 32, 8),
            ((200, 200), 64, 16), ((520, 600), 256, 1), ((100, 70), 48, 130),
            # the bf16-tile kernel's plan edges: two F chunks at t = 256 and at
            # t = 128, three 64-row slices over two warpgroups, one 16-row tile
            ((520, 600), 256, 136), ((300, 300), 128, 300), ((400, 380), 192, 72),
            ((60, 50), 16, 8))
X7_WIDTH = 128                 # the A/B's F
BF16_TC_FLOPS_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense


def _x7_dtypes():
    import torch
    return ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
            (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16))


def _x7_check(ts, h, dy, tag):
    """Kernel against plain version, forward and ``dh``: tolerance by the
    output's dtype, a second run bit for bit, row tiles without tiles
    exactly 0; returns the max abs error."""
    import torch
    from tf_geometric_tpu_torch.ops import tiled_spmm as tsp
    tol = F32_TOL if h.dtype == torch.float32 else BF16_TOL
    err = 0.0
    for case, x, transpose, ptr in (("forward", h, False, ts.row_ptr),
                                    ("dh", dy, True, ts.t_row_ptr)):
        got = tsp.tiled_pass(ts, x, transpose)
        with _plain():
            want = tsp.tiled_pass(ts, x, transpose)
        torch.cuda.synchronize()
        err = max(err, _max_err(got, want, tol, f"x7 {case} {tag}"))
        _check(torch.equal(got, tsp.tiled_pass(ts, x, transpose)),
               f"x7 {case} {tag}: two runs on the same inputs differ")
        empty = torch.repeat_interleave(ptr.diff() == 0, ts.tile)[:got.shape[0]]
        _check(bool((got[empty] == 0).all()), f"x7 {case} {tag}: an empty row tile is not 0")
    return err


def _plain():
    from tf_geometric_tpu_torch.ops import config as kernel_config
    return kernel_config.use_plain_versions()


def x7_small_phase():
    """The kernel against its plain version at the JAX tests' shapes and
    tiles and at t = 256 and 48, every tile and operand dtype, forward and
    ``dh``; half the cases draw their rows from the first half only, so
    their later row tiles hold no tile."""
    import numpy as np
    import torch
    from tf_geometric_tpu_torch.ops import tiled_spmm as tsp
    from tf_geometric_tpu_torch.ops.tiled_spmm import build_tiled_spmm
    rng = np.random.default_rng(9)
    worst = 0.0
    for i, ((n, m), tile, width) in enumerate(X7_CASES):
        e = 6 * n
        rows = rng.integers(0, n // 2 if i % 2 else n, size=e)
        cols = rng.integers(0, m, size=e)
        if tile == 32:  # padded edges, out of range on either side
            rows[:2], cols[2:4] = n, m
        vals = rng.normal(size=e).astype(np.float32)
        base = build_tiled_spmm(np.stack([rows, cols]), vals, (n, m), tile=tile, device="cuda")
        for a_dtype, h_dtype in _x7_dtypes():
            ts = base._replace(a_tiles=base.a_tiles.to(a_dtype),
                               t_a_tiles=base.t_a_tiles.to(a_dtype))
            h = torch.as_tensor(rng.normal(size=(m, width)), dtype=torch.float32,
                                device="cuda").to(h_dtype)
            dy = torch.as_tensor(rng.normal(size=(n, width)), dtype=torch.float32,
                                 device="cuda").to(h_dtype)
            tag = (f"({n}, {m}) t={tile} F={width} tiles {str(a_dtype)[6:]} "
                   f"h {str(h_dtype)[6:]}")
            worst = max(worst, _x7_check(ts, h, dy, tag))
    bad = build_tiled_spmm(np.stack([rows, cols]), vals, (n, m), tile=24, device="cuda")
    try:
        tsp.tiled_pass(bad, h)
    except ValueError as e:
        _check("multiple of 16" in str(e), f"x7: t = 24 refused for another reason: {e}")
    else:
        raise RuntimeError("x7: the kernel accepted a tile of 24")
    print(f"x7 small cases: {len(X7_CASES)} shapes x 4 dtype pairs, forward and dh, "
          f"max abs err {worst:.3e}; t = 24 refused", flush=True)
    return worst


def x7_kernel_phase(small_err):
    """X7 on the A/B's community graph (``bench.community_graph``, t = 128,
    F = 128): float32 and bf16 tiles against ``h`` float32 and bf16, forward
    and ``dh``, against the plain version; timed beside the byte bound, the
    plain version, ``torch.sparse.mm`` on the CSR of the same matrix (the
    library yardstick, never called by the port) and Kernel A on the same
    graph. Returns one row per case."""
    import numpy as np
    import torch
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch.nn.conv.gcn import (compute_cache_key, gcn_norm_adj,
                                                    maybe_compile_ell)
    from tf_geometric_tpu_torch.ops.csr_spmm import side_matmul
    from tf_geometric_tpu_torch.ops import tiled_spmm as tsp
    from tf_geometric_tpu_torch.sparse import SparseMatrix
    t0 = time.perf_counter()
    ei = bench.community_graph()
    n = bench.ARXIV_NODES
    cache = {}
    normed = gcn_norm_adj(SparseMatrix(ei, None, (n, n), device="cuda"), cache=cache)
    adj = maybe_compile_ell(normed, cache, compute_cache_key("both", True, True, True, False))
    base = tsp.build_tiled_spmm(normed.index, normed.value, (n, n), tile=bench.TILED_AB_TILE,
                                device="cuda")
    torch.cuda.synchronize()
    b, bt = int(base.a_tiles.shape[0]), int(base.t_a_tiles.shape[0])
    print(f"x7 community graph: {b} tiles ({bt} transposed) of {base.tile}, occupancy "
          f"{base.occupancy:.5f}, packed in {time.perf_counter() - t0:.1f} s", flush=True)
    for side, ptr in (("forward", base.row_ptr), ("transpose", base.t_row_ptr)):
        per = ptr.diff().float()
        print(f"x7 tiles per row tile ({side}): min {int(per.min())} mean "
              f"{float(per.mean()):.2f} max {int(per.max())}", flush=True)
    for h_dtype in (torch.float32, torch.bfloat16):
        print(f"x7 bf16-tile kernel at t={base.tile} F={X7_WIDTH}, h {str(h_dtype)[6:]}: "
              f"{tsp.kernel_info(base.tile, X7_WIDTH, torch.bfloat16, h_dtype)}", flush=True)
    lib = {"forward": _library_csr(adj, normed.index, normed.value, "fwd"),
           "dh": _library_csr(adj, normed.index, normed.value, "bwd")}
    sides = {"forward": adj.fwd, "dh": adj.bwd}
    gen = torch.Generator(device="cuda").manual_seed(10)
    rows = []
    for a_dtype, h_dtype in _x7_dtypes():
        ts = base if a_dtype == torch.float32 else base._replace(
            a_tiles=base.a_tiles.to(a_dtype), t_a_tiles=base.t_a_tiles.to(a_dtype))
        h = torch.randn(n, X7_WIDTH, generator=gen, device="cuda").to(h_dtype)
        dy = torch.randn(n, X7_WIDTH, generator=gen, device="cuda").to(h_dtype)
        tag = f"community t={ts.tile} F={X7_WIDTH} tiles {str(a_dtype)[6:]} h {str(h_dtype)[6:]}"
        err = max(small_err, _x7_check(ts, h, dy, tag))
        flop_rate = BF16_TC_FLOPS_PER_S if a_dtype == torch.bfloat16 else F32_FLOPS_PER_S
        for case, x, transpose in (("forward", h, False), ("dh", dy, True)):
            nb = int((ts.t_a_tiles if transpose else ts.a_tiles).shape[0])
            nbytes = tsp.tiled_pass_bytes(ts, X7_WIDTH, x.element_size(), transpose)
            flops = 2 * nb * ts.tile * ts.tile * X7_WIDTH
            byte_ms, flop_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / flop_rate
            timed = h_dtype == torch.float32
            x32 = x.float()
            bf16 = a_dtype == torch.bfloat16
            rows.append(dict(
                name="tiled_spmm", case=case, a_dtype=str(a_dtype)[6:], dtype=str(h_dtype)[6:],
                width=X7_WIDTH, max_abs_err=err,
                ms=_cuda_ms(lambda: tsp.tiled_pass(ts, x, transpose)),
                device_ms=_device_ms(lambda: tsp.tiled_pass(ts, x, transpose)) if bf16 else None,
                # the wrapper's cast of the operand, inside ms, apart
                cast_ms=_cuda_ms(lambda: tsp.cast_operand(x, ts.tile)) if bf16 else None,
                plain_ms=_plain_ms(lambda: tsp.tiled_pass(ts, x, transpose)) if timed else None,
                library_ms=_cuda_ms(lambda: torch.sparse.mm(lib[case], x32)) if timed else None,
                kernel_a_ms=_cuda_ms(lambda: side_matmul(sides[case], x32, adj.diag_val))
                if timed else None,
                bound_ms=max(byte_ms, flop_ms),
                bound_by="bytes" if byte_ms >= flop_ms else "operations"))
        del ts, h, dy
        torch.cuda.empty_cache()
    del base, lib, adj, normed
    torch.cuda.empty_cache()
    print("x7 kernel check (name case tiles h: max_abs_err, ms, plain_ms, library_ms "
          "(torch.sparse.mm, CSR, float32), Kernel A ms (float32), bound_ms; bf16 tiles: "
          "device ms, the operand's cast ms inside ms)")
    for r in rows:
        extra = ("not timed" if r["plain_ms"] is None else
                 f"{r['plain_ms']:.4f}, {r['library_ms']:.4f}, {r['kernel_a_ms']:.4f}")
        cast = ("" if r["cast_ms"] is None else
                f"; device {_ms_text(r['device_ms'])}, cast {r['cast_ms']:.4f}")
        print(f"  {r['name']} {r['case']} tiles {r['a_dtype']} h {r['dtype']}: "
              f"{r['max_abs_err']:.3e}, {r['ms']:.4f}, {extra}, {r['bound_ms']:.4f} "
              f"({r['bound_by']}){cast}", flush=True)
    return rows


def _plain_ms(fn):
    with _plain():
        return _cuda_ms(fn, iters=3, warmup=1)


def x7_main_path_phase(gpu):
    """X7's one path, the A/B twin (``bench.tiled_ab``): the occupancy lines,
    the four paths timed on each graph whose tiles fit, the ``VERDICT``
    lines; the tiled paths launch the kernel once (forward) and twice
    (forward and ``dh``) a step, and each CSR step Kernel A as often."""
    from tf_geometric_tpu_torch import bench
    _zero_launch_counts()
    res = bench.tiled_ab()
    counts = dict(zip(_KERNELS, _launch_counts()))
    timed = [name for name, r in res.items() if r["ms"] is not None]
    _check("community" in timed, f"the community graph was not timed: {timed}")
    from tf_geometric_tpu_torch.utils.profiling import STEP_TIME_WARMUP
    steps = STEP_TIME_WARMUP + sum(bench.TILED_AB_TIMING.values())  # per path and graph
    want = 3 * steps * len(timed)
    _check(counts["tiled_spmm"] == want,
           f"A/B: tiled_spmm launches {counts['tiled_spmm']} != expected {want}")
    _check(counts["csr_spmm"] == want,
           f"A/B: csr_spmm launches {counts['csr_spmm']} != expected {want}")
    print(f"tiled A/B: graphs timed {timed}, launches {counts} ({steps} steps a path) on {gpu}",
          flush=True)
    return counts["tiled_spmm"], res


# ---------------------------------------------------------------------------
# the graph-parallel slice: X2 (ell_spmm) and X5 (gat_attention_ell) on the
# halo plans of the arxiv graph partitioned over 4 ranks
# ---------------------------------------------------------------------------

HALO_LABEL = "4 ranks sharing one H100 over gloo"
X2_WIDTHS = (64, 40)                   # the halo GCN's two layers
X5_SHAPES = ((8, 8), (1, 64), (8, 32))  # the fused GAT's two layers, and wider heads
X5_KEEP_RATE = 0.6


def _side_rows(side):
    """Each stored entry's row, virtual rows mapped to the hub that owns them."""
    import torch
    ptr = side.row_ptr.long()
    rows = torch.repeat_interleave(torch.arange(ptr.shape[0] - 1, device=ptr.device),
                                   ptr[1:] - ptr[:-1])
    if side.num_virtual:
        owners = torch.repeat_interleave(side.owner_rows.long(),
                                         (side.owner_ptr[1:] - side.owner_ptr[:-1]).long())
        rows = torch.where(rows >= side.num_rows,
                           owners[(rows - side.num_rows).clamp(0, owners.shape[0] - 1)], rows)
    return rows


def _block_library(adj, side_name):
    """One product direction of a block (diagonal included) as a torch CSR
    matrix, for the ``torch.sparse.mm`` yardstick."""
    import torch
    side = getattr(adj, side_name)
    rows, cols, vals = _side_rows(side), side.col.long(), side.val
    n_rows = adj.shape[0] if side_name == "fwd" else adj.shape[1]
    n_cols = adj.shape[1] if side_name == "fwd" else adj.shape[0]
    if adj.diag_val is not None:
        diag = torch.arange(n_rows, device=rows.device)
        rows, cols, vals = (torch.cat([rows, diag]), torch.cat([cols, diag]),
                            torch.cat([vals, adj.diag_val]))
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (n_rows, n_cols))
    return coo.coalesce().to_sparse_csr()


def _block_sampled_by_edge(adj, res):
    """A ``sampled_addmm`` result on a block's forward pattern
    (``_block_library``: its entries, virtual rows at their owners, and the
    diagonal, coalesced) as (edge ids, value of each edge) over the block's
    stored edges, for the ``diff_values`` SDDMM's [num_edges] result."""
    import torch
    side = adj.fwd
    rows, cols, eids = _side_rows(side), side.col.long(), side.eid.long()
    if adj.diag_val is not None:
        diag = torch.arange(adj.shape[0], device=rows.device)
        rows, cols, eids = (torch.cat([rows, diag]), torch.cat([cols, diag]),
                            torch.cat([eids, adj.diag_eid.long()]))
    pos = torch.unique(rows * adj.shape[1] + cols, return_inverse=True)[1]
    real = eids < adj.num_edges
    return eids[real], res.values()[pos[real]]


def _dv_bytes(adj, width, elt):
    """Least bytes of the ``diff_values`` SDDMM over a block: the forward
    side's row pointers, each entry's column and edge id read and its value
    written (the diagonal's too), and the rows of dy and h that an entry
    reads."""
    from tf_geometric_tpu_torch import bench
    entries = int(adj.fwd.col.shape[0]) + bench.csr_diag_rows(adj)
    return (4 * adj.fwd.row_ptr.shape[0] + 12 * entries
            + (bench.csr_rows_read(adj, adj.bwd) + bench.csr_rows_read(adj, adj.fwd))
            * width * elt)


def x2_kernel_phase(halo):
    """Kernel A and B on every rank's local (split-diagonal) and remote
    (rectangular) halo block, forward and ``dh``, at the halo GCN's widths in
    float32 and bfloat16, and the ``diff_values`` SDDMM, against their plain
    versions; timed beside the byte bound and ``torch.sparse.mm`` on the
    same block (float32)."""
    import torch
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch.ops.csr_spmm import (csr_spmm_plain, launch_csr_spmm,
                                                     side_matmul, side_matmul_plain)
    from tf_geometric_tpu_torch.ops.ell import side_value_grad
    from tf_geometric_tpu_torch.ops.sorted_segment import (launch_sorted_segment_sum,
                                                           sorted_segment_sum_plain)
    from tf_geometric_tpu_torch.ops.spmm_heads import CsrView, pass_flops
    spec = halo.gcn_spec
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for r in range(halo.num_parts):
        for block_name, block in (("local", spec.local[r]), ("remote", spec.remote[r])):
            adj = block.to("cuda")
            for side_name in ("fwd", "bwd"):
                side = getattr(adj, side_name)
                deg = side.row_ptr.diff()[:side.num_rows]
                sddmm = (f"; dv SDDMM {_sddmm_walk(CsrView(side.row_ptr, side.col, side.eid))} "
                         f"entries" if side_name == "fwd" else "")
                print(f"x2 rank {r} {block_name} {side_name}: {side.num_rows} rows, "
                      f"{int(side.col.shape[0])} entries, "
                      f"{0 if side.owner_rows is None else side.owner_rows.shape[0]} hub rows, "
                      f"{side.num_virtual} virtual rows, {int((deg == 0).sum())} rows without "
                      f"entries{', split diagonal' if adj.diag_val is not None else ''}, "
                      f"{_walk_line(side)}{sddmm}", flush=True)
            libs = {s: _block_library(adj, s) for s in ("fwd", "bwd")}
            for dtype in (torch.float32, torch.bfloat16):
                f32 = dtype == torch.float32
                tol, elt = (F32_TOL, 4) if f32 else (BF16_TOL, 2)
                for width in X2_WIDTHS:
                    tag = f"rank {r} {block_name} F={width} {str(dtype)[6:]}"
                    for side_name, n_src in (("fwd", adj.shape[1]), ("bwd", adj.shape[0])):
                        side = getattr(adj, side_name)
                        h = torch.randn(n_src, width, generator=gen, device="cuda").to(dtype)
                        args = (side.row_ptr, side.col, side.val, h, adj.diag_val, side.num_rows)
                        out_k, part_k = launch_csr_spmm(*args)
                        out_p, part_p = csr_spmm_plain(*args)
                        full = side_matmul(side, h, adj.diag_val)
                        torch.cuda.synchronize()
                        case = "forward" if side_name == "fwd" else "dh"
                        _check_same_bits(launch_csr_spmm, args, (out_k, part_k),
                                         f"x2 Kernel A {case} {tag}")
                        err = max(_max_err(out_k, out_p, tol, f"x2 Kernel A {case} {tag}"),
                                  _max_err(part_k, part_p, F32_TOL, f"x2 partial {case} {tag}"),
                                  _max_err(full, side_matmul_plain(side, h, adj.diag_val), tol,
                                           f"x2 A+B {case} {tag}"))
                        if f32:
                            err = max(err, _max_err(full, torch.sparse.mm(libs[side_name], h),
                                                    F32_TOL, f"x2 {case} vs torch.sparse.mm {tag}"))
                        bound_ms, bound_by = _bound(
                            bench.csr_pass_bytes(adj, side, width, elt),
                            2 * (int(side.col.shape[0]) + bench.csr_diag_rows(adj)) * width)
                        # the main path's call: one launch, the hub merge included
                        rows.append(dict(
                            name="csr_spmm", case=f"x2 {block_name} {case}", rank=r, width=width,
                            dtype=str(dtype)[6:], max_abs_err=err,
                            ms=_cuda_ms(lambda: side_matmul(side, h, adj.diag_val)),
                            plain_ms=_cuda_ms(lambda: side_matmul_plain(side, h, adj.diag_val),
                                              iters=3, warmup=1),
                            library_ms=_cuda_ms(lambda: torch.sparse.mm(libs[side_name], h))
                            if f32 else None, bound_ms=bound_ms, bound_by=bound_by))
                        if f32:
                            rows[-1].update(
                                device_ms=_device_ms(lambda: side_matmul(side, h, adj.diag_val)),
                                library_device_ms=_device_ms(
                                    lambda: torch.sparse.mm(libs[side_name], h)))
                        if side.num_virtual:
                            base = out_k.clone()
                            got = launch_sorted_segment_sum(part_k, side.owner_ptr, base.clone(),
                                                            True, side.owner_rows)
                            want = sorted_segment_sum_plain(part_k, side.owner_ptr, base.clone(),
                                                            side.owner_rows)
                            torch.cuda.synchronize()
                            owners = int(side.owner_rows.shape[0])
                            bound_ms, bound_by = _bound(
                                side.num_virtual * width * 4 + 2 * owners * width * elt
                                + 4 * (2 * owners + 1), (side.num_virtual + owners) * width)
                            rows.append(dict(
                                name="sorted_segment_sum", case=f"x2 {block_name} {case}", rank=r,
                                width=width, dtype=str(dtype)[6:],
                                max_abs_err=_max_err(got, want, tol, f"x2 Kernel B {case} {tag}"),
                                ms=_cuda_ms(lambda: launch_sorted_segment_sum(
                                    part_k, side.owner_ptr, base, True, side.owner_rows)),
                                plain_ms=_cuda_ms(lambda: sorted_segment_sum_plain(
                                    part_k, side.owner_ptr, base, side.owner_rows), iters=3,
                                    warmup=1),
                                library_ms=_cuda_ms(lambda: torch.segment_reduce(
                                    part_k, "sum", lengths=side.owner_ptr.diff().long())),
                                bound_ms=bound_ms, bound_by=bound_by))
                    # diff_values: dv[e] = <dy[row_e], h[col_e]>, SDDMM over the
                    # forward side (virtual rows read their owner's dy) and the diagonal
                    h = torch.randn(adj.shape[1], width, generator=gen, device="cuda").to(dtype)
                    dy = torch.randn(adj.shape[0], width, generator=gen, device="cuda").to(dtype)
                    got = side_value_grad(adj, h, dy)
                    want = side_value_grad(adj, h, dy, plain=True)
                    torch.cuda.synchronize()
                    err = _max_err(got, want, tol, f"x2 dv {tag}")
                    _check(torch.equal(got, side_value_grad(adj, h, dy)),
                           f"x2 dv {tag}: two runs on the same inputs differ")
                    library = (lambda: torch.sparse.sampled_addmm(libs["fwd"], dy, h.t(),
                                                                  beta=0.0)) if f32 else None
                    if f32:
                        eid, want_lib = _block_sampled_by_edge(adj, library())
                        err = max(err, _max_err(got[eid], want_lib, F32_TOL,
                                                f"x2 dv {tag} vs the library call"))
                    bound_ms, bound_by = _bound(
                        _dv_bytes(adj, width, elt),
                        pass_flops(int(adj.fwd.col.shape[0]) + bench.csr_diag_rows(adj), width))
                    rows.append(dict(
                        name="sddmm_heads", case=f"x2 {block_name} dv", rank=r, width=width,
                        dtype=str(dtype)[6:], max_abs_err=err,
                        ms=_cuda_ms(lambda: side_value_grad(adj, h, dy)),
                        plain_ms=_cuda_ms(lambda: side_value_grad(adj, h, dy, plain=True),
                                          iters=3, warmup=1),
                        library_ms=None if library is None else _cuda_ms(library),
                        bound_ms=bound_ms, bound_by=bound_by))
                    if f32:
                        kernels = _device_kernels(lambda: side_value_grad(adj, h, dy))
                        rows[-1].update(device_ms=None if kernels is None
                                        else sum(k[1] for k in kernels),
                                        library_device_ms=_device_ms(library))
                        if r == 0 and width == X2_WIDTHS[0] and kernels is not None:
                            # what the call's time is made of besides the SDDMM
                            print(f"x2 dv {tag}: {rows[-1]['ms']:.4f} ms, device by kernel "
                                  + ", ".join(f"{_short_name(k[0])} {k[1]:.4f} x{k[2]:g}"
                                              for k in kernels), flush=True)
            del adj, libs
            torch.cuda.empty_cache()
    print("x2 kernel check (name case rank F dtype: max_abs_err, ms, plain_ms, library_ms, "
          "bound_ms; float32 Kernel A and dv: device ms under the profiler, dv the whole call)")
    for r in rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  {r['name']} {r['case']} rank {r['rank']} F={r['width']} {r['dtype']}: "
              f"{r['max_abs_err']:.3e}, {r['ms']:.4f}, {r['plain_ms']:.4f}, {lib}, "
              f"{r['bound_ms']:.4f} ({r['bound_by']}){_device_note(r)}", flush=True)
    return rows


def x5_kernel_phase(halo):
    """The three attention kernels on every rank's rectangular GAT layout at
    ``X5_SHAPES``, float32 and bfloat16, without dropout and with a 0.6 keep
    mask, against their plain versions (``_gat_case``); rows without entries
    must come back exactly 0. The main path's cases (float32 with the mask)
    are timed on rank 0."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = []
    for r in range(halo.num_parts):
        layout = halo.gat_spec.layouts[r].to("cuda")
        n, S = layout.num_nodes, layout.num_src
        empty_dst = layout.dst.row_ptr.diff() == 0
        empty_src = layout.src.row_ptr.diff() == 0
        print(f"x5 rank {r}: {layout}; destination side {int(layout.dst.hubs.shape[0])} hub rows, "
              f"{int(empty_dst.sum())} rows without entries; source side "
              f"{int(layout.src.hubs.shape[0])} hub rows, {int(empty_src.sum())} rows without "
              f"entries", flush=True)
        for heads, width in X5_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                f32 = dtype == torch.float32
                Q, dy = (torch.randn(n, heads * width, generator=gen, device="cuda").to(dtype)
                         for _ in range(2))
                K, V = (torch.randn(S, heads * width, generator=gen, device="cuda").to(dtype)
                        for _ in range(2))
                for with_keep in (False, True):
                    keep = None
                    if with_keep:
                        keep = ((torch.rand(layout.num_edges, heads, generator=gen, device="cuda")
                                 >= X5_KEEP_RATE).float() / (1.0 - X5_KEEP_RATE))
                    tag = (f"rank {r} H={heads} d={width} {str(dtype)[6:]} "
                           f"{'keep 0.4' if with_keep else 'no dropout'}")
                    errs, calls, outs = _gat_case(layout, Q, K, V, dy, heads, keep, f"x5 {tag}")
                    for what, empty in (("out", empty_dst), ("lse", empty_dst), ("dQ", empty_dst),
                                        ("D", empty_dst), ("dK", empty_src), ("dV", empty_src)):
                        _check(bool((outs[what][empty] == 0).all()),
                               f"x5 {what} {tag}: a row without entries is not exactly 0")
                    rows += _gat_rows(layout, heads, width, dtype, keep, errs, calls, outs,
                                      r == 0 and f32 and with_keep, case="x5", rank=r)
                    del outs
                del Q, K, V, dy
        del layout
        torch.cuda.empty_cache()
    print("x5 kernel check (name rank H d dtype dropout: max_abs_err, ms, plain_ms, bound_ms)")
    for r in rows:
        print(f"  {r['name']} rank {r['rank']} H={r['heads']} d={r['width']} {r['dtype']} "
              f"{'keep' if r['keep'] else 'none'}: {r['max_abs_err']:.3e}, {_gat_row_text(r)}, "
              f"{r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    return rows


def _halo_expected(halo, name, rank, steps):
    """Each kernel's launches on one rank over ``steps`` steps of a halo
    workload: the GCN runs Kernel A forward and ``dh`` on both blocks in both
    layers (8 a step; a block side with hub rows merges them in the same
    launch: no Kernel B); the GAT one forward and two backward attention
    launches per layer."""
    from tf_geometric_tpu_torch import bench
    expected = dict.fromkeys(_KERNELS, 0)
    if bench.HALO_WORKLOADS[name] == "gcn":
        layers = 2
        expected.update(csr_spmm=steps * layers * 4)
    else:
        layers = len(bench.HALO_GAT_DIMS)
        expected.update(gat_forward=steps * layers, gat_backward_dst=steps * layers,
                        gat_backward_src=steps * layers)
    return expected


def halo_main_path_phase(halo, gpu):
    """The halo GCN and the fused halo GAT at full arxiv size on 4 ranks
    sharing the card (gloo, CUDA tensors): 3 warm-up and 20 timed steps
    each; the loss finite and falling on every rank, each kernel's launches
    per rank exactly as the plans imply. Returns the launch totals over the
    ranks (per workload) and the results."""
    from tf_geometric_tpu_torch import bench
    totals, results = {}, {}
    for name in bench.HALO_WORKLOADS:
        res = bench.run_halo_workload(halo, name, steps=TIMED_ITERS)
        steps = res["steps_taken"]
        totals[name] = dict.fromkeys(_KERNELS, 0)
        for rank, (job,) in enumerate(res["ranks"]):
            expected = _halo_expected(halo, name, rank, steps)
            got = {k: job["launches"][k] for k in _KERNELS}
            _check(got == expected, f"{name} rank {rank}: launches {got} != expected {expected}")
            losses = job["losses"]
            _check(all(math.isfinite(v) for v in losses), f"{name}: non-finite loss {losses}")
            _check(losses[-1] < losses[0], f"{name}: loss did not fall: {losses}")
            totals[name] = {k: totals[name][k] + got[k] for k in _KERNELS}
        per_rank = [float(sorted(job["step_ms"])[len(job["step_ms"]) // 2])
                    for (job,) in res["ranks"]]
        line = res["line"]
        print(f"{name} ({HALO_LABEL}): {res['step_ms']:.4f} ms/step (slowest rank's median; "
              f"ranks {', '.join(f'{v:.4f}' for v in per_rank)}), {line['value']} edges/s, "
              f"halo_fraction {line['halo_fraction']}, cap {line['cap']}, vs_baseline "
              f"{line['vs_baseline']}, loss {res['ranks'][0][0]['losses'][0]:.5f} -> "
              f"{res['ranks'][0][0]['losses'][-1]:.5f}, launches per rank per step "
              f"{ {k: v // steps for k, v in _halo_expected(halo, name, 0, steps).items() if v} } "
              f"(rank 0) on {gpu}", flush=True)
        print(json.dumps(line), flush=True)
        results[name] = res
    return totals, results


def halo_single_process_check(halo, results):
    """The 4-rank halo GCN's step-1 loss and gradients against the port's
    single-process GCN on the card, over the whole graph with the same
    normalized adjacency and weights (rtol 1e-4, atol 1e-4 of the largest
    gradient entry: float32 sums in another order)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch.convert import sharded_params_from_numpy
    from tf_geometric_tpu_torch.ops.csr_spmm import CsrAdj, csr_spmm
    part = halo.gcn_part
    npp, n_pad = part.nodes_per_part, part.num_nodes_padded
    ok = part.local_row < npp
    rows = (part.local_row + np.arange(halo.num_parts)[:, None] * npp)[ok]
    adj = CsrAdj.from_coo(np.stack([rows, part.global_col[ok]]), part.value[ok], (n_pad, n_pad),
                          split_diag=True, device="cuda")
    params = sharded_params_from_numpy(halo.params["gcn_arxiv_halo_p4_fwd_bwd"], "cuda")
    x, mask = (torch.as_tensor(a, device="cuda") for a in (halo.x, halo.mask))
    y = torch.as_tensor(halo.y, device="cuda").long()
    (w0, b0), (w1, b1) = params
    h = torch.relu(csr_spmm(adj, x @ w0) + b0)
    ce = F.cross_entropy(csr_spmm(adj, h @ w1) + b1, y, reduction="none")
    loss = (ce * mask).sum() / mask.sum()
    loss.backward()
    job = results["gcn_arxiv_halo_p4_fwd_bwd"]["ranks"][0][0]
    err = _max_err(torch.tensor([job["losses"][0]]), loss.detach().cpu()[None],
                   dict(rtol=1e-4, atol=1e-6), "halo GCN step-1 loss vs single process")
    got = [g for layer in job["grads"] for g in layer]
    for i, (g, p) in enumerate(zip(got, (w0, b0, w1, b1))):
        want = p.grad.cpu()
        tol = dict(rtol=1e-4, atol=1e-4 * float(want.abs().max()))
        err = max(err, _max_err(torch.as_tensor(g), want, tol,
                                f"halo GCN step-1 gradient {i} vs single process"))
    print(f"halo GCN vs single process ({bench.HALO_PARTS} ranks): step-1 loss "
          f"{job['losses'][0]:.6f} vs {float(loss):.6f}, max abs err {err:.3e}", flush=True)


def halo_small_plain_phase():
    """3 steps of both halo workloads at 20,000 nodes on 4 ranks through the
    kernels and through the plain versions on the card (the same dropout
    draws): the losses must agree."""
    import torch
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch.parallel import run_ranks
    small = bench.build_halo_problem(num_nodes=20_000, num_edges=140_000)
    jobs = [[] for _ in range(small.num_parts)]
    for name in bench.HALO_WORKLOADS:
        for plain in (False, True):
            for r, (job,) in enumerate(bench.halo_jobs(small, name, 3, plain=plain)):
                jobs[r].append(job._replace(name=f"{name} plain={plain}"))
    results = run_ranks(jobs, backend="gloo", device="cuda")
    for name in bench.HALO_WORKLOADS:
        by = {job["name"]: job["losses"] for job in results[0]}
        kern, plain = by[f"{name} plain=False"], by[f"{name} plain=True"]
        err = _max_err(torch.tensor(kern), torch.tensor(plain), F32_TOL,
                       f"3-step losses {name} (20,000 nodes, {HALO_LABEL})")
        print(f"small {name}: kernel {kern} plain {plain} max abs err {err:.3e}", flush=True)


def dryrun_phase():
    """The port's twin of the JAX dry run on 4 ranks sharing the card: the
    halo GCN, the fused halo GAT, the sampled SAGE, the MinCut step and the
    2-D batch step (data 2 × graph 2), each loss finite."""
    from tf_geometric_tpu_torch.entry import dryrun_multichip
    losses = dryrun_multichip(4)
    print(f"dryrun_multichip(4) ({HALO_LABEL}): losses {losses}", flush=True)


SAMPLED_LABEL = "sampled arxiv rank 1"


def sampled_sage_kernel_phase(problem):
    """The draw and S1 on workload 13's path, at rank 1's shapes (its CSR
    shard, global self ids, the 169,472-row gathered table, 64 wide): the
    draw at k = 25 and 10 exactly against its plain version; S1 forward and
    backward in float32 and bfloat16 as ``_s1_rows`` holds them (the
    backward's transpose over every row of the table). Returns one row per
    kernel and case (float32 timed)."""
    import torch
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch.nn.sampling.device_sampler import _random_ints
    from tf_geometric_tpu_torch.ops import fixed_k as fk
    rank = 1
    csr = {name: torch.as_tensor(a[rank], device="cuda") for name, a in problem.shards.items()}
    n_table = problem.x.shape[0]
    n_local = n_table // problem.num_parts
    width = bench.SAMPLED_SAGE_HIDDEN // 2
    nnz = int(csr["degree"].sum())
    self_ids = torch.arange(rank * n_local, (rank + 1) * n_local, dtype=torch.int32,
                            device="cuda")
    print(f"sampled SAGE rank {rank}: {n_local} rows, {nnz} edges, "
          f"{int((csr['degree'] == 0).sum())} rows without edges, table of {n_table} rows, "
          f"{width} wide; backward passes {fk.backward_plan(n_table, width, 4, 4).passes}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for k in bench.SAMPLED_SAGE_FANOUTS:
        r = _random_ints(gen, k, n_local, "cuda")
        args = (r, csr["row_start"], csr["degree"], csr["sorted_col"], None, self_ids)
        idx, w = fk.launch_draw_fixed_k(*args)
        idx_p, w_p = fk.draw_fixed_k_plain(*args)
        torch.cuda.synchronize()
        _check(torch.equal(idx, idx_p) and torch.equal(w, w_p),
               f"fixed_k draw {SAMPLED_LABEL} k={k} differs from plain")
        _check(bool(((idx >= 0) & (idx < n_table)).all()),
               f"fixed_k draw {SAMPLED_LABEL} k={k}: an id outside the table")
        rows.append(dict(name="fixed_k_draw", graph=SAMPLED_LABEL, k=k, weighted=False,
                         max_abs_err=0.0, ms=_cuda_ms(lambda: fk.launch_draw_fixed_k(*args)),
                         device_ms=_device_ms(lambda: fk.launch_draw_fixed_k(*args)),
                         plain_ms=_cuda_ms(lambda: fk.draw_fixed_k_plain(*args), iters=3,
                                           warmup=1),
                         library_ms=None,
                         bound_ms=1e3 * fk.draw_pass_bytes(k, n_local, nnz, False)
                         / HBM_BYTES_PER_S, bound_by="bytes"))
        print(f"sampled draw k={k}: {_walk_text(fk, idx, n_table)}", flush=True)
        for dtype in (torch.float32, torch.bfloat16):
            rows += _s1_rows(fk, n_table, k, width, dtype, idx, w, gen,
                             f"{SAMPLED_LABEL} k={k} F={width} {str(dtype)[6:]}", SAMPLED_LABEL,
                             timed=dtype == torch.float32)
    print("sampled SAGE kernel check (name graph k F dtype: max_abs_err, ms, plain_ms, "
          "library_ms prebuilt / from the draw, bound_ms, every gather from HBM, device ms "
          "total / transpose / gather, bits)")
    _print_s1_rows(rows)
    return rows


def _sampled_expected(problem, steps):
    """Each kernel's launches on one rank over ``steps`` steps of workload
    13: per layer one draw, one aggregation forward and one backward call
    (its sort's launches and the gather, over the gathered table's rows)."""
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch.ops import fixed_k as fk
    layers = len(bench.SAMPLED_SAGE_FANOUTS)
    expected = dict.fromkeys(_KERNELS, 0)
    expected.update(fixed_k_draw=steps * layers, fixed_k_forward=steps * layers,
                    fixed_k_backward=steps * layers
                    * fk.fixed_k_backward_launches(problem.x.shape[0]))
    return expected


def sampled_sage_main_path_phase(problem, gpu):
    """Workload 13 at full size on 4 ranks sharing the card (gloo, CUDA
    tensors), 3 warm-up and 20 timed steps, then the profiled steps: the
    loss finite and falling on every rank, each kernel's launches per rank
    exactly as the layers imply. Returns the launch totals over the ranks
    and the result."""
    from tf_geometric_tpu_torch import bench
    res = bench.run_sampled_sage_workload(problem, steps=TIMED_ITERS, profile=True)
    steps = res["steps_taken"]
    expected = _sampled_expected(problem, steps)
    totals = dict.fromkeys(_KERNELS, 0)
    for rank, (job,) in enumerate(res["ranks"]):
        got = {k: job["launches"][k] for k in _KERNELS}
        _check(got == expected, f"workload 13 rank {rank}: launches {got} != expected {expected}")
        losses = job["losses"]
        _check(all(math.isfinite(v) for v in losses), f"workload 13: non-finite loss {losses}")
        _check(losses[-1] < losses[0], f"workload 13: loss did not fall: {losses}")
        totals = {k: totals[k] + got[k] for k in _KERNELS}
    per_rank = [float(sorted(job["step_ms"])[len(job["step_ms"]) // 2])
                for (job,) in res["ranks"]]
    line, prof = res["line"], res["profile"]
    print(f"{bench.SAMPLED_SAGE_WORKLOAD} ({HALO_LABEL}): {res['step_ms']:.4f} ms/step (slowest "
          f"rank's median; ranks {', '.join(f'{v:.4f}' for v in per_rank)}), {line['value']} "
          f"sampled edges/s, vs_baseline {line['vs_baseline']}, loss "
          f"{res['ranks'][0][0]['losses'][0]:.5f} -> {res['ranks'][0][0]['losses'][-1]:.5f}, "
          f"launches per rank per step { {k: v // steps for k, v in expected.items() if v} }; "
          f"profiled: card busy {prof['card_busy_ms']} ms of {prof['step_ms']:.4f} (ranks "
          f"{prof['rank_busy_ms']}), idle share {prof['card_idle_share']} on {gpu}", flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps(prof), flush=True)
    return totals, res


def sampled_sage_small_plain_phase():
    """3 steps of workload 13 at 20,000 nodes on 4 ranks through the
    kernels and through the plain versions on the card (the same draws):
    rank 0's losses must agree."""
    import torch
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch.parallel import run_ranks
    small = bench.build_sampled_sage_problem(num_nodes=20_000, num_edges=140_000)
    jobs = [[] for _ in range(small.num_parts)]
    for plain in (False, True):
        for r, (job,) in enumerate(bench.sampled_sage_jobs(small, 3, plain=plain)):
            jobs[r].append(job._replace(name=f"plain={plain}"))
    results = run_ranks(jobs, backend="gloo", device="cuda")
    by = {job["name"]: job["losses"] for job in results[0]}
    kern, plain = by["plain=False"], by["plain=True"]
    err = _max_err(torch.tensor(kern), torch.tensor(plain), F32_TOL,
                   f"3-step losses workload 13 (20,000 nodes, {HALO_LABEL})")
    print(f"small workload 13: kernel {kern} plain {plain} max abs err {err:.3e}", flush=True)


def sampled_sage_kernel_entries(rows, totals):
    """The ``{"kernels"}`` entries of the draw and S1 on workload 13's path,
    at rank 1's first layer (k = 25, F = 64, float32), launches over the
    ranks of its main path."""
    replaces = {"fixed_k_draw": "tf_geometric_tpu/nn/sampling/device_sampler.py:33",
                "fixed_k_forward": "tf_geometric_tpu/nn/conv/graph_sage.py:67",
                "fixed_k_backward": "tf_geometric_tpu/nn/conv/graph_sage.py:67"}
    entries = []
    for name, path in replaces.items():
        _check(totals[name] > 0, f"{name} was not launched on the sampled SAGE path")
        mine = [r for r in rows if r["name"] == name]
        rep = next(r for r in mine if r["k"] == 25 and r.get("dtype", "float32") == "float32"
                   and "ms" in r)
        entries.append({
            "name": f"sampled_sage:{name}", "route": "cuda",
            "source": "tf_geometric_tpu_torch/csrc/fixed_k.cu",
            "replaces": path, "launches": totals[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine), "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            "shape": f"rank 1, k=25, table 169,472 x 64, float32; {HALO_LABEL}"})
    return entries


MINCUT_LABEL = "mincut arxiv rank 1"


def mincut_kernel_phase(problem):
    """Kernel A on workload 17's path: rank 1's rectangular block of the
    normalized adjacency without self-loops ([npp, P·npp], rows local,
    columns global), its forward side and its transposed side (``dh``), at
    F = hidden + C and F = C, float32: against its plain version and
    ``torch.sparse.mm`` on the same CSR (1e-4), and against a second run,
    bit for bit; timed by CUDA events and by device time beside its byte
    bound, its plain version and the library call. Returns one row per
    side and width."""
    import torch
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch.ops.csr_spmm import side_matmul, side_matmul_plain
    rank = 1
    adj = problem.adjs[rank].csr.to("cuda")
    widths = (bench.MINCUT_HIDDEN + bench.MINCUT_CLUSTERS, bench.MINCUT_CLUSTERS)
    for side_name in ("fwd", "bwd"):
        side = getattr(adj, side_name)
        deg = side.row_ptr.diff()[:side.num_rows]
        print(f"{MINCUT_LABEL} {side_name}: {side.num_rows} rows reading "
              f"{adj.shape[1] if side_name == 'fwd' else adj.shape[0]}, "
              f"{int(side.col.shape[0])} entries, "
              f"{0 if side.owner_rows is None else side.owner_rows.shape[0]} hub rows, "
              f"{side.num_virtual} virtual rows, {int((deg == 0).sum())} rows without entries, "
              f"{_walk_line(side)}", flush=True)
    libs = {s: _block_library(adj, s) for s in ("fwd", "bwd")}
    gen = torch.Generator(device="cuda").manual_seed(17)
    rows = []
    for width in widths:
        for side_name, n_src in (("fwd", adj.shape[1]), ("bwd", adj.shape[0])):
            side = getattr(adj, side_name)
            case = "forward" if side_name == "fwd" else "dh"
            tag = f"{MINCUT_LABEL} {case} F={width} float32"
            h = torch.randn(n_src, width, generator=gen, device="cuda")
            got = side_matmul(side, h, None)
            want = side_matmul_plain(side, h, None)
            again = side_matmul(side, h, None)
            torch.cuda.synchronize()
            _check(torch.equal(got, again), f"{tag}: two runs on the same inputs differ")
            err = max(_max_err(got, want, F32_TOL, f"{tag} vs plain"),
                      _max_err(got, torch.sparse.mm(libs[side_name], h), F32_TOL,
                               f"{tag} vs torch.sparse.mm"))
            bound_ms, bound_by = _bound(bench.csr_pass_bytes(adj, side, width, 4),
                                        2 * int(side.col.shape[0]) * width)
            rows.append(dict(
                name="csr_spmm", case=f"mincut {case}", rank=rank, width=width, dtype="float32",
                max_abs_err=err, ms=_cuda_ms(lambda: side_matmul(side, h, None)),
                plain_ms=_cuda_ms(lambda: side_matmul_plain(side, h, None), iters=3, warmup=1),
                library_ms=_cuda_ms(lambda: torch.sparse.mm(libs[side_name], h)),
                bound_ms=bound_ms, bound_by=bound_by,
                device_ms=_device_ms(lambda: side_matmul(side, h, None)),
                library_device_ms=_device_ms(lambda: torch.sparse.mm(libs[side_name], h))))
    del adj, libs
    torch.cuda.empty_cache()
    print("mincut kernel check (name case rank F dtype: max_abs_err, ms, plain_ms, library_ms, "
          "bound_ms; device ms under the profiler)")
    for r in rows:
        print(f"  {r['name']} {r['case']} rank {r['rank']} F={r['width']} {r['dtype']}: "
              f"{r['max_abs_err']:.3e}, {r['ms']:.4f}, {r['plain_ms']:.4f}, "
              f"{r['library_ms']:.4f}, {r['bound_ms']:.4f} ({r['bound_by']})"
              f"{_device_note(r)}", flush=True)
    return rows


def _mincut_expected(steps):
    """Each kernel's launches on one rank over ``steps`` steps of workload
    17: Kernel A for the encoder and assignment aggregation and for
    ``Ã·S``, each with its ``dh``; nothing else."""
    expected = dict.fromkeys(_KERNELS, 0)
    expected.update(csr_spmm=4 * steps)
    return expected


def mincut_main_path_phase(problem, gpu):
    """Workload 17 at full size on 4 ranks sharing the card (gloo, CUDA
    tensors), 3 warm-up and 20 timed steps, then the profiled steps: the
    loss finite and falling on every rank, exactly 4 Kernel A launches per
    rank and step and no other kernel. Returns the launch totals over the
    ranks and the result."""
    from tf_geometric_tpu_torch import bench
    res = bench.run_mincut_workload(problem, steps=TIMED_ITERS, profile=True)
    steps = res["steps_taken"]
    expected = _mincut_expected(steps)
    totals = dict.fromkeys(_KERNELS, 0)
    for rank, (job,) in enumerate(res["ranks"]):
        got = {k: job["launches"][k] for k in _KERNELS}
        _check(got == expected, f"workload 17 rank {rank}: launches {got} != expected {expected}")
        losses = job["losses"]
        _check(all(math.isfinite(v) for v in losses), f"workload 17: non-finite loss {losses}")
        _check(losses[-1] < losses[0], f"workload 17: loss did not fall: {losses}")
        totals = {k: totals[k] + got[k] for k in _KERNELS}
    per_rank = [float(sorted(job["step_ms"])[len(job["step_ms"]) // 2])
                for (job,) in res["ranks"]]
    line, prof = res["line"], res["profile"]
    first, last = res["ranks"][0][0]["terms"][0], res["ranks"][0][0]["terms"][-1]
    print(f"{bench.MINCUT_WORKLOAD} ({HALO_LABEL}): {res['step_ms']:.4f} ms/step (slowest "
          f"rank's median; ranks {', '.join(f'{v:.4f}' for v in per_rank)}), {line['value']} "
          f"edges/s ({problem.num_edges} nonzeros), vs_baseline {line['vs_baseline']}, "
          f"(loss, ce, cut, orth) {[round(v, 5) for v in first]} -> "
          f"{[round(v, 5) for v in last]}, launches per rank per step "
          f"{ {k: v // steps for k, v in expected.items() if v} }; profiled: card busy "
          f"{prof['card_busy_ms']} ms of {prof['step_ms']:.4f} (ranks {prof['rank_busy_ms']}), "
          f"idle share {prof['card_idle_share']} on {gpu}", flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps(prof), flush=True)
    return totals, res


def _batch_2d_jobs(num_nodes, steps, plain, data=2, graph=2, seed=5):
    """Per rank, a 2-D batch job on a batch of random graphs of 40 to 120
    nodes (4 edges a node, 32 features, 10 classes) with ``num_nodes``
    nodes in all, packed by ``pack_batch_2d`` over data × graph ranks;
    hidden 64, weights ``default_rng(seed)`` normals at scale 0.1."""
    import numpy as np
    from tf_geometric_tpu_torch.parallel import ShardJob, pack_batch_2d
    rng = np.random.default_rng(seed)
    graphs, total = [], 0
    while total < num_nodes:
        n = int(rng.integers(40, 120))
        graphs.append((rng.normal(size=(n, 32)).astype(np.float32),
                       rng.integers(0, n, size=(2, 4 * n)).astype(np.int32),
                       int(rng.integers(0, 10))))
        total += n
    per_shard = -(-len(graphs) // data)
    shard_nodes = max(sum(g[0].shape[0] for g in graphs[d * per_shard:(d + 1) * per_shard])
                      for d in range(data))
    shard_edges = max(sum(g[1].shape[1] for g in graphs[d * per_shard:(d + 1) * per_shard])
                      for d in range(data))
    npc = -(-shard_nodes // graph)
    x, rows, cols, vals, ngi, y, gmask = pack_batch_2d(graphs, data, graph, per_shard, npc,
                                                       shard_edges)
    params = (rng.normal(scale=0.1, size=(32, 64)).astype(np.float32), np.zeros(64, np.float32),
              rng.normal(scale=0.1, size=(64, 10)).astype(np.float32), np.zeros(10, np.float32))
    jobs = []
    for r in range(data * graph):
        d = r // graph
        cell, edges = slice(r * npc, (r + 1) * npc), slice(r * shard_edges, (r + 1) * shard_edges)
        jobs.append([ShardJob(f"batch_2d plain={plain}", "batch_2d", params, x[cell],
                              y[d * per_shard:(d + 1) * per_shard],
                              gmask[d * per_shard:(d + 1) * per_shard],
                              (rows[edges], cols[edges], vals[edges]),
                              {"data": data, "ngi": ngi[cell], "plain": plain}, steps)])
    return jobs, len(graphs)


def mincut_small_plain_phase():
    """3 steps of both MinCut variants (workload 17's set-up at 20,000
    nodes) and of the 2-D step (data 2 × graph 2, a 20,000-node batch) on
    4 ranks through the kernels and through the plain versions on the card:
    rank 0's losses must agree; each kernel run launches Kernel A 4 (MinCut)
    or 2 (2-D) times a step on every rank, each plain run nothing."""
    import torch
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch.parallel import run_ranks
    small = bench.build_mincut_problem(num_nodes=20_000, num_edges=140_000)
    jobs = [[] for _ in range(small.num_parts)]
    names = []
    for variant in ("min_cut", "diff"):
        for plain in (False, True):
            names.append(f"{variant} plain={plain}")
            for r, (job,) in enumerate(bench.mincut_jobs(small, 3, plain=plain,
                                                         variant=variant)):
                jobs[r].append(job._replace(name=names[-1]))
    for plain in (False, True):
        two_d, num_graphs = _batch_2d_jobs(20_000, 3, plain)
        for r, (job,) in enumerate(two_d):
            jobs[r].append(job)
    results = run_ranks(jobs, backend="gloo", device="cuda")
    per_step = {"min_cut": 4, "diff": 4, "batch_2d": 2}
    for rank in results:
        for job in rank:
            kind, plain = job["name"].split(" plain=")
            want = 0 if plain == "True" else 3 * per_step[kind]
            _check(job["launches"]["csr_spmm"] == want
                   and sum(job["launches"].values()) == want,
                   f"{job['name']}: launches {job['launches']}, expected {want} csr_spmm")
    by = {job["name"]: job["losses"] for job in results[0]}
    for kind in ("min_cut", "diff", "batch_2d"):
        kern, plain = by[f"{kind} plain=False"], by[f"{kind} plain=True"]
        err = _max_err(torch.tensor(kern), torch.tensor(plain), F32_TOL,
                       f"3-step losses {kind} (20,000 nodes, {HALO_LABEL})")
        size = f"{num_graphs} graphs" if kind == "batch_2d" else f"{small.num_edges} nonzeros"
        print(f"small {kind} ({size}): kernel {kern} plain {plain} max abs err {err:.3e}",
              flush=True)


def multihost_phase(gpu):
    """``parallel.multihost`` on the card: 4 processes started through
    ``initialize``'s environment rendezvous (``launch_local``), sharing
    card 0 over gloo, train 3 halo-GCN steps on the packed plan of the arxiv
    graph at 20,000 nodes, on the two-level mesh (data 2 × graph 2) and on
    the flat one (graph 4): each process launches Kernel A exactly as its
    plan implies (2 layers × forward and ``dh`` on its local and remote
    block a step, no other kernel), and its losses are those of
    ``run_ranks`` on the same plan (1e-4)."""
    import torch
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch.parallel import launch_local, run_ranks
    name = "gcn_arxiv_halo_p4_fwd_bwd"
    steps = 3
    expected = dict.fromkeys(_KERNELS, 0)
    expected.update(csr_spmm=steps * 2 * 4)
    for two_level, parts in ((True, 2), (False, 4)):
        halo = bench.build_halo_problem(num_parts=parts, num_nodes=20_000, num_edges=140_000)
        hosts = launch_local(dict(halo_spec=halo.gcn_spec, x=halo.x, y=halo.y, mask=halo.mask,
                                  params=halo.params[name], steps=steps), 4, two_level, 2,
                             device="cuda")
        ranks = run_ranks(bench.halo_jobs(halo, name, steps), backend="gloo", device="cuda")
        layout = "two-level (data 2 x graph 2)" if two_level else "flat (graph 4)"
        for r, host in enumerate(hosts):
            got = {k: host["launches"][k] for k in _KERNELS}
            _check(got == expected, f"multihost {layout} process {r}: launches {got} != "
                                    f"expected {expected}")
            _max_err(torch.tensor(host["losses"]), torch.tensor(ranks[0][0]["losses"]), F32_TOL,
                     f"multihost {layout} process {r} vs run_ranks")
        print(f"multihost {layout} ({parts}-part packed plan, {halo.gcn_part.nodes_per_part} "
              f"nodes a part, 4 processes sharing card 0 over gloo): losses "
              f"{hosts[0]['losses']} (run_ranks {ranks[0][0]['losses']}), (data, graph) of each "
              f"process {[(h['data_rank'], h['graph_rank']) for h in hosts]}, Kernel A "
              f"launches per process {expected['csr_spmm']} on {gpu}", flush=True)


def mincut_kernel_entry(rows, totals):
    """The ``{"kernels"}`` entry of Kernel A on workload 17's path, at rank
    1's forward side at F = hidden + C (float32); launches over the ranks of
    its main path."""
    _check(totals["csr_spmm"] > 0, "csr_spmm was not launched on the MinCut path")
    rep = next(r for r in rows if r["case"] == "mincut forward" and r["width"] == max(
        q["width"] for q in rows))
    return {"name": "mincut:csr_spmm", "route": "cuda",
            "source": "tf_geometric_tpu_torch/csrc/csr_spmm.cu",
            "replaces": "tf_geometric_tpu/ops/ell_bucketed.py:214", "launches": totals["csr_spmm"],
            "max_abs_err": max(r["max_abs_err"] for r in rows), "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            "shape": f"rank 1 rectangular block forward, F={rep['width']}, float32; "
                     f"{HALO_LABEL}"}


def halo_kernel_entries(halo_rows, halo_totals):
    """The ``{"kernels"}`` entries of X2 and X5, each named with the kernel
    that serves it; times at the main path's heaviest call (rank 0's local
    block forward at F = 64, float32; the attention at H = 8, d = 8, float32
    with the dropout mask), launches over the ranks of the main path."""
    gcn, gat = halo_totals["gcn_arxiv_halo_p4_fwd_bwd"], halo_totals["gat_arxiv_halo_p4_fwd_bwd"]
    x2 = ("tf_geometric_tpu/ops/ell.py:339", gcn)
    x5 = ("tf_geometric_tpu/ops/ell_attention.py:397", gat)
    gat_src = "tf_geometric_tpu_torch/csrc/gat_attention.cu"
    f32_64 = dict(dtype="float32", width=64)
    specs = (
        ("csr_spmm", "tf_geometric_tpu_torch/csrc/csr_spmm.cu", x2,
         dict(f32_64, case="x2 local forward", rank=0),
         "rank 0 local block forward, F=64, float32"),
        ("sorted_segment_sum", "tf_geometric_tpu_torch/csrc/sorted_segment.cu", x2,
         f32_64, "first block side with hub rows, F=64, float32"),
        ("gat_forward", gat_src, x5, dict(rank=0, heads=8, width=8, dtype="float32", keep=True),
         "rank 0, H=8, d=8, float32, keep 0.4"),
        ("gat_backward_dst", gat_src, x5, dict(rank=0, heads=8, width=8, dtype="float32",
                                                keep=True), "rank 0, H=8, d=8, float32, keep 0.4"),
        ("gat_backward_src", gat_src, x5, dict(rank=0, heads=8, width=8, dtype="float32",
                                                keep=True), "rank 0, H=8, d=8, float32, keep 0.4"))
    entries = []
    for name, path, (replaces, launches), rep_key, shape in specs:
        if name == "sorted_segment_sum" and launches[name] == 0:
            continue  # no halo block has hub rows: Kernel B is not on this path
        _check(launches[name] > 0, f"{name} was not launched on the halo main path")
        mine = [r for r in halo_rows if r["name"] == name and r["case"].startswith(
            "x2" if replaces.endswith("ell.py:339") else "x5")]
        rep = next(r for r in mine if all(r[k] == v for k, v in rep_key.items()))
        entries.append({
            "name": f"{'ell_spmm' if replaces.endswith('ell.py:339') else 'gat_attention_ell'}"
                    f":{name}", "route": "cuda", "source": path, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            "shape": f"{shape}; {HALO_LABEL}"})
    return entries


def _phase(name, fn, *args):
    """Run one phase and print its seconds; its failure propagates."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def x7_kernel_entry(x7_rows, ab_launches):
    """The ``{"kernels"}`` entry of X7 at the A/B's call (the community
    graph, t = 128, F = 128, bf16 tiles, float32 ``h``, forward); its
    launches are the A/B run's, since no training path runs X7."""
    _check(ab_launches > 0, "tiled_spmm was not launched on the A/B path")
    rep = next(r for r in x7_rows if r["case"] == "forward" and r["a_dtype"] == "bfloat16"
               and r["dtype"] == "float32")
    return {"name": "tiled_spmm", "route": "cuda",
            "source": "tf_geometric_tpu_torch/csrc/tiled_spmm.cu",
            "replaces": "tf_geometric_tpu/ops/tiled_spmm.py:159", "launches": ab_launches,
            "max_abs_err": max(r["max_abs_err"] for r in x7_rows), "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            "shape": "community graph, t=128, F=128, bf16 tiles, float32 h, forward; "
                     "launches of the A/B twin (bench --tiled-ab), 0 on every training path"}


# ---------------------------------------------------------------------------
# another checkout's hub merge (P1) beside this one's, in turns on one card:
#   python3 chip_smoke.py --against DIR   (outputs held equal: a parent tree)
#   python3 chip_smoke.py --trial DIR     (outputs not held: a throwaway trial)
# DIR holds a copy of the port package (``DIR/tf_geometric_tpu_torch``),
# built from its own csrc/ and run through its own wrappers.
# ---------------------------------------------------------------------------

def _load_tree(root, alias):
    """The port package under ``root`` imported as ``alias``."""
    import importlib.util
    from pathlib import Path
    pkg = Path(root).resolve() / "tf_geometric_tpu_torch"
    spec = importlib.util.spec_from_file_location(alias, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def _ptxas_lines(log, keys):
    """``(entry, usage)`` of every kernel whose mangled name holds one of
    ``keys``, from nvcc's ``-Xptxas=-v`` output."""
    out, entry = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "registers" in ln and entry and any(k in entry for k in keys):
            out.append((entry, ln.split(":", 1)[1].strip()))
            entry = None
    return out


def _blocks_per_sm(usage, threads):
    """Resident blocks per SM of an H100 for a kernel of ``threads`` threads
    with ptxas's ``usage`` line (registers and static shared memory): 64 Ki
    registers (allocated per warp in units of 256), 228 KiB of shared memory
    (1 KiB reserved per block), 2,048 threads, 32 blocks."""
    import re
    regs = int(re.search(r"Used (\d+) registers", usage).group(1))
    smem = re.search(r"(\d+) bytes smem", usage)
    smem = int(smem.group(1)) if smem else 0
    warps = -(-threads // 32)
    by_regs = 65536 // (warps * (-(-regs * 32 // 256) * 256))
    by_smem = 233472 // (smem + 1024)
    return min(by_regs, by_smem, 2048 // threads, 32)


def _in_turns(fns, what):
    """Time ``fns`` ({label: fn}) in turns, first, second, second, first:
    CUDA events and device time; prints one line per turn."""
    labels = list(fns)
    times = {lb: [] for lb in labels}
    for lb in (labels[0], labels[1], labels[1], labels[0]):
        ms, dev = _cuda_ms(fns[lb]), _device_ms(fns[lb])
        times[lb].append((ms, dev))
        print(f"  {what} {lb}: {ms:.4f} ms (device {_ms_text(dev)})", flush=True)
    return times


def _launch_floor_ms():
    """The launch floor: Kernel B on one empty segment (one block that
    returns at once), CUDA events and device time."""
    import torch
    from tf_geometric_tpu_torch.ops.sorted_segment import launch_sorted_segment_sum
    msg = torch.zeros((0, 1), device="cuda")
    seg_ptr = torch.zeros(2, dtype=torch.int32, device="cuda")
    rows = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = torch.zeros((1, 1), device="cuda")

    def call():
        return launch_sorted_segment_sum(msg, seg_ptr, out, True, rows)
    return _cuda_ms(call), _device_ms(call)


# side_matmul's cases of the P1 comparison: (problem, side, F, dtype name):
# the canonical step's first layer, workloads 10-12's width, and the halo
# GCN's rank-0 local block at its first layer's width
P1_CASES = (("arxiv", "fwd", 256, "bfloat16"), ("arxiv", "bwd", 256, "bfloat16"),
            ("arxiv", "fwd", 40, "float32"), ("arxiv", "bwd", 40, "float32"),
            ("halo rank 0 local", "fwd", 64, "float32"), ("halo rank 0 local", "bwd", 64,
                                                          "float32"))
P1_WORKLOADS = ("gcn_arxiv_fwd_bwd", "gcn_arxiv_canonical_fwd_bwd", "sgc_arxiv_fwd_bwd",
                "appnp_arxiv_fwd_bwd", "ssgc_arxiv_fwd_bwd")


def compare_phase(other_dir, hold_outputs):
    """P1's hub merge beside another tree's, each through its own wrappers,
    in turns (other, this, this, other; CUDA events and device time):
    ``side_matmul`` at ``P1_CASES`` (with the merge in Kernel A's launch:
    one launch; without: Kernel A, then Kernel B), each tree's Kernel A
    without the merge and its Kernel B alone on the same side, the launch
    floor (``_launch_floor_ms``), then workloads 1, 1b and 10-12 on each
    tree's own problem. Both trees read the same ``CsrSide`` (a tree that
    lacks the merge ignores its tickets). With ``hold_outputs`` the two
    trees' products are held equal: float32 bit for bit, bfloat16 within
    2e-2 (the merge rounds once where two launches round twice)."""
    import importlib
    import torch
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch.ops import _build
    from tf_geometric_tpu_torch.ops import csr_spmm as cs
    from tf_geometric_tpu_torch.ops import sorted_segment as ss
    _load_tree(other_dir, "other_tfg")
    o_build = importlib.import_module("other_tfg.ops._build")
    o_cs = importlib.import_module("other_tfg.ops.csr_spmm")
    o_ss = importlib.import_module("other_tfg.ops.sorted_segment")
    o_bench = importlib.import_module("other_tfg.bench")
    t0 = time.perf_counter()
    _build.build_all()
    o_build.build_all()
    print(f"build (this tree and {other_dir}): {time.perf_counter() - t0:.1f} s", flush=True)
    for label, logs in (("this", _build.build_logs), ("other", o_build.build_logs)):
        for entry, usage in _ptxas_lines(logs.get("csr_spmm.cu", ""), ("csr_spmm",)):
            print(f"  {label} {entry}: {usage}; {_blocks_per_sm(usage, 256)} blocks/SM "
                  f"at 256 threads", flush=True)
    floor_ms, floor_dev = _launch_floor_ms()
    print(f"launch floor (Kernel B on one empty segment): {floor_ms:.4f} ms "
          f"(device {_ms_text(floor_dev)})", flush=True)

    problems = {"this": bench.build_problem(device="cuda"),
                "other": o_bench.build_problem(device="cuda")}
    halo = bench.build_halo_problem()
    adjs = {"arxiv": problems["this"].adj, "halo rank 0 local": halo.gcn_spec.local[0].to("cuda")}
    gen = torch.Generator(device="cuda").manual_seed(12)
    for graph, side_name, width, dtype_name in P1_CASES:
        adj = adjs[graph]
        side, diag = getattr(adj, side_name), adj.diag_val
        dtype = getattr(torch, dtype_name)
        n_src = adj.shape[1] if side_name == "fwd" else adj.shape[0]
        h = torch.randn(n_src, width, generator=gen, device="cuda").to(dtype)
        tag = f"p1 {graph} {side_name} F={width} {dtype_name}"
        mine, theirs = cs.side_matmul(side, h, diag), o_cs.side_matmul(side, h, diag)
        torch.cuda.synchronize()
        same = torch.equal(mine, theirs)
        print(f"{tag}: {side.num_virtual} virtual rows of "
              f"{0 if side.owner_rows is None else side.owner_rows.shape[0]} hubs; this "
              f"tree's product equals the other's bit for bit: {same}", flush=True)
        if hold_outputs:
            if dtype == torch.float32:
                _check(same, f"{tag}: this tree differs from {other_dir}")
            else:
                _max_err(mine, theirs, BF16_TOL, f"{tag}: this tree against {other_dir}")
        _in_turns({"other": lambda: o_cs.side_matmul(side, h, diag),
                   "this": lambda: cs.side_matmul(side, h, diag)}, f"{tag} side_matmul")
        args = (side.row_ptr, side.col, side.val, h.contiguous(), diag, side.num_rows)
        _in_turns({"other": lambda: o_cs.launch_csr_spmm(*args),
                   "this": lambda: cs.launch_csr_spmm(*args)}, f"{tag} Kernel A, no merge")
        if side.num_virtual:
            out, part = cs.launch_csr_spmm(*args)
            merge = (part, side.owner_ptr, out, True, side.owner_rows)
            _in_turns({"other": lambda: o_ss.launch_sorted_segment_sum(*merge),
                       "this": lambda: ss.launch_sorted_segment_sum(*merge)},
                      f"{tag} Kernel B alone")
    del adjs, halo
    torch.cuda.empty_cache()

    runners = {"other": o_bench.run_workload, "this": bench.run_workload}
    for name in P1_WORKLOADS:
        for lb in ("other", "this", "this", "other"):
            res = runners[lb](problems[lb], name)
            print(f"workload {name} {lb}: {res['step_ms']:.4f} ms/step, "
                  f"{res['line']['value']} {res['line']['unit']}, losses "
                  f"{res['losses'][0]:.6f} -> {res['losses'][-1]:.6f}", flush=True)


def compare_main(argv):
    import torch
    if len(argv) != 2 or argv[0] not in ("--against", "--trial"):
        print("usage: chip_smoke.py [--against DIR | --trial DIR]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = _gpu_line()
    print(f"gpu: {gpu}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    _phase(f"compare with {argv[1]}", compare_phase, argv[1], argv[0] == "--against")
    return 0


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 1
    start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = _gpu_line()
    print(f"gpu: {gpu}", flush=True)
    import os
    import numpy as np
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, numpy {np.__version__}, "
          f"{os.cpu_count()} host CPUs", flush=True)

    from tf_geometric_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(paths)} sources", flush=True)
    for src, log in _build.build_logs.items():
        usage = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        spills = [ln for ln in log.splitlines()
                  if "spill stores" in ln and " 0 bytes spill stores" not in ln]
        print(f"  {src}: {len(spills)} of {len(usage)} instances spill; "
              + " | ".join(usage[:8]), flush=True)

    from tf_geometric_tpu_torch import bench, native
    t0 = time.perf_counter()
    _check(native.available(), "the native host library (native/graph_ops.cpp) did not build")
    print(f"native host library: built and loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)
    from tf_geometric_tpu_torch.nn.conv.gcn import gcn_norm_adj
    from tf_geometric_tpu_torch.ops.csr_spmm import CsrAdj
    from tf_geometric_tpu_torch.datasets import synthetic_ogbn_arxiv_like
    from tf_geometric_tpu_torch.sparse import SparseMatrix
    t0 = time.perf_counter()
    problem = bench.build_problem(device="cuda")
    graph = synthetic_ogbn_arxiv_like()
    n = graph.num_nodes
    normed = gcn_norm_adj(SparseMatrix(graph.edge_index, graph.edge_weight, (n, n),
                                       device="cuda"))
    print(f"arxiv problem built in {time.perf_counter() - t0:.1f} s: {problem.adj}",
          flush=True)
    rows = _phase("kernels A/B", kernel_phase, problem, normed)
    # the transposed adjacency's backward side holds the hubs (dh with a merge)
    transposed = CsrAdj.from_coo(normed.index.flip(0), normed.value, normed.shape,
                                 split_diag=True, device="cuda")
    _phase("hub merge", merge_phase, [("arxiv", problem.adj), ("arxiv transposed", transposed)],
           MERGE_WIDTHS)
    del transposed
    _phase("split sweep", split_sweep, normed)
    rows += _phase("x6", spmm_kernel_phase, normed, n)
    del normed
    rows += _phase("gat kernels", gat_kernel_phase, problem.gat_layout, problem.gat_edges)
    rows += _phase("x3", multihead_kernel_phase, problem.gat_layout)
    del problem
    torch.cuda.empty_cache()
    x7_rows = _phase("x7", x7_kernel_phase, _phase("x7 small", x7_small_phase))
    t0 = time.perf_counter()
    sage_problem = bench.build_sage_problem(device="cuda")
    print(f"reddit problem built in {time.perf_counter() - t0:.1f} s", flush=True)
    rows += _phase("sage kernels", sage_kernel_phase, sage_problem, _skew_graphs(graph))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    host_sage = bench.build_host_sage_problem(device="cuda")
    print(f"reddit host-sampler problem built in {time.perf_counter() - t0:.1f} s", flush=True)
    _phase("host sage", host_sage_phase, host_sage, gpu)
    _phase("flat vs dense", flat_dense_phase, graph, gpu)
    torch.cuda.empty_cache()
    graph_problem = bench.build_graph_problem(device="cuda")
    print(f"gin batch: {graph_problem.num_graphs} graphs, {graph_problem.x.shape[0]} padded "
          f"nodes, {graph_problem.edge_index.shape[1]} padded edges "
          f"({graph_problem.real_edges} real)", flush=True)
    rows += _phase("gin kernels", gin_kernel_phase, graph_problem)
    pool_rows = _phase("pool kernels", pool_kernel_phase, graph_problem)
    t0 = time.perf_counter()
    gae = bench.build_gae_problem(device="cuda")
    print(f"gae problem built in {time.perf_counter() - t0:.1f} s (split and test negatives on "
          f"the host)", flush=True)
    gae_rows = _phase("gae kernels", gae_kernel_phase, gae)
    gae_launches = _phase("gae", gae_phase, gae, gpu)
    del gae
    torch.cuda.empty_cache()
    planetoid = _phase("planetoid demos", planetoid_phase, gpu)
    h2h = _phase("head-to-head twins", head_to_head_phase, gpu)
    t0 = time.perf_counter()
    halo = bench.build_halo_problem()
    print(f"halo problem built in {time.perf_counter() - t0:.1f} s: partition_order "
          f"{halo.partition_s:.1f} s on the host (native library: {native.available()}), partitions "
          f"and plans {halo.plan_s:.1f} s; {halo.num_parts} ranks of "
          f"{halo.gcn_part.nodes_per_part} nodes; GCN cap {halo.gcn_spec.capacity}, "
          f"halo_fraction {halo.gcn_spec.halo_fraction:.4f}; GAT cap {halo.gat_spec.capacity}, "
          f"halo_fraction {halo.gat_spec.halo_fraction:.4f}, {halo.gat_spec.num_edges} edge "
          f"ids per rank", flush=True)
    _phase("hub merge (halo blocks)", merge_phase,
           [(f"rank {r} {kind}", getattr(halo.gcn_spec, kind)[r].to("cuda"))
            for r in range(halo.num_parts) for kind in ("local", "remote")], X2_WIDTHS)
    halo_rows = _phase("x2", x2_kernel_phase, halo) + _phase("x5", x5_kernel_phase, halo)

    totals, results = _phase("main path", main_path_phase, gpu, sage_problem, graph_problem,
                             host_sage)
    del sage_problem, host_sage
    torch.cuda.empty_cache()
    _phase("pool profile", pool_profile_phase, graph_problem, results, gpu)
    _phase("pool small", pool_small_phase, graph_problem)
    ab_launches, _ = _phase("x7 main path (tiled A/B)", x7_main_path_phase, gpu)
    _phase("small plain", small_plain_phase, graph_problem)
    _phase("small propagation", propagation_small_phase)
    _phase("entry", entry_phase)
    halo_totals, halo_results = _phase("halo main path", halo_main_path_phase, halo, gpu)
    _phase("halo single process", halo_single_process_check, halo, halo_results)
    _phase("halo small plain", halo_small_plain_phase)
    del halo
    sampled = bench.build_sampled_sage_problem()
    sampled_rows = _phase("sampled sage kernels", sampled_sage_kernel_phase, sampled)
    sampled_totals, sampled_res = _phase("sampled sage main path",
                                         sampled_sage_main_path_phase, sampled, gpu)
    _phase("sampled sage small plain", sampled_sage_small_plain_phase)
    del sampled
    t0 = time.perf_counter()
    mincut = bench.build_mincut_problem()
    print(f"mincut problem built in {time.perf_counter() - t0:.1f} s: partition_order "
          f"{mincut.partition_s:.1f} s, normalization, partition and rank CSR "
          f"{mincut.plan_s:.1f} s; {mincut.num_parts} ranks of "
          f"{mincut.part.nodes_per_part} nodes, {mincut.num_edges} nonzeros", flush=True)
    mincut_rows = _phase("mincut kernels", mincut_kernel_phase, mincut)
    mincut_totals, mincut_res = _phase("mincut main path", mincut_main_path_phase, mincut, gpu)
    del mincut
    _phase("mincut small plain", mincut_small_plain_phase)
    _phase("multihost", multihost_phase, gpu)
    _phase("dryrun", dryrun_phase)

    # one entry per kernel, at its heaviest main-path call: the SpMM kernels
    # on the forward side at F=256 in bfloat16 (the canonical step's first
    # layer), the attention kernels at the bench's H=8, d=32 in bfloat16,
    # the SAGE kernels at the first layer's k=25 (aggregations: F=128, float32),
    # the H-head SpMM as the COO forward on the arxiv COO at GIN's F=64 in
    # float32, the H-head SDDMM at workload 5's d_att (H=8, d_v=8, float32)
    spmm_rep = dict(side="fwd", width=256, dtype="bfloat16")
    sage_rep = dict(graph="reddit", k=25, width=128, dtype="float32")
    sage_src = ("tf_geometric_tpu_torch/csrc/fixed_k.cu",
                "tf_geometric_tpu/nn/conv/graph_sage.py:67", sage_rep, "k=25, F=128, float32")
    gat_rep = dict(heads=8, width=32, dtype="bfloat16", keep=False)
    gat_src = ("tf_geometric_tpu_torch/csrc/gat_attention.cu",
               "tf_geometric_tpu/ops/ell_attention_bucketed.py:933")
    source = {"csr_spmm": ("tf_geometric_tpu_torch/csrc/csr_spmm.cu",
                           "tf_geometric_tpu/ops/ell_bucketed.py:214", spmm_rep,
                           "fwd side, F=256, bfloat16"),
              "sorted_segment_sum": ("tf_geometric_tpu_torch/csrc/sorted_segment.cu",
                                     "tf_geometric_tpu/ops/pallas_segment.py:84", spmm_rep,
                                     "fwd side's hub partials, F=256, bfloat16; the main "
                                     "path's hub merges run in Kernel A's launch (csr_spmm)"),
              "gat_forward": gat_src + (gat_rep, "H=8, d=32, bfloat16, no dropout"),
              "gat_backward_dst": gat_src + (gat_rep, "H=8, d=32, bfloat16, no dropout"),
              "gat_backward_src": gat_src + (gat_rep, "H=8, d=32, bfloat16, no dropout"),
              "fixed_k_draw": ("tf_geometric_tpu_torch/csrc/fixed_k.cu",
                               "tf_geometric_tpu/nn/sampling/device_sampler.py:33",
                               dict(k=25, weighted=False), "k=25, no weight table"),
              "fixed_k_forward": sage_src,
              "fixed_k_backward": sage_src,
              # the one SpMM kernel serves the COO SpMM (GIN's product) and the
              # multi-head SpMM; the SDDMM their value and attention gradients
              "spmm_heads": ("tf_geometric_tpu_torch/csrc/spmm_heads.cu",
                             "tf_geometric_tpu/ops/spmm.py:67",
                             dict(case="x6 forward", width=64, dtype="float32"),
                             "COO SpMM forward, F=64, float32"),
              "sddmm_heads": ("tf_geometric_tpu_torch/csrc/spmm_heads.cu",
                              "tf_geometric_tpu/ops/ell.py:325",
                              dict(case="x3 d_att", heads=8, width=8, dtype="float32"),
                              "multi-head d_att, H=8, d_v=8, float32")}
    also_replaces = {"spmm_heads": "tf_geometric_tpu/ops/ell.py:325",
                     "sddmm_heads": "tf_geometric_tpu/ops/spmm.py:80"}
    kernels = []
    for name, launches in zip(_KERNELS, totals):
        if name == "tiled_spmm":
            _check(launches == 0, f"tiled_spmm ran {launches} times on a training path")
            kernels.append(x7_kernel_entry(x7_rows, ab_launches))
            continue
        path, replaces, rep_key, shape = source[name]
        mine = [r for r in rows if r["name"] == name]
        rep = next(r for r in mine if all(r[k] == v for k, v in rep_key.items()))
        if name == "sorted_segment_sum":
            # the main path's hub merges run in Kernel A's launch
            _check(launches == 0, f"Kernel B ran {launches} times on the main path")
        else:
            _check(launches > 0, f"{name} was not launched on the main path")
        entry = {
            "name": name, "route": "cuda", "source": path, "replaces": replaces,
            "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"], "shape": shape}
        if name in also_replaces:
            entry["also_replaces"] = also_replaces[name]
        if name in ("fixed_k_forward", "fixed_k_backward"):
            entry.update(library_from_draw_ms=rep["library_from_draw_ms"],
                         hbm_gather_ms=rep["hbm_gather_ms"])
        kernels.append(entry)
    kernels += halo_kernel_entries(halo_rows, halo_totals)
    kernels += sampled_sage_kernel_entries(sampled_rows, sampled_totals)
    kernels.append(mincut_kernel_entry(mincut_rows, mincut_totals))
    kernels += pool_kernel_entries(pool_rows, results)
    kernels.append(gae_kernel_entry(gae_rows, gae_launches))
    kernels += planetoid_kernel_entries(planetoid)
    kernels += head_to_head_kernel_entries(h2h)
    for name, res in results.items():
        print(f"{name}: {res['step_ms']:.4f} ms/step, {res['line']['value']} "
              f"{res['line']['unit']} ({gpu})", flush=True)
    for name, res in [*halo_results.items(), (bench.SAMPLED_SAGE_WORKLOAD, sampled_res),
                      (bench.MINCUT_WORKLOAD, mincut_res)]:
        print(f"{name}: {res['step_ms']:.4f} ms/step, {res['line']['value']} "
              f"{res['line']['unit']} ({HALO_LABEL}; {gpu})", flush=True)
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(compare_main(sys.argv[1:]) if len(sys.argv) > 1 else main())
