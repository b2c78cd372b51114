#!/usr/bin/env python3
"""On-card check of the PyTorch / CUDA port (``tf_geometric_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:

1. Device: refuse to run without CUDA; print the card's name and power limit.
2. Build: compile every kernel source under ``tf_geometric_tpu_torch/csrc``
   with nvcc (all at once) and print the build time.
3. Kernels: on the ogbn-arxiv-shaped graph's normalized ``CsrAdj`` (both
   product directions), at F in {40, 128, 256}, in float32 and bfloat16,
   hold Kernel A (``csr_spmm``) and Kernel B (``sorted_segment_sum``)
   against their plain PyTorch versions on the same inputs (float32:
   rtol = atol = 1e-4, order of summation only; bfloat16: rtol = atol =
   2e-2, one bf16 rounding of differently ordered float32 sums), and the
   composed product against ``torch.sparse.mm`` in float32. Time each
   kernel, its plain version and ``torch.sparse.mm`` (the library yardstick,
   never called by the port) with CUDA events, beside its byte bound.
4. GAT kernels: on the self-looped arxiv graph's ``CsrGatLayout``, at
   H = 8, d = 32, at the odd shape H = 2, d = 20, at one wide head
   (H = 1, d = 256) and at (H, d) = (4, 8), (8, 4), (4, 64), which give
   every other lane-group size (1, 2 and 16 lanes per head), in float32 and
   bfloat16, with no dropout and with a 0.3 keep mask, hold the forward
   kernel and both backward kernels against their plain versions on the
   same inputs (float32: rtol = atol = 1e-4 for out and lse, 1e-3 for the
   gradients and D, whose sums chain through a recomputed softmax; bfloat16:
   2e-2). Time each kernel and its plain version with CUDA events beside
   its bound; print the destination side's hub rows and longest row.
5. Main path: zero the launch counters, build the bench problem and train
   ``bench`` workloads 1, 1b and 3 (the 8-head GAT) at full arxiv size;
   check that the loss is finite and falls and that each kernel ran
   exactly as often as the layouts imply (GAT: one forward and two
   backward launches per step). Then train 3 steps of each workload at a
   small size through the kernels and through the plain versions on the
   card and compare the losses, and run ``entry()`` on the card against
   its CPU run.

The second-to-last line of output is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""
import contextlib
import json
import math
import subprocess
import sys
import time

F32_TOL = dict(rtol=1e-4, atol=1e-4)
F32_GRAD_TOL = dict(rtol=1e-3, atol=1e-3)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# (heads, head width): the bench's, an odd width, one head over two slices,
# and the lane groups the others miss (float32 / bfloat16 lanes per head:
# (4, 8) 2 / 1, (8, 4) 1 / 1, (4, 64) 16 / 8)
GAT_SHAPES = ((8, 32), (2, 20), (1, 256), (4, 8), (8, 4), (4, 64))
GAT_KEEP_RATE = 0.3
WIDTHS = (40, 128, 256)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
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
              f"max_row_len={int(side.row_ptr.diff().max())}", flush=True)
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
                err_a = max(_max_err(out_k, out_p, tol, f"csr_spmm out {tag}"),
                            _max_err(part_k, part_p, F32_TOL, f"csr_spmm partial {tag}"))
                nnz = int(side.col.shape[0])
                a_bytes = (n_src * width * elt + side.num_rows * width * elt
                           + side.num_virtual * width * 4 + 4 * side.row_ptr.shape[0]
                           + 8 * nnz + 4 * side.num_rows)
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
                rows.append(dict(
                    name="csr_spmm", side=side_name, width=width, dtype=str(dtype)[6:],
                    max_abs_err=err_a, ms=_cuda_ms(lambda: launch_csr_spmm(*args)),
                    plain_ms=_cuda_ms(lambda: csr_spmm_plain(*args)),
                    library_ms=_cuda_ms(lambda: torch.sparse.mm(lib, h)),
                    bound_ms=1e3 * max(a_bytes / HBM_BYTES_PER_S, a_flops / F32_FLOPS_PER_S),
                    bound_by="bytes" if a_bytes / HBM_BYTES_PER_S >= a_flops / F32_FLOPS_PER_S
                    else "operations"))
                if not side.num_virtual:
                    continue
                # Kernel B as the main path runs it: the hubs' partials added
                # into their owner rows of Kernel A's output
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
                    else "operations"))
    print("kernel check (name side F dtype: max_abs_err, ms, plain_ms, library_ms, bound_ms)")
    for r in rows:
        print(f"  {r['name']} {r['side']} F={r['width']} {r['dtype']}: "
              f"{r['max_abs_err']:.3e}, {r['ms']:.4f}, {r['plain_ms']:.4f}, "
              f"{r['library_ms']:.4f}, "
              f"{r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    return rows


def gat_kernel_phase(layout, edges):
    """The three attention kernels against their plain versions at each GAT
    shape, dtype and dropout setting; returns one row per kernel and case.
    Also times the bench-shape forward and destination-side backward on the
    same graph with every row walked by one warp (no hub blocks), which
    shows what the hub rows would cost without them."""
    import torch
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch.ops import gat_attention as ga
    deg = layout.dst.row_ptr.diff()
    hub_cost = None
    print(f"gat layout: {layout}; destination side: {int(layout.dst.hubs.shape[0])} hub rows "
          f"(> {layout.dst.hub_degree} edges), longest row {int(deg.max())}; source side: "
          f"{int(layout.src.hubs.shape[0])} hub rows, longest row "
          f"{int(layout.src.row_ptr.diff().max())}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    n, rows = layout.num_nodes, []
    for heads, width in GAT_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            fwd_tol, grad_tol = (F32_TOL, F32_GRAD_TOL) if f32 else (BF16_TOL, BF16_TOL)
            Q, K, V, dy = (torch.randn(n, heads * width, generator=gen, device="cuda").to(dtype)
                           for _ in range(4))
            for with_keep in (False, True):
                keep = None
                if with_keep:
                    keep = ((torch.rand(layout.num_edges, heads, generator=gen, device="cuda")
                             >= GAT_KEEP_RATE).float() / (1.0 - GAT_KEEP_RATE))
                tag = (f"H={heads} d={width} {str(dtype)[6:]} "
                       f"{'keep 0.7' if with_keep else 'no dropout'}")
                fwd_args = (layout.dst, Q, K, V, heads, keep)
                out, lse = ga.launch_gat_forward(*fwd_args)
                out_p, lse_p = ga.gat_forward_plain(*fwd_args)
                dst_args = (layout.dst, Q, K, V, out, lse, dy, heads, keep)
                dQ, D = ga.launch_gat_backward_dst(*dst_args)
                dQ_p, D_p = ga.gat_backward_dst_plain(*dst_args)
                src_args = (layout.src, Q, K, V, dy, lse, D, heads, keep)
                dK, dV = ga.launch_gat_backward_src(*src_args)
                dK_p, dV_p = ga.gat_backward_src_plain(*src_args)
                torch.cuda.synchronize()
                errs = (
                    max(_max_err(out, out_p, fwd_tol, f"gat forward out {tag}"),
                        _max_err(lse, lse_p, fwd_tol, f"gat forward lse {tag}")),
                    max(_max_err(dQ, dQ_p, grad_tol, f"gat backward dQ {tag}"),
                        _max_err(D, D_p, grad_tol, f"gat backward D {tag}")),
                    max(_max_err(dK, dK_p, grad_tol, f"gat backward dK {tag}"),
                        _max_err(dV, dV_p, grad_tol, f"gat backward dV {tag}")))
                del out_p, lse_p, dQ_p, D_p, dK_p, dV_p
                timed = heads == bench.GAT_HEADS and width == bench.GAT_UNITS // bench.GAT_HEADS
                calls = ((ga.launch_gat_forward, ga.gat_forward_plain, fwd_args),
                         (ga.launch_gat_backward_dst, ga.gat_backward_dst_plain, dst_args),
                         (ga.launch_gat_backward_src, ga.gat_backward_src_plain, src_args))
                for kind, ((kernel, plain, args), err) in enumerate(zip(calls, errs)):
                    nbytes = bench.gat_pass_bytes(layout, kind, heads, width, 2 if not f32 else 4,
                                                  with_keep)
                    flops = bench.gat_pass_flops(layout, kind, heads, width)
                    rows.append(dict(
                        name=("gat_forward", "gat_backward_dst", "gat_backward_src")[kind],
                        heads=heads, width=width, dtype=str(dtype)[6:], keep=with_keep,
                        max_abs_err=err,
                        ms=_cuda_ms(lambda: kernel(*args)) if timed else None,
                        plain_ms=_cuda_ms(lambda: plain(*args), iters=3, warmup=1)
                        if timed else None,
                        library_ms=None,
                        bound_ms=1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S),
                        bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S
                        else "operations"))
                if timed and not f32 and not with_keep:
                    flat = ga.CsrGatLayout.build(edges, n, hub_degree=n + 1, device="cuda")
                    hub_cost = (_cuda_ms(lambda: ga.launch_gat_forward(flat.dst, Q, K, V, heads)),
                                _cuda_ms(lambda: ga.launch_gat_backward_dst(
                                    flat.dst, Q, K, V, out, lse, dy, heads)))
                    del flat
                torch.cuda.empty_cache()
    print(f"gat hub rows walked by single warps (H=8, d=32, bfloat16): forward "
          f"{hub_cost[0]:.4f} ms, backward dst {hub_cost[1]:.4f} ms", flush=True)
    print("gat kernel check (name H d dtype dropout: max_abs_err, ms, plain_ms, bound_ms)")
    for r in rows:
        times = (f"{r['ms']:.4f}, {r['plain_ms']:.4f}" if r["ms"] is not None
                 else "not timed, not timed")
        print(f"  {r['name']} H={r['heads']} d={r['width']} {r['dtype']} "
              f"{'keep' if r['keep'] else 'none'}: {r['max_abs_err']:.3e}, {times}, "
              f"{r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    return rows


# every kernel wrapper of the main path, in the order of the counts below
_KERNELS = ("csr_spmm", "sorted_segment_sum", "gat_forward", "gat_backward_dst",
            "gat_backward_src")


def _wrappers():
    from tf_geometric_tpu_torch.ops import gat_attention as ga
    from tf_geometric_tpu_torch.ops.csr_spmm import launch_csr_spmm
    from tf_geometric_tpu_torch.ops.sorted_segment import launch_sorted_segment_sum
    return (launch_csr_spmm, launch_sorted_segment_sum, ga.launch_gat_forward,
            ga.launch_gat_backward_dst, ga.launch_gat_backward_src)


def _launch_counts():
    return [w.launches for w in _wrappers()]


def _zero_launch_counts():
    for w in _wrappers():
        w.launches = 0


def main_path_phase(gpu):
    """Workloads 1, 1b and 3 at full arxiv size through the kernels; returns
    the launch totals of the run and the bench results."""
    from tf_geometric_tpu_torch import bench
    _zero_launch_counts()
    problem = bench.build_problem(device="cuda")
    adj = problem.adj
    hubs = int(adj.fwd.num_virtual > 0) + int(adj.bwd.num_virtual > 0)
    # the precompute P = Â·x is one forward product
    expected = [1, int(adj.fwd.num_virtual > 0), 0, 0, 0]
    _check(_launch_counts() == expected,
           f"precompute launches {_launch_counts()} != {expected}")
    totals = _launch_counts()
    results = {}
    for name in bench.WORKLOADS:
        _zero_launch_counts()
        res = bench.run_workload(problem, name)
        counts = _launch_counts()
        steps = res["steps_taken"]
        if name in bench.GCN_WORKLOADS:
            # per step and SpMM: Kernel A forward + backward, Kernel B per split side
            spmms = 1 if name == "gcn_arxiv_fwd_bwd" else 2
            expected = [steps * spmms * 2, steps * spmms * hubs, 0, 0, 0]
        else:
            # per step: one forward and two backward attention launches (hub
            # rows are blocks of the same launches)
            expected = [0, 0, steps, steps, steps]
        _check(counts == expected, f"{name}: launches {counts} != expected {expected}")
        losses = res["losses"]
        _check(all(math.isfinite(v) for v in losses), f"{name}: non-finite loss {losses}")
        _check(losses[-1] < losses[0], f"{name}: loss did not fall: {losses}")
        totals = [t + c for t, c in zip(totals, counts)]
        results[name] = res
        print(f"{name}: step {res['step_ms']:.4f} ms, {res['line']['value']} edges/s, "
              f"vs_baseline {res['line']['vs_baseline']}, loss {losses[0]:.5f} -> "
              f"{losses[-1]:.5f}, launches {dict(zip(_KERNELS, counts))} on {gpu}", flush=True)
        print(json.dumps(res["line"]), flush=True)
    return totals, results


def small_plain_phase():
    """3 steps of each workload at a small size through the kernels and
    through the plain versions on the card: the losses must agree."""
    import torch
    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch.ops import config as kernel_config
    for spmm_bf16, tol in ((False, F32_TOL), (True, BF16_TOL)):
        problem = bench.build_problem(20_000, 140_000, device="cuda", spmm_bf16=spmm_bf16)
        _check(problem.adj.fwd.num_virtual > 0, "small problem has no hub rows")
        _check(problem.gat_layout.dst.hubs.numel() > 0, "small GAT layout has no hub rows")
        for name, wl in bench.WORKLOADS.items():
            losses = {}
            for label in ("kernel", "plain"):
                params = wl.init(problem.x.shape[1], device="cuda")
                step = bench.make_step(lambda p: wl.loss(p, problem, spmm_bf16), params, wl.lr)
                with (kernel_config.use_plain_versions() if label == "plain"
                      else contextlib.nullcontext()):
                    losses[label] = torch.stack([step() for _ in range(3)])
            err = _max_err(losses["kernel"], losses["plain"], tol,
                           f"3-step losses {name} bf16={spmm_bf16}")
            print(f"small {name} bf16={spmm_bf16}: kernel "
                  f"{losses['kernel'].tolist()} plain {losses['plain'].tolist()} "
                  f"max abs err {err:.3e}", flush=True)


def entry_phase():
    from tf_geometric_tpu_torch.entry import entry
    fn, args = entry()
    out = fn(*args)
    fn_cpu, args_cpu = entry(device="cpu")
    err = _max_err(out.cpu(), fn_cpu(*args_cpu), F32_TOL, "entry() on the card vs the CPU")
    print(f"entry(): output {tuple(out.shape)}, max abs err vs CPU {err:.3e}", flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = _gpu_line()
    print(f"gpu: {gpu}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    from tf_geometric_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(paths)} sources", flush=True)
    for src, log in _build.build_logs.items():
        usage = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {src}: " + " | ".join(usage[:8]), flush=True)

    from tf_geometric_tpu_torch import bench
    from tf_geometric_tpu_torch.nn.conv.gcn import gcn_norm_adj
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
    rows = kernel_phase(problem, normed)
    del normed
    rows += gat_kernel_phase(problem.gat_layout, problem.gat_edges)
    del problem
    torch.cuda.empty_cache()

    totals, results = main_path_phase(gpu)
    small_plain_phase()
    entry_phase()

    # one entry per kernel, at its heaviest main-path call: the SpMM kernels
    # on the forward side at F=256 in bfloat16 (the canonical step's first
    # layer), the attention kernels at the bench's H=8, d=32 in bfloat16
    spmm_rep = dict(side="fwd", width=256, dtype="bfloat16")
    gat_rep = dict(heads=8, width=32, dtype="bfloat16", keep=False)
    gat_src = ("tf_geometric_tpu_torch/csrc/gat_attention.cu",
               "tf_geometric_tpu/ops/ell_attention_bucketed.py:933")
    source = {"csr_spmm": ("tf_geometric_tpu_torch/csrc/csr_spmm.cu",
                           "tf_geometric_tpu/ops/ell_bucketed.py:214", spmm_rep,
                           "fwd side, F=256, bfloat16"),
              "sorted_segment_sum": ("tf_geometric_tpu_torch/csrc/sorted_segment.cu",
                                     "tf_geometric_tpu/ops/pallas_segment.py:84", spmm_rep,
                                     "fwd side, F=256, bfloat16"),
              "gat_forward": gat_src + (gat_rep, "H=8, d=32, bfloat16, no dropout"),
              "gat_backward_dst": gat_src + (gat_rep, "H=8, d=32, bfloat16, no dropout"),
              "gat_backward_src": gat_src + (gat_rep, "H=8, d=32, bfloat16, no dropout")}
    kernels = []
    for name, launches in zip(_KERNELS, totals):
        path, replaces, rep_key, shape = source[name]
        mine = [r for r in rows if r["name"] == name]
        rep = next(r for r in mine if all(r[k] == v for k, v in rep_key.items()))
        _check(launches > 0, f"{name} was not launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": path, "replaces": replaces,
            "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"], "shape": shape})
    for name, res in results.items():
        print(f"{name}: {res['step_ms']:.4f} ms/step, {res['line']['value']} edges/s "
              f"({gpu})", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
