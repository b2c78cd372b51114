"""Run graph-parallel training jobs on P spawned ranks.

``run_ranks(jobs_per_rank, backend, device)`` starts one process per rank
with the ``spawn`` start method (never ``fork``: a parent with JAX or CUDA
initialised has threads a forked child would deadlock on), joins a
``torch.distributed`` group of ``backend`` through a file rendezvous in a
temporary directory (no ports, so concurrent runs cannot collide), and runs
rank r's list of ``ShardJob``s there. Each job trains one of the sharded
steps of ``parallel/sharded.py`` from given weights and returns what the
caller checks or reports: every step's loss, the gradients of the first
step (the all-reduced gradients Adam was given), the weights after the last
step, per-step device times and the kernel launches it made.

On the CPU each rank runs one thread. With ``device="cuda"`` rank r uses
card ``r % torch.cuda.device_count()``: on a one-card machine every rank
shares card 0, which NCCL refuses, so such runs take ``backend="gloo"``.
The backend is the caller's choice. A rank that fails writes its traceback;
``run_ranks`` then raises with it, and it stops every process it started
when one fails or the time limit passes.

Jobs and results travel as files written with ``torch.save`` in the
temporary directory; nothing else is unpickled.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
import traceback
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..utils.profiling import counters

__all__ = ["ShardJob", "run_ranks", "run_job", "kernel_launch_counts", "LAUNCH_FAMILIES",
           "rank_seed", "params_to_numpy"]


class ShardJob(NamedTuple):
    """One rank's share of a training run.

    ``kind``: ``"gcn"`` (``plan`` a ``RankHaloPlan``, or ``(rows, cols,
    vals)`` numpy arrays of this rank's ``partition_edges_by_row`` shard for
    the all-gather mode), ``"gat"`` (the segment step; a COO
    ``RankHaloPlan``), ``"gat_fused"`` (a ``RankGatPlan``), ``"sage"``
    (the sampled SAGE step; ``plan`` this rank's part of
    ``build_csr_shards``' arrays, a dict of numpy arrays), ``"mincut"``
    or ``"batch_2d"`` (``plan`` the rank's ``RankAdjacency``, or its flat
    ``(rows, cols, vals)`` shard, built into one once: MinCut's
    ``partition_edges_by_row`` shard, the 2-D cell's ``pack_batch_2d``
    edges; for the 2-D step ``x`` is the cell's rows and ``y``/``mask`` its
    data shard's labels and label mask), ``"data"`` (the data-parallel
    step, ``make_data_parallel_step``, over every rank: ``plan`` a tuple of
    this rank's per-step arrays, each stacked over the steps (the local
    batch ``forward`` takes, then labels and label mask), step i taking
    entry ``i`` modulo their number; ``x``, ``y``, ``mask`` unused).
    ``params``: the initial weights as numpy, in the step's structure.
    ``x``, ``y``, ``mask``: this rank's rows. ``options``: the step's
    keyword arguments (``learning_rate``, ``forward`` for the data-parallel
    step, ``num_heads``, ``units``, ``layer_dims``, ``edge_drop_rate``,
    ``feat_drop_rate``; ``k`` for the sampled SAGE, whose widths come from
    ``params``; ``variant``, ``cut_coef``,
    ``orth_coef`` for MinCut, whose C comes from ``params``), ``valid``
    (MinCut: this rank's rows flagged real, numpy; default ``mask``),
    ``ngi`` (2-D: the cell's rows' graph ids, numpy), ``data`` (2-D: the
    data axis size D; rank ``d·P + p`` holds cell (d, p)), plus ``seed``
    for the dropout and draw generators, ``exchange_dtype`` (the sampled SAGE's, by name, such
    as ``"bfloat16"``), ``ints`` (the sampled SAGE's random integers: per
    step, per layer [k, n_local] int32), ``plain`` to run the kernels'
    plain versions on the card,
    ``replay``, a list of numpy weights loaded before each step (the result
    then holds every step's gradients) and ``profile_steps``, a number of
    steps traced by ``torch.profiler`` after the others (on the card). Steps
    ``warmup`` and later are timed with CUDA events when ``timed``. Every
    rank builds each mesh its jobs name (the graph axis over every rank,
    and data × graph for each ``data`` of a 2-D job) once, before the
    jobs, in the same order."""
    name: str
    kind: str
    params: Any
    x: np.ndarray
    y: np.ndarray
    mask: np.ndarray
    plan: Any
    options: Dict[str, Any]
    steps: int
    warmup: int = 0
    timed: bool = False


# the kernel wrappers' launch counters, ``launches.<family>`` (``utils.profiling``)
LAUNCH_FAMILIES = ("csr_spmm", "sorted_segment_sum", "gat_forward", "gat_backward_dst",
                   "gat_backward_src", "fixed_k_draw", "fixed_k_forward", "fixed_k_backward",
                   "spmm_heads", "sddmm_heads", "tiled_spmm")


def kernel_launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count in this process."""
    found = counters()
    return {name: found.get(f"launches.{name}", 0) for name in LAUNCH_FAMILIES}


def rank_seed(seed: int, rank: int) -> int:
    """The dropout generator's seed of ``rank`` for run seed ``seed``."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def params_to_numpy(params):
    """A nested list / tuple of tensors as the same structure of numpy arrays."""
    if isinstance(params, torch.Tensor):
        return params.detach().cpu().numpy()
    return type(params)(params_to_numpy(p) for p in params)


def _grads_to_numpy(params):
    if isinstance(params, torch.Tensor):
        return params.grad.detach().cpu().numpy()
    return type(params)(_grads_to_numpy(p) for p in params)


def _is_edge_shard(plan) -> bool:
    """The all-gather mode's (rows, cols, vals), not a plan NamedTuple."""
    return isinstance(plan, tuple) and not hasattr(plan, "_fields")


def _plan_on(plan, device):
    if isinstance(plan, dict):  # a sampled-SAGE CSR shard
        return {k: None if v is None else torch.as_tensor(v, device=device)
                for k, v in plan.items()}
    if _is_edge_shard(plan):
        return tuple(torch.as_tensor(a, device=device) for a in plan)
    return plan.to(device)


def _mesh_ranks(mesh) -> dict:
    """The global ranks of this rank's graph and data groups."""
    def ranks(group, size):
        if size == 1 and group is None:
            return [dist.get_rank()]
        return dist.get_process_group_ranks(dist.group.WORLD if group is None else group)
    return {"graph": ranks(mesh.group, mesh.size), "data": ranks(mesh.data_group,
                                                                  mesh.data_size)}


def run_job(job: ShardJob, mesh, device) -> dict:
    """Train ``job.steps`` steps of ``job`` on this rank; see ``ShardJob``."""
    from ..convert import sharded_params_from_numpy
    from ..ops import config as kernel_config
    from . import sampled_sage
    from .sharded import (make_batch_2d_step, make_data_parallel_step,
                          make_graph_parallel_gat_fused_step,
                          make_graph_parallel_gat_step, make_graph_parallel_gcn_step,
                          make_graph_parallel_mincut_step, param_leaves, RankAdjacency,
                          rank_adjacency)
    opts = dict(job.options)
    seed, plain, replay = opts.pop("seed", 0), opts.pop("plain", False), opts.pop("replay", None)
    profile_steps = opts.pop("profile_steps", 0)
    exchange, ints = opts.pop("exchange_dtype", None), opts.pop("ints", None)
    valid, ngi = opts.pop("valid", None), opts.pop("ngi", None)
    opts.pop("data", None)
    plan = _plan_on(job.plan, device)
    params = sharded_params_from_numpy(job.params, device)
    x, mask = (torch.as_tensor(a, dtype=torch.float32, device=device) for a in (job.x, job.mask))
    y = torch.as_tensor(job.y, dtype=torch.long, device=device)
    if job.kind in ("mincut", "batch_2d") and not isinstance(plan, RankAdjacency):
        plan = rank_adjacency(*job.plan, x.shape[0], mesh.size * x.shape[0], device)
    if job.kind == "gcn" and _is_edge_shard(plan):
        step, make_opt = make_graph_parallel_gcn_step(mesh, **opts)
        args = (x, *plan, y, mask)
    elif job.kind == "gcn":
        step, make_opt = make_graph_parallel_gcn_step(mesh, halo_plan=plan, **opts)
        args = (x, y, mask)
    elif job.kind == "gat":
        step, make_opt = make_graph_parallel_gat_step(mesh, plan, **opts)
        args = (x, y, mask)
    elif job.kind == "gat_fused":
        step, make_opt = make_graph_parallel_gat_fused_step(mesh, plan, **opts)
        gen = torch.Generator(device=device).manual_seed(rank_seed(seed, mesh.rank))
        args = (gen, x, y, mask)
    elif job.kind == "sage":
        step, _, make_opt = sampled_sage.make_sampled_sage_step(
            mesh, plan, x.shape[1], num_classes=job.params[-1][1].shape[0],
            hidden=job.params[0][2].shape[0], **opts)
        gen = torch.Generator(device=device).manual_seed(rank_seed(seed, mesh.rank))
        args = (gen, x, y, mask)
    elif job.kind == "mincut":
        step, make_opt = make_graph_parallel_mincut_step(
            mesh, plan, num_clusters=job.params[1][0].shape[1], **opts)
        args = (x, y, mask, torch.as_tensor(job.mask if valid is None else valid,
                                             dtype=torch.float32, device=device))
    elif job.kind == "batch_2d":
        step, make_opt = make_batch_2d_step(mesh, plan, graphs_per_data_shard=len(job.y),
                                            **opts)
        args = (x, torch.as_tensor(ngi, dtype=torch.int32, device=device), y, mask)
    elif job.kind == "data":
        data_step, make_opt = make_data_parallel_step(mesh, **opts)
        count = iter(range(1 << 62))

        def step(params, optimizer):
            i = next(count) % plan[0].shape[0]
            return data_step(params, optimizer, *(a[i] for a in plan))
        args = ()
    else:
        raise ValueError(f"unknown job kind {job.kind!r}")

    def step_kwargs(i):
        if ints is None:
            return {}
        return {"ints": [torch.as_tensor(a, dtype=torch.int32, device=device)
                         for a in ints[i]]}
    optimizer = make_opt(params)
    timing = job.timed and torch.device(device).type == "cuda"
    before = kernel_launch_counts()
    losses, terms, events, grads_trace = [], [], [], []
    if exchange is not None:
        sampled_sage.set_exchange_dtype(getattr(torch, exchange))
    with kernel_config.use_plain_versions() if plain else contextlib.nullcontext():
        for i in range(job.steps):
            if replay is not None:
                with torch.no_grad():
                    for p, w in zip(param_leaves(params), param_leaves(
                            sharded_params_from_numpy(replay[i], device))):
                        p.copy_(w)
            timed = timing and i >= job.warmup
            if timed:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            out = step(params, optimizer, *args, **step_kwargs(i))
            if isinstance(out, tuple):  # MinCut: (loss, ce, cut, orth)
                terms.append(torch.stack(out))
                out = out[0]
            losses.append(out)
            if timed:
                end.record()
                events.append((start, end))
            if i == 0 or replay is not None:
                grads_trace.append(_grads_to_numpy(params))
    sampled_sage.set_exchange_dtype(None)
    if timing:
        torch.cuda.synchronize(device)
    after = kernel_launch_counts()
    kernels = None
    if profile_steps:
        from torch.profiler import ProfilerActivity, profile
        from ..utils.profiling import device_time_by_kernel
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(profile_steps):
                step(params, optimizer, *args)
            torch.cuda.synchronize(device)
        kernels = device_time_by_kernel(prof, profile_steps)
    return {"name": job.name, "losses": torch.stack(losses).cpu().tolist(),
            "mesh": _mesh_ranks(mesh),
            "terms": torch.stack(terms).cpu().tolist() if terms else None,
            "grads": grads_trace[0], "grads_trace": grads_trace,
            "params": params_to_numpy(params),
            "step_ms": [s.elapsed_time(e) for s, e in events] if timing else None,
            "launches": {k: after[k] - before[k] for k in after}, "kernels": kernels}


def _rank_main(rank: int, world: int, init_method: str, backend: str, device: str,
               work_dir: str) -> None:
    from .sharded import build_mesh
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
        jobs = torch.load(os.path.join(work_dir, f"jobs{rank}.pt"), weights_only=False)
        def data_axis(job):
            if job.kind == "data":
                return world
            return job.options.get("data", 1) if job.kind == "batch_2d" else 1
        meshes = {1: build_mesh({"graph": world})}
        for data in sorted({data_axis(job) for job in jobs} - {1}):
            meshes[data] = build_mesh({"data": data, "graph": world // data})
        results = [run_job(job, meshes[data_axis(job)], device) for job in jobs]
        torch.save(results, os.path.join(work_dir, f"result{rank}.pt"))
    except BaseException:
        with open(os.path.join(work_dir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(jobs_per_rank: Sequence[List[ShardJob]], backend: str = "gloo",
              device: str = "cuda", timeout_s: float = 600.0) -> List[List[dict]]:
    """Run rank r's jobs in process r of ``len(jobs_per_rank)`` spawned
    ranks on ``device`` (the card unless the caller asks for the CPU);
    returns each rank's list of results (see ``run_job``)."""
    world = len(jobs_per_rank)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="tfg_ranks_") as work_dir:
        for r, jobs in enumerate(jobs_per_rank):
            torch.save(list(jobs), os.path.join(work_dir, f"jobs{r}.pt"))
        init_method = "file://" + os.path.join(work_dir, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, init_method, backend, device, work_dir))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after {timeout_s} s")
                if any(p.exitcode not in (None, 0) for p in procs):
                    break  # one rank failed: the others would wait on it
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        errors = []
        for r, p in enumerate(procs):
            path = os.path.join(work_dir, f"error{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if errors:
            raise RuntimeError("graph-parallel ranks failed:\n" + "\n".join(errors))
        return [torch.load(os.path.join(work_dir, f"result{r}.pt"), weights_only=False)
                for r in range(world)]
