"""Multi-host entry: ``torch.distributed`` start-up and two-level meshes
(JAX counterpart: ``tf_geometric_tpu/parallel/multihost.py``, which wraps
``jax.distributed``).

One process per rank. On a cluster of H hosts with R ranks each:

- ``initialize`` joins the process group through a TCP rendezvous at the
  coordinator's address, with the JAX function's ``TFG_COORDINATOR`` /
  ``TFG_NUM_PROCESSES`` / ``TFG_PROCESS_ID`` fallbacks (a no-op on a single
  process, or when a group is already up).
- ``build_multihost_mesh`` gives the two-level mesh, ``data`` = hosts ×
  ``graph`` = ranks per host (the graph axis's exchanges stay inside a host,
  the gradient all-reduce over ``data`` crosses hosts once a step), or a
  flat ``graph`` axis over every rank (a graph too large for one host).
- ``distribute`` and ``distribute_halo_plan`` give each rank only its own
  shard of a host array or of a halo plan.

The backend is the caller's (``gloo`` where ranks share a card; NCCL wants
a card per rank). ``run_halo_gcn`` is the per-process body of a halo-GCN
run on such a mesh, and ``launch_local`` starts one on this host as
separate processes through the environment rendezvous, as a cluster's
launcher would (``python -m tf_geometric_tpu_torch.parallel.multihost``).
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .halo import RankHaloPlan, rank_halo_plan
from .sharded import GraphMesh, build_mesh

__all__ = ["initialize", "build_multihost_mesh", "distribute", "distribute_halo_plan",
           "run_halo_gcn", "launch_local"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: str = "gloo") -> None:
    """Join the process group: ``dist.init_process_group(backend)`` with a
    TCP rendezvous at ``coordinator_address`` (``host:port``). Arguments
    default to ``TFG_COORDINATOR`` / ``TFG_NUM_PROCESSES`` /
    ``TFG_PROCESS_ID``; with a process count but no coordinator, torch's
    ``env://`` rendezvous (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``). A
    no-op when neither a coordinator nor a process count is configured (a
    single process) or when the group is already up."""
    coordinator_address = coordinator_address or os.environ.get("TFG_COORDINATOR")
    if num_processes is None and "TFG_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["TFG_NUM_PROCESSES"])
    if process_id is None and "TFG_PROCESS_ID" in os.environ:
        process_id = int(os.environ["TFG_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return
    if dist.is_initialized():
        return
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend, init_method=init_method, **kwargs)


def build_multihost_mesh(two_level: bool = True,
                         ranks_per_host: Optional[int] = None) -> GraphMesh:
    """The mesh over every rank of the process group, in rank order (rank
    ``host·R + local_rank``, as a launcher numbers them). ``two_level``:
    ``data`` = hosts × ``graph`` = ``ranks_per_host`` (default
    ``LOCAL_WORLD_SIZE``, else every rank on one host); otherwise one flat
    ``graph`` axis."""
    world = dist.get_world_size()
    if not two_level:
        return build_mesh({"graph": world})
    if ranks_per_host is None:
        ranks_per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if ranks_per_host < 1 or world % ranks_per_host:
        raise ValueError(f"{world} ranks do not split into hosts of {ranks_per_host}")
    return build_mesh({"data": world // ranks_per_host, "graph": ranks_per_host})


def _axis_block(mesh: GraphMesh, axes):
    """(blocks, index) of this rank along a dimension sharded over ``axes``."""
    if axes is None:
        return 1, 0
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    place = {"graph": (mesh.size, mesh.rank), "data": (mesh.data_size, mesh.data_rank)}
    blocks, index = 1, 0
    for axis in axes:
        if axis not in place:
            raise ValueError(f"unknown mesh axis {axis!r}")
        size, pos = place[axis]
        blocks, index = blocks * size, index * size + pos
    return blocks, index


def distribute(mesh: GraphMesh, spec: Sequence, global_array, device="cuda") -> torch.Tensor:
    """This rank's shard of a host array under ``spec`` (per leading
    dimension: None, an axis name, or a tuple of axis names major first, as
    in a JAX ``PartitionSpec``; dimensions past ``spec`` whole), as a
    tensor on ``device``. A dimension sharded over an axis of n ranks must
    split into n equal blocks."""
    a = np.asarray(global_array)
    index = []
    for dim, axes in enumerate(tuple(spec)):
        blocks, pos = _axis_block(mesh, axes)
        if a.shape[dim] % blocks:
            raise ValueError(f"dimension {dim} of {a.shape[dim]} does not split into "
                             f"{blocks} blocks")
        size = a.shape[dim] // blocks
        index.append(slice(pos * size, (pos + 1) * size))
    return torch.as_tensor(np.ascontiguousarray(a[tuple(index)]), device=device)


def distribute_halo_plan(mesh: GraphMesh, halo_spec, device="cuda") -> RankHaloPlan:
    """This rank's shard of a COO ``HaloSpec`` or a packed ``HaloSpecEll``
    (its send lists and edge blocks at graph position ``mesh.rank``), on
    ``device``: the plan ``make_graph_parallel_gcn_step`` takes."""
    if halo_spec.num_parts != mesh.size:
        raise ValueError(f"the plan has {halo_spec.num_parts} parts, the graph axis "
                         f"{mesh.size} ranks")
    return rank_halo_plan(halo_spec, mesh.rank, device)


def run_halo_gcn(mesh: GraphMesh, halo_spec, x, y, mask, params, steps: int,
                 device="cuda", learning_rate: float = 1e-2) -> dict:
    """One process's share of a halo-GCN run: its rows of the host arrays
    ``x``, ``y``, ``mask`` (sharded over ``graph``, the same on every data
    shard) and its shard of the plan, then ``steps`` training steps of
    ``make_graph_parallel_gcn_step`` from the numpy ``params``; the
    gradients are all-reduced over ``graph`` only (the inputs are
    replicated along ``data``). Returns the losses and the kernel launches
    it made."""
    from ..convert import sharded_params_from_numpy
    from .runner import kernel_launch_counts
    from .sharded import make_graph_parallel_gcn_step
    plan = distribute_halo_plan(mesh, halo_spec, device)
    x_d = distribute(mesh, ("graph", None), np.asarray(x, np.float32), device)
    y_d = distribute(mesh, ("graph",), np.asarray(y, np.int64), device)
    m_d = distribute(mesh, ("graph",), np.asarray(mask, np.float32), device)
    weights = sharded_params_from_numpy(params, device)
    step, make_opt = make_graph_parallel_gcn_step(mesh, learning_rate, halo_plan=plan)
    optimizer = make_opt(weights)
    before = kernel_launch_counts()
    losses = [step(weights, optimizer, x_d, y_d, m_d) for _ in range(steps)]
    after = kernel_launch_counts()
    return {"losses": torch.stack(losses).cpu().tolist(),
            "launches": {k: after[k] - before[k] for k in after}}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_local(problem: dict, num_processes: int, two_level: bool, ranks_per_host: int,
                 device="cuda", timeout_s: float = 600.0) -> list:
    """Run ``run_halo_gcn`` in ``num_processes`` new processes on this host
    (``python -m tf_geometric_tpu_torch.parallel.multihost``), each joining
    through ``initialize``'s environment rendezvous (``TFG_COORDINATOR`` at
    a free localhost port, ``TFG_NUM_PROCESSES``, ``TFG_PROCESS_ID``,
    ``LOCAL_WORLD_SIZE`` = ``ranks_per_host``) over gloo. ``problem``: the
    keyword arguments of ``run_halo_gcn`` past the mesh (``halo_spec``,
    ``x``, ``y``, ``mask``, ``params``, ``steps``). Returns each process's
    result; stops every process it started."""
    if torch.device(device).type == "cuda":
        from ..ops import _build
        _build.build_all()  # once, before the ranks load the libraries
    with tempfile.TemporaryDirectory(prefix="tfg_hosts_") as work_dir:
        torch.save(dict(problem, two_level=two_level, device=str(device)),
                   os.path.join(work_dir, "problem.pt"))
        port = _free_port()
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        procs, logs = [], []
        try:
            for rank in range(num_processes):
                env = dict(os.environ, TFG_COORDINATOR=f"localhost:{port}",
                           TFG_NUM_PROCESSES=str(num_processes), TFG_PROCESS_ID=str(rank),
                           LOCAL_WORLD_SIZE=str(ranks_per_host),
                           PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
                # output to files: a rank blocked on a full pipe would stall
                # the others' collectives
                log = open(os.path.join(work_dir, f"log{rank}.txt"), "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "tf_geometric_tpu_torch.parallel.multihost",
                     work_dir], stdout=log, stderr=subprocess.STDOUT, env=env))
            errors = []
            for rank, (p, log) in enumerate(zip(procs, logs)):
                try:
                    p.wait(timeout=timeout_s)
                except subprocess.TimeoutExpired:
                    errors.append(f"rank {rank}: still running after {timeout_s} s")
                    break
                if p.returncode != 0:
                    log.flush()
                    log.seek(0)
                    errors.append(f"rank {rank}: exit code {p.returncode}\n{log.read()[-3000:]}")
                    break
            if errors:
                raise RuntimeError("multi-host ranks failed:\n" + "\n".join(errors))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        return [torch.load(os.path.join(work_dir, f"result{r}.pt"), weights_only=False)
                for r in range(num_processes)]


def _main(work_dir: str) -> None:
    problem = torch.load(os.path.join(work_dir, "problem.pt"), weights_only=False)
    device = problem.pop("device")
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ["TFG_PROCESS_ID"]) % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        torch.set_num_threads(1)
    try:
        initialize()
        mesh = build_multihost_mesh(two_level=problem.pop("two_level"))
        result = run_halo_gcn(mesh, device=device, **problem)
        result.update(rank=dist.get_rank(), graph_rank=mesh.rank, graph_size=mesh.size,
                      data_rank=mesh.data_rank, data_size=mesh.data_size)
        torch.save(result, os.path.join(work_dir, f"result{dist.get_rank()}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1])
