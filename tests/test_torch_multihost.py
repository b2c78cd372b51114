"""The port's multi-host entry (``tf_geometric_tpu_torch/parallel/multihost.py``)
against JAX's single-process run on the CPU.

4 spawned processes (``multihost.launch_local``: ``python -m
tf_geometric_tpu_torch.parallel.multihost``, each joining through
``initialize``'s ``TFG_COORDINATOR`` / ``TFG_NUM_PROCESSES`` /
``TFG_PROCESS_ID`` rendezvous over gloo) train 3 halo-GCN steps on
``tests/_multihost_worker.build_problem``'s graph (96 nodes, 400 edges),
each loading only its own shard of the plan (``distribute_halo_plan``) and
of the rows (``distribute``), on the two-level mesh (data 2 hosts × graph 2
ranks per host, ``LOCAL_WORLD_SIZE`` = 2; the inputs replicated along
``data``) and on the flat one (graph 4), with the COO plan and the packed
(``"ell"``) plan. The losses equal, within rtol 1e-5, those of
``run_ranks`` on the graph axis alone and those of JAX's single-process run
of the same problem on a sub-mesh of conftest's 8 virtual CPU devices
(``_multihost_worker.run_steps``). ``initialize`` is a no-op without a
coordinator and with a group already up; ``distribute`` cuts a host array
as a JAX ``PartitionSpec`` would.
"""
import numpy as np
import pytest
import torch

from tf_geometric_tpu_torch.parallel import (GraphMesh, ShardJob, build_halo_spec,
                                             distribute, launch_local,
                                             partition_edges_by_row, rank_halo_plan,
                                             run_ranks)
from tf_geometric_tpu_torch.parallel import multihost

import _multihost_worker as worker

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
CASES = [(True, "coo"), (False, "coo"), (False, "ell"), (True, "ell")]
IDS = ["two_level_coo", "flat_coo", "flat_ell", "two_level_ell"]
PROCESSES, RANKS_PER_HOST = 4, 2


def _port_problem(num_parts, layout):
    """``build_problem``'s arrays and weights with the port's plan over the
    same partition of the same normalized adjacency."""
    from tf_geometric_tpu.nn.conv.gcn import gcn_norm_adj
    from tf_geometric_tpu.sparse import SparseMatrix
    x_p, y_p, mask, _, params, _, _ = worker.build_problem(num_parts, layout=layout)
    num_nodes, num_edges = 96, 400
    rng = np.random.default_rng(3)
    rng.normal(size=(num_nodes, x_p.shape[1]))
    ei = rng.integers(0, num_nodes, size=(2, num_edges)).astype(np.int32)
    normed = gcn_norm_adj(SparseMatrix(ei, None, (num_nodes, num_nodes)))
    part = partition_edges_by_row(np.asarray(normed.index), np.asarray(normed.value),
                                  num_nodes, num_parts, pad_multiple=16)
    assert part.num_nodes_padded == x_p.shape[0]
    return dict(halo_spec=build_halo_spec(part, layout=layout), x=x_p, y=y_p, mask=mask,
                params=[tuple(np.asarray(a) for a in layer) for layer in params])


@pytest.fixture(scope="module")
def cluster_runs():
    """Every case through ``launch_local`` (4 processes) and through
    ``run_ranks`` on the graph axis alone (one spawn per graph size)."""
    out = {}
    for two_level, layout in CASES:
        parts = RANKS_PER_HOST if two_level else PROCESSES
        problem = _port_problem(parts, layout)
        hosts = launch_local(dict(problem, steps=3), PROCESSES, two_level, RANKS_PER_HOST,
                             device="cpu", timeout_s=240)
        out[(two_level, layout)] = (problem, hosts)
    ranks = {}
    for parts in (RANKS_PER_HOST, PROCESSES):
        jobs = [[] for _ in range(parts)]
        for two_level, layout in CASES:
            problem = out[(two_level, layout)][0]
            if problem["halo_spec"].num_parts != parts:
                continue
            npp = problem["halo_spec"].nodes_per_part
            for r in range(parts):
                rows = slice(r * npp, (r + 1) * npp)
                jobs[r].append(ShardJob(layout, "gcn", problem["params"], problem["x"][rows],
                                        problem["y"][rows], problem["mask"][rows],
                                        rank_halo_plan(problem["halo_spec"], r, "cpu"), {}, 3))
        results = run_ranks(jobs, backend="gloo", device="cpu", timeout_s=240)
        for res in results[0]:
            ranks[(parts == RANKS_PER_HOST, res["name"])] = res["losses"]
    return out, ranks


def _jax_single_process_losses(two_level, layout):
    from tf_geometric_tpu.parallel.sharded import build_mesh
    parts = RANKS_PER_HOST if two_level else PROCESSES
    x_p, y_p, mask, halo, params, hidden, num_classes = worker.build_problem(parts,
                                                                             layout=layout)
    mesh = build_mesh({"data": PROCESSES // RANKS_PER_HOST, "graph": RANKS_PER_HOST}
                      if two_level else {"graph": PROCESSES})
    return worker.run_steps(mesh, "graph", x_p, y_p, mask, halo, params, hidden, num_classes)


@pytest.mark.parametrize("two_level,layout", CASES, ids=IDS)
def test_hosts_match_run_ranks_and_jax(cluster_runs, two_level, layout):
    """Every process reports the same losses, those of ``run_ranks`` on the
    graph axis and those of JAX's single-process run."""
    out, ranks = cluster_runs
    _, hosts = out[(two_level, layout)]
    for host in hosts[1:]:
        np.testing.assert_array_equal(host["losses"], hosts[0]["losses"])
    np.testing.assert_allclose(hosts[0]["losses"], ranks[(two_level, layout)], **LOSS_TOL)
    np.testing.assert_allclose(hosts[0]["losses"], _jax_single_process_losses(two_level, layout),
                               **LOSS_TOL)


@pytest.mark.parametrize("two_level", [True, False], ids=["two_level", "flat"])
def test_mesh_layout(cluster_runs, two_level):
    """Process r sits at (data r // R, graph r % R) on the two-level mesh
    and at graph r on the flat one."""
    out, _ = cluster_runs
    _, hosts = out[(two_level, "coo")]
    for r, host in enumerate(hosts):
        assert host["rank"] == r
        if two_level:
            assert (host["data_rank"], host["data_size"]) == (r // RANKS_PER_HOST,
                                                              PROCESSES // RANKS_PER_HOST)
            assert (host["graph_rank"], host["graph_size"]) == (r % RANKS_PER_HOST,
                                                                RANKS_PER_HOST)
        else:
            assert (host["data_rank"], host["data_size"], host["graph_rank"],
                    host["graph_size"]) == (0, 1, r, PROCESSES)


def test_initialize_is_a_no_op_without_a_coordinator(monkeypatch, tmp_path):
    import torch.distributed as dist
    for name in ("TFG_COORDINATOR", "TFG_NUM_PROCESSES", "TFG_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    multihost.initialize()
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1)
    try:
        # a group already up: nothing happens, whatever the arguments say
        multihost.initialize("localhost:1", num_processes=2, process_id=1)
        assert dist.get_world_size() == 1
        assert multihost.build_multihost_mesh(two_level=True) == GraphMesh(None, 0, 1)
        assert multihost.build_multihost_mesh(two_level=False) == GraphMesh(None, 0, 1)
        with pytest.raises(ValueError):
            multihost.build_multihost_mesh(two_level=True, ranks_per_host=2)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("spec,blocks", [(("graph", None), lambda d, p: (p,)),
                                         ((("data", "graph"),), lambda d, p: (2 * d + p,)),
                                         (("data",), lambda d, p: (d,)),
                                         ((None, "graph"), lambda d, p: (slice(None), p))])
def test_distribute_cuts_like_a_partition_spec(spec, blocks):
    """On a data 2 × graph 2 mesh each rank gets the block a JAX
    ``PartitionSpec`` would give its device; a dimension that does not
    split evenly is refused."""
    a = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    for d in range(2):
        for p in range(2):
            mesh = GraphMesh(None, p, 2, None, d, 2)
            got = distribute(mesh, spec, a, device="cpu").numpy()
            index = []
            for dim, b in enumerate(blocks(d, p)):
                if isinstance(b, slice):
                    index.append(b)
                    continue
                n = {("graph", None): 2, (("data", "graph"),): 4, ("data",): 2,
                     (None, "graph"): 2}[spec]
                size = a.shape[dim] // n
                index.append(slice(b * size, (b + 1) * size))
            np.testing.assert_array_equal(got, a[tuple(index)])
    with pytest.raises(ValueError):
        distribute(GraphMesh(None, 0, 3), ("graph",), a, device="cpu")
    assert torch.is_tensor(distribute(GraphMesh(None, 0, 1), (), a, device="cpu"))
