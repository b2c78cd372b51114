"""Graph-parallel runtime over ``torch.distributed`` (JAX counterpart:
``tf_geometric_tpu/parallel``): partitioning, halo plans and exchange, the
sharded GCN, GAT and MinCut/DiffPool training steps, the 2-D batch step, the
node-partitioned sampled SAGE step, multi-host start-up and shard loading,
and a launcher for spawned ranks."""
from .halo import (GatHaloSpec, HaloSpec, HaloSpecEll, RankGatPlan, RankHaloPlan,
                   build_gat_halo_spec, build_halo_spec, halo_exchange, halo_gat_attention,
                   halo_spmm_ell, halo_spmm_split, rank_gat_plan, rank_halo_plan)
from .multihost import (build_multihost_mesh, distribute, distribute_halo_plan, initialize,
                        launch_local, run_halo_gcn)
from .partition import (EdgePartition, apply_node_permutation, bandwidth_reduction_order,
                        community_order, nodes_per_part, partition_edges_by_row,
                        partition_order)
from .runner import ShardJob, run_ranks
from .sampled_sage import build_csr_shards, make_sampled_sage_step, set_exchange_dtype
from .sharded import (GraphMesh, RankAdjacency, build_mesh, make_batch_2d_step,
                      make_data_parallel_step,
                      make_graph_parallel_gat_fused_step, make_graph_parallel_gat_step,
                      make_graph_parallel_gcn_step, make_graph_parallel_mincut_step,
                      pack_batch_2d, rank_adjacency, rank_aggregate, sharded_spmm_local)

__all__ = ["EdgePartition", "nodes_per_part", "partition_edges_by_row",
           "bandwidth_reduction_order", "community_order", "partition_order",
           "apply_node_permutation", "HaloSpec", "HaloSpecEll", "GatHaloSpec", "RankHaloPlan",
           "RankGatPlan", "build_halo_spec", "build_gat_halo_spec", "rank_halo_plan",
           "rank_gat_plan", "halo_exchange", "halo_spmm_split", "halo_spmm_ell",
           "halo_gat_attention", "GraphMesh", "build_mesh", "sharded_spmm_local",
           "RankAdjacency", "rank_adjacency", "rank_aggregate",
           "make_graph_parallel_gcn_step", "make_graph_parallel_gat_step",
           "make_graph_parallel_gat_fused_step", "make_graph_parallel_mincut_step",
           "make_batch_2d_step", "make_data_parallel_step", "pack_batch_2d", "ShardJob",
           "run_ranks", "build_csr_shards",
           "make_sampled_sage_step", "set_exchange_dtype", "initialize", "build_multihost_mesh",
           "distribute", "distribute_halo_plan", "run_halo_gcn", "launch_local"]
