from .asap import asap
from .cluster_pool import cluster_pool
from .common_pool import max_pool, mean_pool, min_pool, sum_pool
from .diff_pool import batched_cluster_coarsen, diff_pool, diff_pool_coarsen
from .min_cut_pool import min_cut_pool, min_cut_pool_coarsen, min_cut_pool_compute_losses
from .sag_pool import sag_pool
from .set2set import set2set
from .sort_pool import sort_pool
from .topk_pool import topk_pool, topk_pool_fixed

__all__ = ["mean_pool", "sum_pool", "max_pool", "min_pool", "sort_pool", "topk_pool",
           "topk_pool_fixed", "cluster_pool", "diff_pool", "diff_pool_coarsen",
           "batched_cluster_coarsen", "min_cut_pool", "min_cut_pool_coarsen",
           "min_cut_pool_compute_losses", "sag_pool", "asap", "set2set"]
