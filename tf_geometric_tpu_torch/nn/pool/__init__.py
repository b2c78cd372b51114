from .common_pool import max_pool, mean_pool, min_pool, sum_pool
from .sort_pool import sort_pool
from .topk_pool import topk_pool, topk_pool_fixed

__all__ = ["mean_pool", "sum_pool", "max_pool", "min_pool", "sort_pool", "topk_pool",
           "topk_pool_fixed"]
