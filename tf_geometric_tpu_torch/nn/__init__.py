from .conv.appnp import appnp, mlp_encode
from .conv.chebynet import chebynet, chebynet_cache_normed_edge, chebynet_norm_edge
from .conv.gat import gat
from .conv.gin import gin, gin_updater
from .conv.gcn import (compile_and_dropout, compute_cache_key, gcn,
                       gcn_build_cache_by_adj, gcn_build_cache_for_graph,
                       gcn_cache_normed_edge, gcn_norm_adj,
                       gcn_norm_edge, maybe_compile_ell,
                       precompute_propagated_features)
from .conv.graph_sage import (gcn_graph_sage, lstm_graph_sage, max_pool_graph_sage,
                              mean_graph_sage, mean_graph_sage_fixed_k, mean_pool_graph_sage,
                              sum_graph_sage, sum_graph_sage_fixed_k)
from .conv.le_conv import le_conv
from .conv.sgc import sgc
from .conv.ssgc import ssgc
from .conv.tagcn import tagcn
from .kernel.map_reduce import (aggregate_neighbors, gcn_mapper, identity_mapper,
                                identity_updater, max_reducer, mean_reducer, min_reducer,
                                neighbor_count_mapper, sum_reducer, sum_updater)
from .kernel.segment import (segment_count, segment_max, segment_mean, segment_min,
                             segment_normalize, segment_op_with_pad,
                             segment_softmax, segment_sum)
from .pool import (max_pool, mean_pool, min_pool, sort_pool, sum_pool, topk_pool,
                   topk_pool_fixed)
from .sampling import DeviceNeighborSampler, draw_fixed_k, drop_edge

__all__ = ["appnp", "mlp_encode", "sgc", "ssgc", "tagcn", "chebynet", "chebynet_norm_edge",
           "chebynet_cache_normed_edge", "le_conv", "drop_edge", "gat", "gcn", "gin", "gin_updater",
           "mean_pool", "sum_pool", "max_pool",
           "min_pool", "sort_pool", "topk_pool", "topk_pool_fixed", "gcn_norm_adj",
           "gcn_build_cache_by_adj", "gcn_build_cache_for_graph", "gcn_norm_edge",
           "gcn_cache_normed_edge", "gcn_mapper", "compute_cache_key",
           "compile_and_dropout", "precompute_propagated_features", "maybe_compile_ell",
           "mean_graph_sage", "sum_graph_sage", "gcn_graph_sage", "mean_pool_graph_sage",
           "max_pool_graph_sage", "lstm_graph_sage", "mean_graph_sage_fixed_k",
           "sum_graph_sage_fixed_k", "aggregate_neighbors", "identity_mapper",
           "neighbor_count_mapper", "sum_reducer", "mean_reducer", "max_reducer",
           "min_reducer", "identity_updater", "sum_updater", "DeviceNeighborSampler",
           "draw_fixed_k", "segment_sum", "segment_mean", "segment_max", "segment_min",
           "segment_softmax", "segment_count", "segment_normalize",
           "segment_op_with_pad"]
