from .conv.gat import gat
from .conv.gcn import (compile_and_dropout, compute_cache_key, gcn,
                       gcn_build_cache_by_adj, gcn_build_cache_for_graph,
                       gcn_cache_normed_edge, gcn_mapper, gcn_norm_adj,
                       gcn_norm_edge, maybe_compile_ell,
                       precompute_propagated_features)
from .kernel.segment import (segment_count, segment_max, segment_mean, segment_min,
                             segment_normalize, segment_op_with_pad,
                             segment_softmax, segment_sum)

__all__ = ["gat", "gcn", "gcn_norm_adj", "gcn_build_cache_by_adj", "gcn_build_cache_for_graph",
           "gcn_norm_edge", "gcn_cache_normed_edge", "gcn_mapper", "compute_cache_key",
           "compile_and_dropout", "precompute_propagated_features", "maybe_compile_ell",
           "segment_sum", "segment_mean", "segment_max", "segment_min",
           "segment_softmax", "segment_count", "segment_normalize",
           "segment_op_with_pad"]
