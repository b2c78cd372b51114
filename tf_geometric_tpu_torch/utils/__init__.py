from . import data_utils, graph_utils, metrics, profiling, torch_utils
from .graph_utils import (LaplacianMaxEigenvalue, RandomNeighborSampler, UniformNeighborSampler,
                          add_self_loop_edge, adj_norm_edge, compute_edge_mask_by_node_index,
                          convert_dense_adj_to_edge, convert_dense_assign_to_edge,
                          convert_edge_hash_to_edge_index, convert_edge_index_to_edge_hash,
                          convert_edge_to_directed, convert_edge_to_nx_graph,
                          convert_edge_to_upper, convert_x_to_3d, edge_train_test_split,
                          extract_unique_edge, get_laplacian, mask_self_loop_edge,
                          merge_duplicated_edge, negative_sampling,
                          negative_sampling_with_start_node, reindex_sampled_edge_index,
                          remove_self_loop_edge, to_scipy_sparse_matrix)
from .tf_sparse_utils import (compute_num_or_size_splits, sparse_gather_sub,
                              sparse_tensor_gather_sub)
from .union_utils import convert_union_to_numpy, union_len

__all__ = ["convert_union_to_numpy", "union_len", "add_self_loop_edge",
           "remove_self_loop_edge", "convert_edge_to_directed", "convert_edge_to_upper",
           "merge_duplicated_edge", "convert_edge_index_to_edge_hash",
           "convert_edge_hash_to_edge_index", "mask_self_loop_edge", "get_laplacian",
           "adj_norm_edge", "LaplacianMaxEigenvalue", "convert_dense_adj_to_edge",
           "convert_dense_assign_to_edge", "compute_edge_mask_by_node_index",
           "reindex_sampled_edge_index", "sparse_gather_sub", "sparse_tensor_gather_sub",
           "compute_num_or_size_splits", "convert_edge_to_nx_graph", "to_scipy_sparse_matrix",
           "negative_sampling", "negative_sampling_with_start_node", "extract_unique_edge",
           "edge_train_test_split", "convert_x_to_3d", "RandomNeighborSampler",
           "UniformNeighborSampler", "data_utils", "graph_utils", "metrics", "profiling",
           "torch_utils"]
