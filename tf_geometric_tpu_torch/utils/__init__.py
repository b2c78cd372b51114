from .graph_utils import (add_self_loop_edge, convert_edge_hash_to_edge_index,
                          convert_edge_index_to_edge_hash, convert_edge_to_directed,
                          convert_edge_to_upper, merge_duplicated_edge,
                          remove_self_loop_edge)
from .union_utils import convert_union_to_numpy, union_len

__all__ = ["convert_union_to_numpy", "union_len", "add_self_loop_edge",
           "remove_self_loop_edge", "convert_edge_to_directed", "convert_edge_to_upper",
           "merge_duplicated_edge", "convert_edge_index_to_edge_hash",
           "convert_edge_hash_to_edge_index"]
