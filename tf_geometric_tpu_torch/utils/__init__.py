from .union_utils import convert_union_to_numpy, union_len

__all__ = ["convert_union_to_numpy", "union_len"]
