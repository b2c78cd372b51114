from .matrix import SparseMatrix, chunked_feature_matmul, concat, diags, eye

__all__ = ["SparseMatrix", "diags", "eye", "concat", "chunked_feature_matmul"]
