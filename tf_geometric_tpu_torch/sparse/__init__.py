from .matrix import SparseMatrix, chunked_feature_matmul, concat, diags, eye, sparse_shape

__all__ = ["SparseMatrix", "diags", "eye", "concat", "sparse_shape", "chunked_feature_matmul"]
