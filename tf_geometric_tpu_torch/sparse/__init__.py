from .matrix import SparseMatrix, chunked_feature_matmul, concat, diags, eye, sparse_shape

# JAX's alias of ``sparse_shape`` (``tfs.shape``)
shape = sparse_shape

__all__ = ["SparseMatrix", "diags", "eye", "concat", "sparse_shape", "shape",
           "chunked_feature_matmul"]
