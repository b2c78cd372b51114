"""tf_geometric_tpu_torch: the PyTorch / CUDA port of tf_geometric_tpu.

The JAX package ``tf_geometric_tpu`` is the reference; this package mirrors
its module paths. It imports torch and numpy only. Hand-written Hopper
kernels live in ``csrc/`` and are built with nvcc at first use
(``ops/_build.py``).
"""
from . import data, datasets, layers, nn, ops, sparse, utils
from .data import BatchGraph, Graph, HeteroBatchGraph, HeteroGraph
from .sparse import SparseMatrix

__all__ = ["data", "datasets", "layers", "nn", "ops", "sparse", "utils",
           "Graph", "BatchGraph", "HeteroGraph", "HeteroBatchGraph", "SparseMatrix"]
