from .pool_layers import (ASAP, CommonPool, DiffPool, MaxPool, MeanPool, MinCutPool, MinPool,
                          SAGPool, Set2Set, SortPool, SumPool)

__all__ = ["CommonPool", "MeanPool", "SumPool", "MaxPool", "MinPool", "SortPool", "DiffPool",
           "MinCutPool", "SAGPool", "ASAP", "Set2Set"]
