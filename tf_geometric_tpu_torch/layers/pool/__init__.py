from .pool_layers import CommonPool, MaxPool, MeanPool, MinPool, SortPool, SumPool

__all__ = ["CommonPool", "MeanPool", "SumPool", "MaxPool", "MinPool", "SortPool"]
