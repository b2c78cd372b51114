from .map_reduce import MapReduceGNN

__all__ = ["MapReduceGNN"]
