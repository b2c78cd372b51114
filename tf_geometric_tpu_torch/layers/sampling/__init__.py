from .drop_edge import DropEdge

__all__ = ["DropEdge"]
