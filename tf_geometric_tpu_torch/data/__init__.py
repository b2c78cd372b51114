from .graph import Graph

__all__ = ["Graph"]
