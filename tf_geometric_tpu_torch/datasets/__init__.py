from .synthetic_citation import (synthetic_graph_classification,
                                 synthetic_graph_classification_hard, synthetic_ogbn_arxiv_like)
from .synthetic_reddit import synthetic_reddit_like

__all__ = ["synthetic_ogbn_arxiv_like", "synthetic_graph_classification",
           "synthetic_graph_classification_hard", "synthetic_reddit_like"]
