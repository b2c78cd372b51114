from .synthetic_citation import synthetic_ogbn_arxiv_like

__all__ = ["synthetic_ogbn_arxiv_like"]
