from . import config, csr_spmm, sorted_segment, spmm
from .csr_spmm import CsrAdj

__all__ = ["config", "csr_spmm", "sorted_segment", "spmm", "CsrAdj"]
