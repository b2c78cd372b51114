from . import config, csr_spmm, gat_attention, sorted_segment, spmm
from .csr_spmm import CsrAdj
from .gat_attention import CsrGatLayout, gat_attention_csr

__all__ = ["config", "csr_spmm", "gat_attention", "sorted_segment", "spmm", "CsrAdj",
           "CsrGatLayout", "gat_attention_csr"]
