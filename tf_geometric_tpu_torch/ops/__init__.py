from . import (config, csr_spmm, fixed_k, gat_attention, sorted_segment, spmm, spmm_heads,
               tiled_spmm)
from .csr_spmm import CsrAdj
from .fixed_k import fixed_k_aggregate
from .gat_attention import CsrGatLayout, gat_attention_csr

__all__ = ["config", "csr_spmm", "fixed_k", "gat_attention", "sorted_segment", "spmm",
           "spmm_heads", "tiled_spmm", "CsrAdj", "CsrGatLayout", "fixed_k_aggregate",
           "gat_attention_csr"]
