"""The port's kernels and their wrappers. The COO ``spmm``/``sddmm``
functions live in the ``spmm`` submodule (their names collide with it, so
they are not re-bound here), as in the JAX package."""
from . import (config, csr_spmm, ell, fixed_k, gat_attention, sorted_segment, spmm, spmm_heads,
               tiled_spmm)
from .csr_spmm import CsrAdj
from .ell import ell_spmm, ell_spmm_multihead
from .fixed_k import fixed_k_aggregate
from .gat_attention import CsrGatLayout, gat_attention_csr, gat_attention_ell
from .spmm import sddmm_xla, spmm_xla

__all__ = ["config", "csr_spmm", "ell", "fixed_k", "gat_attention", "sorted_segment", "spmm",
           "spmm_heads", "tiled_spmm", "CsrAdj", "CsrGatLayout", "fixed_k_aggregate",
           "gat_attention_csr", "gat_attention_ell", "ell_spmm", "ell_spmm_multihead",
           "spmm_xla", "sddmm_xla"]
