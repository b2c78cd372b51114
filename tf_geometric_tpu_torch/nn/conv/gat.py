"""GAT: transformer-style graph attention (JAX counterpart:
``tf_geometric_tpu/nn/conv/gat.py``).

Per head h: Q = act(x W_q + b_q), K = act(x W_k + b_k), V = x W_v; the
score of edge ``r <- c`` is <Q[r], K[c]> / √d; a softmax over each
destination's in-edges; the attention-weighted sum of V; heads concatenated
(``split_value_heads``) or averaged. Heads live in a tensor dimension
(scores [E, H]), as in the JAX package.

Paths. Both run over a ``CsrGatLayout``: the cached one, one passed in,
or, for CUDA tensors without either, one built eagerly for the call, so on
the card ``gat`` always runs the kernels. With equal query and value head
widths the fused attention (``ops/gat_attention.py``) runs; with unequal
widths the merged-head branch (the JAX package's, ``nn/conv/gat.py:162-183``):
per-head scores, a segment softmax per head and the keep mask in PyTorch,
then the multi-head SpMM ``ops/spmm_heads.spmm_multihead`` (the counterpart
of ``ell_spmm_multihead``). CPU tensors without a layout take the segment
path, as the JAX package does without a cache. The counters
``cache.hit.gat_layout`` and ``cache.miss.gat_layout`` count the cache's
lookups (``utils.profiling``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...ops.gat_attention import CsrGatLayout, gat_attention_csr
from ...ops.spmm_heads import spmm_multihead
from ...sparse.matrix import SparseMatrix
from ...utils.graph_utils import add_self_loop_edge
from ...utils.profiling import count, span
from ...utils.union_utils import convert_union_to_numpy
from ..kernel.segment import segment_softmax, segment_sum

__all__ = ["gat"]


def _gat_edge_cache(edge_index, num_nodes: int, cache: Optional[dict], device="cuda"):
    """``(self-looped edge list, is_sorted, layout)``: with a cache, the list
    sorted by destination (stable) and its ``CsrGatLayout``, both on
    ``device``, kept under ``gat_edges_{num_nodes}``; without one, the
    self-looped list as given and no layout. A miss's sort and build is the
    span ``tfg.setup.gat_layout`` (``CsrGatLayout.build``'s own nests in it)."""
    key = f"gat_edges_{num_nodes}"
    if cache is not None and key in cache:
        count("cache.hit.gat_layout")
        return cache[key]
    ei_sl, _ = add_self_loop_edge(edge_index, num_nodes)
    if cache is None:
        return ei_sl, False, None
    count("cache.miss.gat_layout")
    with span("tfg.setup.gat_layout"):
        ei_np = convert_union_to_numpy(ei_sl, np.int64)
        sorted_ei = ei_np[:, np.argsort(ei_np[0], kind="stable")]
        layout = CsrGatLayout.build(sorted_ei, num_nodes, device=device)
        entry = (torch.as_tensor(sorted_ei, device=device), True, layout)
    cache[key] = entry
    return entry


def _edge_attention(Q, K, row, col, num_nodes, num_heads, keep):
    """Per-edge, per-head attention weights [E, H]: scores <Q[r], K[c]>/√d_q,
    a softmax over each destination's in-edges, then the keep mask."""
    d_q = Q.shape[-1] // num_heads
    Qh = Q.reshape(num_nodes, num_heads, d_q)
    Kh = K.reshape(num_nodes, num_heads, d_q)
    att = ((Qh[row.clamp(0, num_nodes - 1)] * Kh[col.clamp(0, num_nodes - 1)]).sum(-1)
           / float(np.sqrt(d_q)))
    att = segment_softmax(att, row, num_nodes)
    return att if keep is None else att * keep


def _segment_attention(Q, K, V, row, col, num_nodes, num_heads, keep):
    """The plain segment path: the edge attention, then a weighted segment
    sum ([N, H, d_v])."""
    E = row.shape[0]
    d_v = V.shape[-1] // num_heads
    att = _edge_attention(Q, K, row, col, num_nodes, num_heads, keep)
    msg = V.reshape(num_nodes, num_heads, d_v)[col.clamp(0, num_nodes - 1)] * att[:, :, None]
    return segment_sum(msg.reshape(E, num_heads * d_v), row, num_nodes).reshape(
        num_nodes, num_heads, d_v)


@span("tfg.nn.conv.gat")
def gat(x, edge_index,
        query_kernel, query_bias, query_activation,
        key_kernel, key_bias, key_activation,
        kernel, bias=None, activation=None, num_heads: int = 1,
        split_value_heads: bool = True, edge_drop_rate: float = 0.0,
        training: bool = False, generator: Optional[torch.Generator] = None,
        keep_mask=None, num_nodes: Optional[int] = None, cache: Optional[dict] = None,
        ell_layout: Optional[CsrGatLayout] = None, sorted_edge_index=None):
    """Functional GAT forward. ``x`` may be dense or a SparseMatrix.

    ``ell_layout`` and ``sorted_edge_index`` go together: a ``CsrGatLayout``
    and the self-looped, row-sorted edge list it was built from (the
    ``_gat_edge_cache`` entry). Attention dropout (training with
    ``edge_drop_rate > 0``) takes ``keep_mask`` [E, H] (float, 1/(1 - rate)
    scale included, over the self-looped edge list in the order used) or a
    ``generator``; one of the two is required.
    """
    if num_nodes is None:
        num_nodes = x.shape[0]
    dropping = training and edge_drop_rate > 0.0
    if dropping and generator is None and keep_mask is None:
        raise ValueError("gat requires a generator or keep_mask when training with "
                         "edge_drop_rate > 0 (a silent no-op would train unregularized)")

    def project(feat, w):
        if isinstance(feat, SparseMatrix):
            return feat.matmul(w)
        return feat @ w

    Q = project(x, query_kernel) + query_bias
    if query_activation is not None:
        Q = query_activation(Q)
    K = project(x, key_kernel) + key_bias
    if key_activation is not None:
        K = key_activation(K)
    V = project(x, kernel)
    device = V.device

    if ell_layout is not None or sorted_edge_index is not None:
        if ell_layout is None or sorted_edge_index is None:
            raise ValueError(
                "pass ell_layout and sorted_edge_index together: the layout "
                "indexes the sorted, self-looped edge list it was built from")
        edge_index = sorted_edge_index
    else:
        # self-attention includes each node itself
        edge_index, _, ell_layout = _gat_edge_cache(edge_index, num_nodes, cache, device)
    if not isinstance(edge_index, torch.Tensor):
        edge_index = torch.as_tensor(np.asarray(edge_index))
    edge_index = edge_index.to(device=device, dtype=torch.int64)

    d_q = Q.shape[-1] // num_heads
    d_v = V.shape[-1] // num_heads
    if ell_layout is None and V.device.type != "cpu":
        if not V.is_cuda:
            raise NotImplementedError(f"gat has no kernels for device {V.device}")
        # no cache on the card: a layout for this call, so the kernels run
        ell_layout = CsrGatLayout.build(edge_index, num_nodes, device=device)
    if d_q == d_v and ell_layout is not None:
        h_flat = gat_attention_csr(ell_layout, Q, K, V, num_heads,
                                   edge_drop_rate=edge_drop_rate, training=training,
                                   generator=generator, keep_mask=keep_mask)
        h_heads = h_flat.reshape(num_nodes, num_heads, d_v)
    else:
        keep = None
        if dropping:
            if keep_mask is None:
                keep_mask = ((torch.rand((edge_index.shape[1], num_heads),
                                         generator=generator, device=device)
                              < 1.0 - edge_drop_rate).float() / (1.0 - edge_drop_rate))
            keep = torch.as_tensor(keep_mask, dtype=torch.float32, device=device)
        row, col = edge_index[0], edge_index[1]
        if ell_layout is not None:
            # merged-head branch: attention weights in PyTorch, then the
            # multi-head SpMM over the layout
            att = _edge_attention(Q, K, row, col, num_nodes, num_heads, keep)
            h_heads = spmm_multihead(ell_layout, att, V, d_v).reshape(
                num_nodes, num_heads, d_v)
        else:
            h_heads = _segment_attention(Q, K, V, row, col, num_nodes, num_heads, keep)

    if split_value_heads:
        h = h_heads.reshape(num_nodes, num_heads * d_v)
    else:
        h = h_heads.mean(dim=1)
    if bias is not None:
        h = h + bias
    if activation is not None:
        h = activation(h)
    return h
