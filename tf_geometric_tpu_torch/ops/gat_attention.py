"""Fused GAT attention over a CSR graph: the layout, the plain versions of
the three passes, their kernel wrappers and the autograd function.

Counterpart of ``tf_geometric_tpu/ops/ell_attention_bucketed.py``
(``gat_attention_bucketed``): per head, the score ``s_e = <Q[r], K[c]>/√d``
of each edge ``r <- c``, a softmax over each destination's in-edges,
dropout by a keep mask, and ``out[r] = Σ a_e·keep_e·V[c]``; the backward
gives dQ, dK and dV.

What carries over and what does not. The JAX layout's degree buckets, its
permuted row space and ``w_scatter_pos`` were tuned to TPU costs; none is
ported. ``CsrGatLayout`` holds two CSR views of the self-looped edge list:
the destination side (per row: source ``nbr`` and edge id) for the forward
and dQ, the source side (per column: destination ``nbr`` and edge id) for
dK and dV, so no pass needs atomics. A layout may be rectangular:
``num_nodes`` destination rows (Q, out, dy, dQ, lse, D) read ``num_src``
source rows (K, V, dK, dV), as the graph-parallel GAT's ``[local ‖
received]`` source space needs (``gat_attention_ell``); the square layout
has both equal. The backward recomputes each weight from ``lse`` (saved by
the forward) and ``D[r] = <dy[r], out[r]>_h``, which equals the JAX
package's ``gsum`` because ``Σ a·keep·<dy, V> = <dy, out>``. The
destination pass hands each edge's weights on to the source pass in the
JAX package's flat weight array: ``w`` float32 [E, 2H] by edge id,
``w[e, :H] = a_e·keep_e`` and ``w[e, H:] = ds_e`` (85.5 MB on the arxiv
graph at H = 8), so the source pass is a two-output weighted gather of Q
and dy, with no K, V, lse, D or mask reads.

The three passes and their kernels (``csrc/gat_attention.cu``):
forward (destination side, online softmax; out and lse), backward on the
destination side (dQ, D and w) and backward on the source side (dK and dV
from w). Each has a plain PyTorch version with the same contract; each
pass dispatches on the device of Q (``_launch.use_kernel``): a CPU tensor
takes the plain version, a CUDA tensor launches the kernel, and a failed
launch raises.
Every pass writes every row of its outputs, rows without entries included
(out, lse, dQ, D, dK and dV are 0 there), so the wrappers allocate them
uninitialized; the kernel writes the rows of ``w`` of the side's edges
only. Inside ``ops.config.use_plain_versions()`` it takes the plain
versions on any device (the on-card reference of ``chip_smoke.py``).

Bound on the H100: bytes (each edge gathers two rows of H·d elements for
~4 flops per element).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.profiling import count, span
from ..utils.union_utils import convert_union_to_numpy
from . import config as _config
from ._launch import DTYPE_CODES, entry, launch, max_vec_bytes, query, require_cuda, use_kernel
from .spmm_heads import CHUNK

__all__ = ["GatSide", "CsrGatLayout", "gat_attention_csr", "gat_attention_ell", "HUB_DEGREE",
           "gat_forward_plain", "gat_backward_dst_plain", "gat_backward_src_plain",
           "launch_gat_forward", "launch_gat_backward_dst", "launch_gat_backward_src",
           "kernel_info", "src_scratch_floats"]

# destination rows with more edges than this get a block of 8 warps in the
# kernels (on the H100, 64 and 128 did no better for either destination-side
# pass: chip_smoke.py's hub degree sweep); on the source side a row is a hub
# when it has more than CHUNK entries (the lane-group gather's chunk, read
# from csrc/lane_gather.cuh)
HUB_DEGREE = 256
_EPS = 1e-16  # added to the softmax denominator, as the JAX kernel does


class GatSide(NamedTuple):
    """One CSR view of the edge list. ``nbr`` is the source of each entry
    on the destination side and its destination on the source side;
    ``hubs`` lists the rows with more than ``hub_degree`` entries; ``row``
    is each entry's row (the multi-head SpMM's chunks read it); every edge
    id is below ``num_edges``, the row count of the arrays they index (a
    keep mask, the backward's per-edge weights).

    The source side (``hub_degree = CHUNK``) also holds what its pass needs
    to split its long rows (its hubs) over the grid: ``chunk_hub``, for each
    ``CHUNK`` entries of the view, the index in ``hubs`` of the row that
    holds the chunk's first entry, or -1 where that row is short; and
    ``tickets``, one per hub, all 0 between launches. The destination side
    has neither (None)."""
    row_ptr: torch.Tensor   # [num_rows + 1] int32
    nbr: torch.Tensor       # [nnz] int32
    eid: torch.Tensor       # [nnz] int32, index into the input edge list
    hubs: torch.Tensor      # [num_hubs] int32
    hub_degree: int
    row: torch.Tensor       # [nnz] int32
    num_edges: int
    chunk_hub: Optional[torch.Tensor] = None  # [ceil(nnz / CHUNK)] int32
    tickets: Optional[torch.Tensor] = None    # [num_hubs] int32


def _build_side(keys, nbrs, eids, num_rows: int, hub_degree: int, num_edges: int,
                device, source: bool = False) -> GatSide:
    order = np.argsort(keys, kind="stable")
    deg = np.bincount(keys, minlength=num_rows)
    row_ptr = np.concatenate([[0], np.cumsum(deg)])
    hubs = np.nonzero(deg > hub_degree)[0]

    def as_int32(a):
        return torch.as_tensor(np.ascontiguousarray(a).astype(np.int32), device=device)

    chunk_hub = tickets = None
    if source:
        # a chunk's row holds its first entry; the row's index in hubs, or -1
        firsts = np.arange(0, len(keys), CHUNK)
        hub_of_row = np.full(num_rows, -1, np.int64)
        hub_of_row[hubs] = np.arange(len(hubs))
        chunk_hub = hub_of_row[np.searchsorted(row_ptr, firsts, side="right") - 1]
        if len(hubs):
            count("gat_src.long_rows", len(hubs))
            count("gat_src.chunks", int((chunk_hub >= 0).sum()))
        chunk_hub = as_int32(chunk_hub)
        tickets = torch.zeros(len(hubs), dtype=torch.int32, device=device)
    return GatSide(row_ptr=as_int32(row_ptr), nbr=as_int32(nbrs[order]),
                   eid=as_int32(eids[order]), hubs=as_int32(hubs),
                   hub_degree=int(hub_degree), row=as_int32(keys[order]),
                   num_edges=int(num_edges), chunk_hub=chunk_hub, tickets=tickets)


def src_scratch_floats(side: GatSide, width: int) -> int:
    """Floats of scratch the source pass takes over ``side`` at row width
    ``width`` (H·d), as ``tfg_gat_scratch_floats`` gives them: the float32
    sums of both outputs (2·width) for each long row's direct part and each
    ``CHUNK`` entries of the view; none without long rows."""
    num_hubs = int(side.hubs.shape[0])
    return 0 if num_hubs == 0 else (num_hubs + -(-int(side.nbr.shape[0]) // CHUNK)) * 2 * width


class CsrGatLayout(NamedTuple):
    """Both CSR views of an edge list from ``num_src`` source rows into
    ``num_nodes`` destination rows (equal for a square, self-looped graph).
    ``num_edges`` counts the input list, padding included: it is the row
    count of a keep mask, which is indexed by edge id."""
    dst: GatSide
    src: GatSide
    num_nodes: int
    num_edges: int
    num_src: int

    @classmethod
    @span("tfg.setup.gat_layout")
    def build(cls, edge_index, num_nodes: int, hub_degree: int = HUB_DEGREE,
              device="cuda", num_src: Optional[int] = None) -> "CsrGatLayout":
        """Host-side build from ``edge_index`` [2, E] (row = destination,
        in ``[0, num_nodes)``; column = source, in ``[0, num_src)``, default
        ``num_nodes``). Out-of-range (padding) edges are dropped, as
        ``build_gat_layout_bucketed`` and ``EllAdj.from_coo`` drop them."""
        ei = convert_union_to_numpy(edge_index, np.int64)
        if ei.ndim != 2 or ei.shape[0] != 2:
            raise ValueError(f"edge_index must be [2, E], got shape {ei.shape}")
        num_src = num_nodes if num_src is None else num_src
        num_edges = ei.shape[1]
        if num_edges >= 2 ** 31 - 1:
            raise ValueError("the attention kernels index edges with int32")
        rows, cols = ei[0], ei[1]
        ok = (rows >= 0) & (rows < num_nodes) & (cols >= 0) & (cols < num_src)
        rows, cols = rows[ok], cols[ok]
        eids = np.nonzero(ok)[0]
        return cls(dst=_build_side(rows, cols, eids, num_nodes, hub_degree, num_edges, device),
                   src=_build_side(cols, rows, eids, num_src, CHUNK, num_edges, device,
                                   source=True),
                   num_nodes=int(num_nodes), num_edges=int(num_edges), num_src=int(num_src))

    def to(self, device) -> "CsrGatLayout":
        """The same layout with its tensors on ``device``."""
        def move(side):
            return side._replace(**{f: getattr(side, f).to(device)
                                    for f in ("row_ptr", "nbr", "eid", "hubs", "row",
                                              "chunk_hub", "tickets")
                                    if getattr(side, f) is not None})
        return self._replace(dst=move(self.dst), src=move(self.src))

    def __repr__(self):
        deg = self.dst.row_ptr.diff()
        shape = (self.num_nodes if self.num_src == self.num_nodes
                 else f"{self.num_nodes}x{self.num_src}")
        return (f"CsrGatLayout(N={shape}, E={self.num_edges}, "
                f"nnz={int(self.dst.nbr.shape[0])}, dst_hubs={int(self.dst.hubs.shape[0])}, "
                f"src_hubs={int(self.src.hubs.shape[0])}, "
                f"max_in_degree={int(deg.max()) if deg.numel() else 0})")


def _scale(d: int) -> float:
    """1/√d rounded to float32, as the kernels receive it."""
    return float(np.float32(1.0 / np.sqrt(float(d))))


# ---------------------------------------------------------------------------
# plain versions (any device; float32 sums)
# ---------------------------------------------------------------------------

def _entries(side: GatSide):
    """(row of each CSR entry, its neighbour, its edge id) as int64."""
    ptr = side.row_ptr.long()
    rows = torch.repeat_interleave(torch.arange(ptr.shape[0] - 1, device=ptr.device),
                                   ptr[1:] - ptr[:-1])
    return rows, side.nbr.long(), side.eid.long()


def _head_dot(a, b, num_heads: int):
    """[M, H·d] · [M, H·d] -> [M, H] per-head dot products in float32."""
    return (a.float() * b.float()).view(a.shape[0], num_heads, -1).sum(-1)


def _per_head(rows_hd, w, num_heads: int):
    """[M, H·d] rows scaled by [M, H] weights, in float32."""
    return (rows_hd.float().view(rows_hd.shape[0], num_heads, -1)
            * w[:, :, None]).view(rows_hd.shape[0], -1)


def _scores(Q, K, num_heads, rows, cols):
    return _head_dot(Q[rows], K[cols], num_heads) * _scale(Q.shape[1] // num_heads)


def gat_forward_plain(side: GatSide, Q, K, V, num_heads: int, keep=None):
    """Plain version of the forward kernel: ``(out, lse)``, ``out`` [N, H·d]
    in Q's dtype, ``lse`` [N, H] float32 (both 0 on rows without edges)."""
    n, H = Q.shape[0], num_heads
    rows, cols, eids = _entries(side)
    s = _scores(Q, K, H, rows, cols)
    row_ids = rows[:, None].expand(-1, H)
    m = torch.full((n, H), float("-inf"), device=Q.device).scatter_reduce(
        0, row_ids, s, "amax", include_self=True)
    p = torch.exp(s - m[rows])
    denom = torch.zeros((n, H), device=Q.device).index_add_(0, rows, p)
    lse = torch.where(denom > 0, m + torch.log(denom + _EPS), torch.zeros_like(m))
    w = p / (denom[rows] + _EPS)
    if keep is not None:
        w = w * keep[eids]
    out = torch.zeros((n, Q.shape[1]), device=Q.device).index_add_(
        0, rows, _per_head(V[cols], w, H))
    return out.to(Q.dtype), lse


def gat_backward_dst_plain(side: GatSide, Q, K, V, out, lse, dy, num_heads: int, keep=None):
    """Plain version of the destination-side backward kernel: ``(dQ, D, w)``,
    ``dQ`` [N, H·d] in Q's dtype, ``D = <dy, out>_h`` [N, H] float32 and the
    per-edge weights ``w`` float32 [side.num_edges, 2H] by edge id: ``w[e, :H]
    = a_e·keep_e``, ``w[e, H:] = ds_e`` (0 on edges outside the side)."""
    H = num_heads
    rows, cols, eids = _entries(side)
    D = _head_dot(dy, out, H)
    a = torch.exp(_scores(Q, K, H, rows, cols) - lse[rows])
    da = _head_dot(dy[rows], V[cols], H)
    ak = a
    if keep is not None:
        da = da * keep[eids]
        ak = a * keep[eids]
    ds = a * (da - D[rows]) * _scale(Q.shape[1] // H)
    dQ = torch.zeros(Q.shape, device=Q.device).index_add_(0, rows, _per_head(K[cols], ds, H))
    w = torch.zeros((side.num_edges, 2 * H), device=Q.device)
    w[eids] = torch.cat([ak, ds], dim=1)
    return dQ.to(Q.dtype), D, w


def gat_backward_src_plain(side: GatSide, Q, dy, w, num_heads: int):
    """Plain version of the source-side backward kernel: ``(dK, dV)`` [S,
    H·d] in Q's dtype over the source side (``side.nbr`` is the
    destination), ``dK[c] = Σ w[e, H + h]·Q[r]`` and ``dV[c] = Σ w[e, h]·dy[r]``
    per head h with the destination pass's ``w``."""
    H = num_heads
    cols, rows, eids = _entries(side)
    we = w[eids]
    shape = (side.row_ptr.shape[0] - 1, Q.shape[1])
    dK = torch.zeros(shape, device=Q.device).index_add_(0, cols, _per_head(Q[rows], we[:, H:], H))
    dV = torch.zeros(shape, device=Q.device).index_add_(0, cols, _per_head(dy[rows], we[:, :H], H))
    return dK.to(Q.dtype), dV.to(Q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# side, heads, scale, keep, dtype, largest vector in bytes
_SIDE_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _I, _I]


def _check_launch(side: GatSide, num_heads: int, dense, source=(), stats=(), keep=None,
                  weights=None):
    """Raise unless every tensor has the type and shape the kernels take
    (checked first) and is a contiguous CUDA tensor on Q's device: ``dense``
    (Q first) with Q's shape, ``source`` (K first, for the destination-side
    passes) with K's, K as wide as Q, ``stats`` [N_Q, H] float32, ``keep``
    float32 [E, H] and ``weights`` float32 [E, 2H] with E =
    ``side.num_edges`` (the kernels index them by edge id), and a
    destination side with Q's rows; returns (N_Q, H, d)."""
    q = dense[0][1]
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"Q must be float32 or bfloat16, got {q.dtype}")
    n, width = q.shape if q.dim() == 2 else (None, None)
    if n is None or num_heads < 1 or width % num_heads:
        raise ValueError(f"Q must be [N, H·d] with H = {num_heads}, got {tuple(q.shape)}")
    groups = [(q, dense)]
    if source:
        k = source[0][1]
        if k.dim() != 2 or k.shape[1] != width:
            raise ValueError(f"K must be [S, {width}], got {tuple(k.shape)}")
        groups.append((k, source))
    for like, group in groups:
        for name, t in group:
            if t.dtype != q.dtype or t.shape != like.shape:
                raise ValueError(f"{name} must be {q.dtype} {tuple(like.shape)}: "
                                 f"{t.dtype} {tuple(t.shape)}")
    for name, t in stats:
        if t.dtype != torch.float32 or t.shape != (n, num_heads):
            raise ValueError(f"{name} must be float32 [{n}, {num_heads}]")
    for name, t, cols in (("keep", keep, num_heads), ("w", weights, 2 * num_heads)):
        if t is not None and (t.dtype != torch.float32 or t.shape != (side.num_edges, cols)):
            raise ValueError(f"{name} must be float32 [{side.num_edges}, {cols}] (the "
                             f"layout's edges), got {t.dtype} {tuple(t.shape)}")
    for name in ("row_ptr", "nbr", "eid", "hubs"):
        if getattr(side, name).dtype != torch.int32:
            raise TypeError(f"side.{name} must be int32")
    if source and side.row_ptr.shape != (n + 1,):
        raise ValueError(f"the layout side has {side.row_ptr.shape[0] - 1} rows, Q has {n}")
    tensors = list(dense) + list(source) + list(stats) + [
        ("row_ptr", side.row_ptr), ("nbr", side.nbr), ("eid", side.eid), ("hubs", side.hubs)]
    tensors += [(name, t) for name, t in (("keep", keep), ("w", weights)) if t is not None]
    require_cuda(tensors, q.device)
    return n, num_heads, width // num_heads


def _launch_pass(kind: int, symbol: str, side: GatSide, num_heads: int, d: int, keep,
                 tensors, extra_argtypes, family: str, extra=()) -> bool:
    """Allocate the hub scratch and launch pass ``kind`` (0 forward, 1 and
    2 the two backward sides) with the side and head arguments first;
    ``tensors`` are the dense inputs and outputs, then the statistics, then
    the values ``extra``. Returns False, launching nothing, for a layout
    without rows."""
    q = tensors[0]
    if side.row_ptr.shape[0] == 1:
        return False
    num_hubs = int(side.hubs.shape[0])
    vec_bytes = max_vec_bytes([t for t in tensors if t.dtype == q.dtype])
    floats = entry("gat_attention.cu", "tfg_gat_scratch_floats", [_I] * 7,
                   restype=ctypes.c_longlong)(kind, num_hubs, num_heads, d, q.element_size(),
                                              vec_bytes, side.nbr.shape[0])
    if floats < 0:
        raise ValueError(f"head width {d} is wider than the kernels' 32 vectors per head")
    scratch = torch.empty(floats, dtype=torch.float32, device=q.device) if floats else None
    launch("gat_attention.cu", symbol, _SIDE_ARGTYPES + extra_argtypes + [_P],
           (side.row_ptr.data_ptr(), side.nbr.data_ptr(), side.eid.data_ptr(),
            side.hubs.data_ptr() if num_hubs else None, num_hubs, side.row_ptr.shape[0] - 1,
            side.hub_degree, num_heads, d, _scale(d), None if keep is None else keep.data_ptr(),
            DTYPE_CODES[q.dtype], vec_bytes, *[t.data_ptr() for t in tensors], *extra,
            None if scratch is None else scratch.data_ptr()), q.device, family)
    return True


def launch_gat_forward(side: GatSide, Q, K, V, num_heads: int, keep=None):
    """Launch the forward kernel over the destination side; returns
    ``(out, lse)`` as ``gat_forward_plain`` does. Counts each launch
    (``launches.gat_forward``)."""
    n, H, d = _check_launch(side, num_heads, [("Q", Q)], [("K", K), ("V", V)], keep=keep)
    out = torch.empty_like(Q)
    lse = torch.empty((n, H), dtype=torch.float32, device=Q.device)
    _launch_pass(0, "tfg_gat_forward", side, H, d, keep, [Q, K, V, out, lse], [_P] * 5,
                 "gat_forward")
    return out, lse


def launch_gat_backward_dst(side: GatSide, Q, K, V, out, lse, dy, num_heads: int, keep=None):
    """Launch the destination-side backward kernel; returns ``(dQ, D, w)`` as
    ``gat_backward_dst_plain`` does, except that the rows of ``w`` of edges
    outside the side (padding) are left unwritten. Counts each launch
    (``launches.gat_backward_dst``)."""
    n, H, d = _check_launch(side, num_heads, [("Q", Q), ("out", out), ("dy", dy)],
                            [("K", K), ("V", V)], [("lse", lse)], keep)
    dQ = torch.empty_like(Q)
    D = torch.empty((n, H), dtype=torch.float32, device=Q.device)
    w = torch.empty((side.num_edges, 2 * H), dtype=torch.float32, device=Q.device)
    _launch_pass(1, "tfg_gat_backward_dst", side, H, d, keep,
                 [Q, K, V, out, dy, lse, dQ, D, w], [_P] * 9, "gat_backward_dst")
    return dQ, D, w


def launch_gat_backward_src(side: GatSide, Q, dy, w, num_heads: int):
    """Launch the source-side backward kernel, the weighted gather of Q and
    dy by the destination pass's ``w``; returns ``(dK, dV)`` as
    ``gat_backward_src_plain`` does. Counts each launch
    (``launches.gat_backward_src``) and the long rows it merges
    (``gat_src.merged``)."""
    _, H, d = _check_launch(side, num_heads, [("Q", Q), ("dy", dy)], weights=w)
    if side.hub_degree != CHUNK:
        raise ValueError(f"the source side's hubs must be its rows of more than {CHUNK} "
                         f"entries, got hub_degree {side.hub_degree}")
    num_hubs = int(side.hubs.shape[0])
    num_chunks = -(-int(side.nbr.shape[0]) // CHUNK)
    for name, t, n in (("chunk_hub", side.chunk_hub, num_chunks),
                       ("tickets", side.tickets, num_hubs)):
        if (t is None or t.dtype != torch.int32 or t.shape != (n,) or t.device != Q.device
                or not t.is_contiguous()):
            raise ValueError(f"side.{name} must be a contiguous int32 [{n}] tensor on "
                             f"{Q.device} (a source side of CsrGatLayout.build)")
    shape = (side.row_ptr.shape[0] - 1, Q.shape[1])
    dK = torch.empty(shape, dtype=Q.dtype, device=Q.device)
    dV = torch.empty(shape, dtype=Q.dtype, device=Q.device)
    if _launch_pass(2, "tfg_gat_backward_src", side, H, d, None,
                    [Q, dy, w, dK, dV, side.chunk_hub, side.tickets], [_P] * 7 + [_I],
                    "gat_backward_src", (num_chunks,)) and num_hubs:
        count("gat_src.merged", num_hubs)
    return dK, dV


def kernel_info(kind: int, num_heads: int, head_width: int, dtype,
                vec_bytes: int = 16) -> tuple:
    """(registers per thread, resident warps per SM) of the kernel instance
    that pass ``kind`` (0 forward, 1 and 2 the backward sides) launches for
    these heads and dtype on the card, from ``cudaFuncGetAttributes`` and
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    regs, warps = ctypes.c_int(0), ctypes.c_int(0)
    query("gat_attention.cu", "tfg_gat_kernel_info", [_I] * 5 + [_P, _P],
          (kind, num_heads, head_width, DTYPE_CODES[dtype], vec_bytes, ctypes.byref(regs),
           ctypes.byref(warps)))
    return regs.value, warps.value


# the three passes (0 forward, 1 and 2 the backward sides): kernels, plain versions
_KERNELS = (launch_gat_forward, launch_gat_backward_dst, launch_gat_backward_src)
_PLAIN = (gat_forward_plain, gat_backward_dst_plain, gat_backward_src_plain)


# ---------------------------------------------------------------------------
# autograd and the public function
# ---------------------------------------------------------------------------

class _GatAttention(torch.autograd.Function):
    @staticmethod
    @span("tfg.ops.gat_attention.forward")
    def forward(ctx, Q, K, V, layout, num_heads, keep, plain):
        passes = _KERNELS if use_kernel(Q, plain, "GAT attention") else _PLAIN
        out, lse = passes[0](layout.dst, Q, K, V, num_heads, keep)
        ctx.save_for_backward(Q, K, V, out, lse, keep)
        ctx.layout, ctx.num_heads, ctx.passes = layout, num_heads, passes
        return out

    @staticmethod
    @span("tfg.ops.gat_attention.backward")
    def backward(ctx, dy):
        Q, K, V, out, lse, keep = ctx.saved_tensors
        layout, H, passes = ctx.layout, ctx.num_heads, ctx.passes
        dy = dy.contiguous()
        dQ, _, w = passes[1](layout.dst, Q, K, V, out, lse, dy, H, keep)
        dK, dV = passes[2](layout.src, Q, dy, w, H)
        return dQ, dK, dV, None, None, None, None


def gat_attention_csr(layout: CsrGatLayout, Q, K, V, num_heads: int,
                      edge_drop_rate: float = 0.0, training: bool = False,
                      generator: Optional[torch.Generator] = None, keep_mask=None,
                      compute_dtype=None):
    """Fused GAT attention, ``gat_attention_bucketed``'s contract: Q is
    [layout.num_nodes, H·d], K and V [layout.num_src, H·d], head-blocked with
    equal head width; returns [layout.num_nodes, H·d] in V's dtype.

    Q, K and V are cast to ``compute_dtype`` (default
    ``ops.config.ell_compute_dtype``) for the passes. Training with
    ``edge_drop_rate > 0`` drops attention weights: ``keep_mask`` [E, H]
    float, in edge-id order of the layout's edge list, 1/(1 - rate) scale
    included, or a mask drawn with ``generator``; one of the two is
    required.
    """
    H = num_heads
    if Q.dim() != 2 or Q.shape[1] % H or V.shape[1] % H:
        raise ValueError(f"Q and V must be [N, H·d] with H = {H}: "
                         f"{tuple(Q.shape)}, {tuple(V.shape)}")
    if Q.shape[1] != V.shape[1] or K.shape != V.shape:
        raise NotImplementedError(
            "fused GAT attention needs equal query, key and value head widths")
    if Q.shape[0] != layout.num_nodes or V.shape[0] != layout.num_src:
        raise ValueError(f"Q must have {layout.num_nodes} rows and K, V {layout.num_src}")
    dropping = training and edge_drop_rate > 0.0
    if dropping and generator is None and keep_mask is None:
        raise ValueError(
            "gat_attention_csr requires a generator or keep_mask when training with "
            "edge_drop_rate > 0 (a silent no-op would train unregularized)")
    keep = None
    if dropping:
        if keep_mask is None:
            keep_mask = ((torch.rand((layout.num_edges, H), generator=generator,
                                     device=Q.device) < 1.0 - edge_drop_rate).float()
                         / (1.0 - edge_drop_rate))
        keep = torch.as_tensor(keep_mask, dtype=torch.float32, device=Q.device).contiguous()
        if keep.shape != (layout.num_edges, H):
            raise ValueError(f"keep_mask must be [{layout.num_edges}, {H}], "
                             f"got {tuple(keep.shape)}")
    cd = compute_dtype if compute_dtype is not None else _config.ell_compute_dtype
    out_dtype = V.dtype
    if cd is not None:
        Q, K, V = Q.to(cd), K.to(cd), V.to(cd)
    out = _GatAttention.apply(Q.contiguous(), K.contiguous(), V.contiguous(), layout, H,
                              keep, _config.plain_versions)
    return out.to(out_dtype)


# The JAX package's ``ops/ell_attention.py`` runs the same fused attention on
# a uniform-K ELL packing, over each rank's rectangular ``[npp] <- [npp ‖
# P·cap]`` layout in the graph-parallel GAT (``parallel/halo.py``); here it is
# this function over a rectangular ``CsrGatLayout``.
gat_attention_ell = gat_attention_csr
