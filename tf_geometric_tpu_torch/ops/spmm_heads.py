"""H-head SpMM and SDDMM over a CSR view: the view, the plain versions,
the kernel wrappers (``csrc/spmm_heads.cu``) and the multi-head SpMM.

The two products serve both TPU kernels that are left on one chip:

- the COO SpMM of ``tf_geometric_tpu/ops/spmm.py`` (``ops/spmm.py`` here,
  one head): ``y = A·h`` on a view sorted by row, ``dh = Aᵀ·dy`` on a view
  sorted by column, ``dv[e] = <dy[row_e], h[col_e]>`` by the SDDMM;
- the multi-head SpMM ``ell_spmm_multihead`` of ``tf_geometric_tpu/ops/ell.py``
  (``spmm_multihead`` below): ``out[r, h·d + j] = Σ att[e, h]·v[c_e, h·d + j]``
  on a ``CsrGatLayout``'s destination side, ``dV`` on its source side,
  ``d_att[e, h] = <dy[r_e], v[c_e]>_h`` by the SDDMM.

A view is any object with ``row_ptr`` [R + 1], ``nbr`` and ``eid`` (int32):
row ``r``'s entries are ``row_ptr[r]:row_ptr[r + 1]``, each naming a row of
the gathered operand and an edge id (a row of the [E, H] weight or output).
``build_csr_view`` makes one on the tensors' device by a stable sort, so a
row's entries keep their edge order and the kernels sum in that order with
no atomics: the same bits in every run. ``GatSide`` is a view too.

The SpMM kernel splits long rows across lane groups: the view's entries
fall into chunks of ``CHUNK`` (64); a row with more entries is a long row,
and a first kernel sums each long row's entries inside each chunk that
starts in it into a float32 partial, which the row kernel adds after the
row's entries before its first chunk boundary, in chunk order
(``row_split`` mirrors the plan on the host side). A chunk's row is the
view's ``row`` at its first entry: the sorted keys of ``build_csr_view``
(so a view built on the device needs no host sync) or the host-built
``GatSide.row``. The SDDMM needs no split: each entry's output is its own,
so a lane group takes each ``CHUNK`` consecutive entries of the view,
whatever their rows, and reads each entry's row (``sddmm_entry_rows``:
the view's ``row``, or found from ``row_ptr`` on the device for a view
without one).

Each op has a plain PyTorch version with the same contract. A CPU tensor
takes the plain version, a CUDA tensor launches the kernel, and a failed
launch raises; inside ``ops.config.use_plain_versions()`` the plain versions
run on any device (the on-card reference of ``chip_smoke.py``).

Bound on the H100: bytes (``spmm_pass_bytes``, ``sddmm_pass_bytes``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..utils.profiling import count, span
from . import _build
from . import config as _config

__all__ = ["CsrView", "build_csr_view", "spmm_heads", "sddmm_heads", "spmm_heads_plain",
           "sddmm_heads_plain", "launch_spmm_heads", "launch_sddmm_heads", "spmm_multihead",
           "view_entries", "spmm_pass_bytes", "sddmm_pass_bytes", "pass_flops", "CHUNK",
           "RowSplit", "row_split", "spmm_heads_launches", "sddmm_entry_rows"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int

# Entries per chunk of the lane-group gather (kChunk in csrc/lane_gather.cuh,
# read from there; the SpMM kernel's and the GAT source pass's), the same
# width as Kernel A's SPLIT_WIDTH: a lane group keeps 8 gathers in flight, so
# a 64-entry piece is a few trips to memory.
CHUNK = _build.header_constant("lane_gather.cuh", "kChunk")


class CsrView(NamedTuple):
    """A CSR view of a COO edge list (see the module docstring); ``nbr``,
    ``eid`` and ``row`` have one entry per input edge, those past
    ``row_ptr[-1]`` unused. ``row`` is each entry's row (the row count past
    ``row_ptr[-1]``), which the SpMM's chunks and the SDDMM read; it may be
    None on a view that only the SDDMM reads (``sddmm_entry_rows``)."""
    row_ptr: torch.Tensor   # [R + 1] int32
    nbr: torch.Tensor       # [E] int32, clamped to the gathered operand's rows
    eid: torch.Tensor       # [E] int32
    row: Optional[torch.Tensor] = None   # [E] int32, R past row_ptr[-1]


def build_csr_view(keys, nbrs, num_rows: int, num_nbrs: int) -> CsrView:
    """The view of edges ``keys[e] <- nbrs[e]`` over ``num_rows`` rows, on
    the tensors' device: an edge whose key is out of ``[0, num_rows)`` is
    dropped, a neighbour is clamped to ``[0, num_nbrs - 1]`` (every edge is
    dropped when ``num_nbrs`` is 0). A stable sort keeps each row's edges in
    edge order. Builds a layout; no product is computed here."""
    keys = keys.long()
    if keys.shape[0] >= 2 ** 31 - 1 or num_rows >= 2 ** 31 - 1:
        raise ValueError("the SpMM kernels index rows and edges with int32")
    valid = (keys >= 0) & (keys < num_rows)
    if num_nbrs == 0:
        valid = torch.zeros_like(valid)
    # int32 keys: half the radix passes of int64 ones
    sorted_keys, perm = torch.sort(torch.where(valid, keys, num_rows).int(), stable=True)
    row_ptr = torch.searchsorted(sorted_keys, torch.arange(num_rows + 1, dtype=torch.int32,
                                                           device=keys.device))
    nbr = nbrs.long()[perm].clamp(0, max(num_nbrs - 1, 0))
    return CsrView(row_ptr.int(), nbr.int(), perm.int(), sorted_keys)


def view_entries(view):
    """(row, neighbour, edge id) of each stored entry, int64."""
    ptr = view.row_ptr.long()
    nnz = int(ptr[-1])
    rows = torch.repeat_interleave(torch.arange(ptr.shape[0] - 1, device=ptr.device),
                                   ptr[1:] - ptr[:-1], output_size=nnz)
    return rows, view.nbr[:nnz].long(), view.eid[:nnz].long()


class RowSplit(NamedTuple):
    """How the SpMM kernel covers each row of a view (``row_split``): row
    r's entries ``row_ptr[r]:direct_end[r]`` are summed directly, then the
    partials of chunks ``chunk_lo[r]:chunk_hi[r]`` (empty for a short row),
    where chunk c holds the row's entries ``c·CHUNK:min(c·CHUNK + CHUNK,
    row_ptr[r + 1])``. ``chunk_row`` [chunks] is the row that holds each
    chunk's first entry (-1 past the stored entries), as the kernel finds it."""
    direct_end: torch.Tensor   # [R] int64
    chunk_lo: torch.Tensor     # [R] int64
    chunk_hi: torch.Tensor     # [R] int64
    chunk_row: torch.Tensor    # [chunks] int64


def _num_chunks(num_entries: int) -> int:
    """The chunk kernel's grid: 0 when a view holds at most ``CHUNK``
    entries (no row can be long), else one chunk per ``CHUNK`` entries."""
    return 0 if num_entries <= CHUNK else -(-num_entries // CHUNK)


def spmm_heads_launches(num_entries: int) -> int:
    """Kernel launches of one SpMM call on a view of ``num_entries``
    entries (``view.nbr``'s length): the chunks' and the rows', or the rows'
    alone when no row can be long."""
    return 1 + (_num_chunks(num_entries) > 0)


def row_split(row_ptr) -> RowSplit:
    """The SpMM kernel's plan for a view's ``row_ptr``, on its device."""
    ptr = row_ptr.long()
    start, end = ptr[:-1], ptr[1:]
    long_row = end - start > CHUNK
    chunk_lo = torch.where(long_row, (start + CHUNK - 1) // CHUNK, 0)
    chunk_hi = torch.where(long_row, (end - 1) // CHUNK + 1, 0)
    direct_end = torch.where(long_row, chunk_lo * CHUNK, end)
    nnz = int(ptr[-1])
    firsts = torch.arange(0, max(nnz, 1), CHUNK, device=ptr.device)
    chunk_row = torch.searchsorted(ptr, firsts, right=True) - 1
    chunk_row = torch.where(firsts < nnz, chunk_row, -1)
    return RowSplit(direct_end, chunk_lo, chunk_hi, chunk_row)


def sddmm_entry_rows(view):
    """Each stored entry's row as the SDDMM kernel reads it, int32 [E], on
    the view's device: ``view.row`` where the view has it, else found from
    ``row_ptr`` by a search (no host sync). Past ``row_ptr[-1]`` it is the
    row count, which the kernel skips."""
    if view.row is not None:
        return view.row
    ptr = view.row_ptr
    ids = torch.arange(view.nbr.shape[0], dtype=ptr.dtype, device=ptr.device)
    return (torch.searchsorted(ptr, ids, right=True) - 1).int()


# ---------------------------------------------------------------------------
# plain versions (any device; float32 sums)
# ---------------------------------------------------------------------------

def spmm_heads_plain(view, w, src, num_heads: int, out_dtype=None):
    """Plain version of the SpMM kernel: ``out`` [R, H·d] in ``out_dtype``
    (default ``src``'s), ``out[r, h·d + j] = Σ_i w[eid_i, h]·src[nbr_i, h·d + j]``
    over row r's entries, summed in float32 by ``index_add_``."""
    rows, nbr, eid = view_entries(view)
    n_out, width = view.row_ptr.shape[0] - 1, src.shape[1]
    msg = (src[nbr.clamp(0, src.shape[0] - 1)].float().view(-1, num_heads, width // num_heads)
           * w[eid][:, :, None])
    out = torch.zeros((n_out, width), dtype=torch.float32, device=src.device)
    out.index_add_(0, rows, msg.view(-1, width))
    return out.to(src.dtype if out_dtype is None else out_dtype)


def sddmm_heads_plain(view, a, b, num_heads: int, out):
    """Plain version of the SDDMM kernel: writes ``out[eid_i, h] = <a[r],
    b[nbr_i]>_h`` (float32 [E, H]) for each entry i of row r; returns out."""
    rows, nbr, eid = view_entries(view)
    prod = a[rows].float() * b[nbr.clamp(0, b.shape[0] - 1)].float()
    out[eid] = prod.view(rows.shape[0], num_heads, a.shape[1] // num_heads).sum(-1)
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_view(view, device):
    for name in ("row_ptr", "nbr", "eid"):
        t = getattr(view, name)
        if not t.is_cuda or t.device != device:
            raise ValueError(f"view.{name} must be a CUDA tensor on {device}, got {t.device}")
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"view.{name} must be a contiguous 1-D int32 tensor")
    if view.nbr.shape != view.eid.shape:
        raise ValueError("view.nbr and view.eid must have one length")


def _check_entry_rows(row, view, device):
    if (row.shape != view.nbr.shape or row.dtype != torch.int32 or row.device != device
            or not row.is_contiguous()):
        raise ValueError("view.row must be contiguous int32, one per entry, on the device")


def _check_dense(name, t, device, num_heads):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if t.dim() != 2 or t.shape[1] < 1 or num_heads < 1 or t.shape[1] % num_heads:
        raise ValueError(f"{name} must be [rows, H·d] with H = {num_heads}, got {tuple(t.shape)}")


def _vec_elements(head_width: int, loaded, stored=()) -> int:
    """Elements per lane vector: the largest power of two that divides the
    head width, spans at most 16 bytes of the ``loaded`` tensors (one dtype)
    and keeps every tensor's base address aligned to its vector (to 16
    bytes for a wider stored vector, which the kernel writes in halves)."""
    vec, elt = 1, loaded[0].element_size()
    while 2 * vec * elt <= 16 and head_width % (2 * vec) == 0 and all(
            t.data_ptr() % min(2 * vec * t.element_size(), 16) == 0
            for t in (*loaded, *stored)):
        vec *= 2
    return vec


def launch_spmm_heads(view, w, src, num_heads: int, out_dtype=None):
    """Launch the SpMM kernels; returns ``out`` as ``spmm_heads_plain`` does
    (``out_dtype``: ``src``'s, or float32 for a bfloat16 ``src``). ``w``
    float32 [E, H]. Counts each launch (``launches.spmm_heads``): two a call (the
    chunks', then the rows'; ``spmm_heads_launches``), one for a view of at
    most ``CHUNK`` entries."""
    _check_view(view, src.device)
    _check_dense("src", src, src.device, num_heads)
    out_dtype = src.dtype if out_dtype is None else out_dtype
    if out_dtype not in (src.dtype, torch.float32):
        raise TypeError(f"out_dtype must be {src.dtype} or float32, got {out_dtype}")
    if (w.dtype != torch.float32 or w.dim() != 2 or w.shape[1] != num_heads or not w.is_cuda
            or w.device != src.device or not w.is_contiguous()):
        raise ValueError(f"w must be a contiguous float32 CUDA tensor [E, {num_heads}]")
    rows, width = view.row_ptr.shape[0] - 1, src.shape[1]
    out = torch.empty((rows, width), dtype=out_dtype, device=src.device)
    if rows == 0:
        return out
    if src.shape[0] == 0:
        raise ValueError("src has no rows to gather")
    d = width // num_heads
    vec = _vec_elements(d, [src], [out])
    chunks = _num_chunks(view.nbr.shape[0])
    if chunks:
        if view.row is None:
            raise ValueError("the SpMM's chunks need view.row")
        _check_entry_rows(view.row, view, src.device)
    partial = torch.empty((chunks, width), dtype=torch.float32, device=src.device)
    fn = _build.kernel_function("spmm_heads.cu", "tfg_spmm_heads", [_P] * 5 + [_I, _I, _P]
                                + [_I] * 2 + [_P] + [_I] * 3 + [_P, _I, _P])
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = fn(view.row_ptr.data_ptr(), view.row.data_ptr() if chunks else None,
                view.nbr.data_ptr(), view.eid.data_ptr(), w.data_ptr(), num_heads, d,
                src.data_ptr(), _DTYPE_CODES[src.dtype], src.shape[0], out.data_ptr(),
                _DTYPE_CODES[out_dtype], rows, vec, partial.data_ptr() if chunks else None,
                chunks, stream)
    if rc != 0:
        raise RuntimeError(f"spmm_heads kernel launch failed: cudaError {rc}")
    count("launches.spmm_heads", 1 + (chunks > 0))
    return out


def launch_sddmm_heads(view, a, b, num_heads: int, out):
    """Launch the SDDMM kernel (one launch: a lane group per ``CHUNK``
    consecutive entries of the view, each entry's row from
    ``sddmm_entry_rows``); writes ``out`` (float32 [E, H], contiguous) as
    ``sddmm_heads_plain`` does and returns it. ``a`` and ``b`` share one
    dtype. Counts each launch (``launches.sddmm_heads``)."""
    _check_view(view, a.device)
    _check_dense("a", a, a.device, num_heads)
    _check_dense("b", b, a.device, num_heads)
    if b.dtype != a.dtype or b.shape[1] != a.shape[1]:
        raise ValueError(f"b must match a's dtype and width: {b.dtype} {tuple(b.shape)}")
    rows = view.row_ptr.shape[0] - 1
    if a.shape[0] != rows:
        raise ValueError(f"a must have the view's {rows} rows, got {a.shape[0]}")
    if (out.dtype != torch.float32 or out.dim() != 2 or out.shape[1] != num_heads
            or out.device != a.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 tensor [E, {num_heads}] on {a.device}")
    if rows == 0:
        return out
    if b.shape[0] == 0:
        raise ValueError("b has no rows to gather")
    d = a.shape[1] // num_heads
    vec = _vec_elements(d, [a, b])
    entry_row = sddmm_entry_rows(view)
    _check_entry_rows(entry_row, view, a.device)
    fn = _build.kernel_function("spmm_heads.cu", "tfg_sddmm_heads",
                                [_P] * 5 + [_I] * 4 + [_P] + [_I] * 3 + [_P])
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(entry_row.data_ptr(), view.nbr.data_ptr(), view.eid.data_ptr(), a.data_ptr(),
                b.data_ptr(), _DTYPE_CODES[a.dtype], b.shape[0], num_heads, d, out.data_ptr(),
                rows, view.nbr.shape[0], vec, stream)
    if rc != 0:
        raise RuntimeError(f"sddmm_heads kernel launch failed: cudaError {rc}")
    count("launches.sddmm_heads")
    return out


def _use_kernel(t, plain: bool, what: str) -> bool:
    if t.is_cuda and not plain:
        return True
    if not plain and t.device.type != "cpu":
        raise NotImplementedError(f"no {what} kernel for device {t.device}")
    return False


def spmm_heads(view, w, src, num_heads: int, out_dtype=None, plain: bool = False):
    """The H-head SpMM: its kernel on a CUDA ``src``, its plain version on a
    CPU one or under ``plain``."""
    if _use_kernel(src, plain, "H-head SpMM"):
        return launch_spmm_heads(view, w.float().contiguous(), src.contiguous(), num_heads,
                                 out_dtype)
    return spmm_heads_plain(view, w.float(), src, num_heads, out_dtype)


def sddmm_heads(view, a, b, num_heads: int, out, plain: bool = False):
    """The H-head SDDMM into ``out`` (float32 [E, H]): its kernel on a CUDA
    ``a``, its plain version on a CPU one or under ``plain``. ``a`` and ``b``
    go in at their common dtype."""
    common = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(common), b.to(common)
    if _use_kernel(a, plain, "H-head SDDMM"):
        return launch_sddmm_heads(view, a.contiguous(), b.contiguous(), num_heads, out)
    return sddmm_heads_plain(view, a, b, num_heads, out)


# ---------------------------------------------------------------------------
# the multi-head SpMM (ell_spmm_multihead's contract)
# ---------------------------------------------------------------------------

class _MultiheadSpmm(torch.autograd.Function):
    """``out = A_att·v`` per head on the layout's destination side; the
    backward gives ``d_att`` (SDDMM on the destination side) and ``dV``
    (SpMM on the source side) with the forward's weights."""

    @staticmethod
    @span("tfg.ops.spmm_heads.forward")
    def forward(ctx, att, v, layout, plain):
        w = att.to(v.dtype).float().contiguous()  # the weights in v's dtype, as ell.py:246
        ctx.save_for_backward(w, v)
        ctx.layout, ctx.plain, ctx.att_dtype = layout, plain, att.dtype
        return spmm_heads(layout.dst, w, v, att.shape[1], plain=plain)

    @staticmethod
    @span("tfg.ops.spmm_heads.backward")
    def backward(ctx, dy):
        w, v = ctx.saved_tensors
        layout, plain, H = ctx.layout, ctx.plain, w.shape[1]
        dy = dy.contiguous()
        d_att = dv = None
        if ctx.needs_input_grad[1]:
            dv = spmm_heads(layout.src, w, dy, H, plain=plain)
        if ctx.needs_input_grad[0]:
            d_att = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
            sddmm_heads(layout.dst, dy, v, H, d_att, plain=plain)
            d_att = d_att.to(ctx.att_dtype)
        return d_att, dv, None, None


def spmm_multihead(layout, edge_att, v, d_head: int):
    """Attention-weighted multi-head aggregation (``ell_spmm_multihead``):
    ``edge_att`` [E, H] per-edge per-head weights in the edge-id order of
    ``layout`` (a ``CsrGatLayout``), ``v`` [N, H·d_head] head-blocked values;
    returns [N, H·d_head] in ``v``'s dtype, summed in float32. The weights
    are cast to ``v``'s dtype first, as the JAX function casts them."""
    if edge_att.dim() != 2 or edge_att.shape[0] != layout.num_edges:
        raise ValueError(f"edge_att must be [{layout.num_edges}, H], got {tuple(edge_att.shape)}")
    H = edge_att.shape[1]
    if v.dim() != 2 or v.shape != (layout.num_nodes, H * d_head):
        raise ValueError(f"v must be [{layout.num_nodes}, {H * d_head}], got {tuple(v.shape)}")
    return _MultiheadSpmm.apply(edge_att, v.contiguous(), layout, _config.plain_versions)


# ---------------------------------------------------------------------------
# least traffic and work, for the bounds of chip_smoke.py and the bench
# ---------------------------------------------------------------------------

def spmm_pass_bytes(nnz: int, rows: int, num_src: int, width: int, num_heads: int,
                    src_bytes: int, out_bytes: int) -> int:
    """Least bytes of one SpMM pass: the row pointers, each stored entry's
    neighbour and edge id and its H float32 weights read once, ``src``
    [num_src, F] read and ``out`` [rows, F] written."""
    return (4 * (rows + 1) + nnz * (8 + 4 * num_heads)
            + num_src * width * src_bytes + rows * width * out_bytes)


def sddmm_pass_bytes(nnz: int, rows: int, num_b: int, width: int, num_heads: int,
                     elt_bytes: int) -> int:
    """Least bytes of one SDDMM pass: the row pointers and each stored
    entry's neighbour and edge id read, ``a`` [rows, F] and ``b`` [num_b, F]
    read, H float32 values written per entry."""
    return (4 * (rows + 1) + nnz * (8 + 4 * num_heads)
            + (rows + num_b) * width * elt_bytes)


def pass_flops(nnz: int, width: int) -> int:
    """Flops of either pass: a multiply-add per stored entry and feature."""
    return 2 * nnz * width
