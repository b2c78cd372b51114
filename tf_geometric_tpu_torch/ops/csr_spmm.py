"""CSR SpMM with split hub rows: Kernel A, its plain version, its wrapper, the
``CsrAdj`` layout and the autograd function.

Counterpart of ``tf_geometric_tpu/ops/ell_bucketed.py`` (``BucketedEllAdj``
and ``bucketed_spmm``): ``y = A·h`` with constant edge values, the diagonal
kept apart as ``h·diag``, and a backward ``dh = Aᵀ·dy`` computed by the same
kernel on a transposed layout with the same diagonal.

What carries over and what does not. The JAX layout groups rows into
degree buckets with a slot width each, chosen by a TPU cost model; on
Hopper a lane group walks a CSR row of any length, so the port drops the
buckets and the cost model. It keeps the hub split, with a width set by the
card: a row with more than ``split_width`` (``SPLIT_WIDTH``, 64) edges owns
none of them itself; they are cut into virtual rows of at most
``split_width`` edges, stored after the ordinary rows, so that no lane
group walks a 2,838-edge row while the rest of the grid idles. Kernel A
(``csrc/csr_spmm.cu``) writes every ordinary row of the output and one
float32 partial per virtual row, and in the same launch merges each hub's
partials into its owner row, in order: the group that stores a hub's last
partial (it counts them on the side's ``tickets``) adds them up. The JAX
layout instead keeps a hub's remainder edges in the owner row; the sums are
the same.

Bound on the H100: bytes. Per call the kernel must read h, row_ptr, col,
val (and the diagonal) and write the output once; it does 2 flops per
gathered element.

``side_matmul`` dispatches on the device of ``h``: a CPU tensor takes the
plain PyTorch version, a CUDA tensor launches the kernel, and a failed
launch raises. One side must not be multiplied on two streams at once: the
launches share its tickets.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.profiling import count, span
from ..utils.union_utils import convert_union_to_numpy
from . import _build
from .sorted_segment import sorted_segment_sum_plain
from .spmm_heads import _vec_elements

__all__ = ["CsrSide", "CsrAdj", "csr_spmm", "side_matmul", "side_matmul_plain",
           "csr_spmm_plain", "launch_csr_spmm", "serial_walks", "SPLIT_WIDTH"]

# The longest row one lane group of Kernel A walks; a longer row is cut into
# virtual rows whose float32 partials the launch then adds into it. A group keeps 8
# gathers in flight, so a walk of w edges is about 2 + w / 8 dependent trips
# to memory. chip_smoke.py's split sweep on the H100 (PERF.md §6) puts 64
# within 3% of the fastest width at both main-path widths (F = 40 float32,
# F = 256 bf16), while 256, the JAX layout's widest slot group (_MAX_CAP in
# ops/ell_bucketed.py), is 40% slower at F = 40; 64 keeps every walk short,
# the hub merge's too (45 partials for the largest arxiv hub).
SPLIT_WIDTH = 64

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class CsrSide(NamedTuple):
    """One product direction: ``num_rows`` ordinary rows, then
    ``num_virtual`` virtual rows holding the edges of split hubs.

    ``owner_rows`` [H] lists the split hub rows in order and ``owner_ptr``
    [H + 1] gives hub i the virtual rows ``owner_ptr[i]:owner_ptr[i + 1]``
    (both None when no row was split); ``tickets`` [H], zeros between
    launches, counts the hubs' stored partials during one; ``eid`` maps
    each stored edge to its index in the COO input, for
    ``with_edge_values``."""
    row_ptr: torch.Tensor            # [num_rows + num_virtual + 1] int32
    col: torch.Tensor                # [nnz] int32
    val: torch.Tensor                # [nnz] float32
    eid: torch.Tensor                # [nnz] int64
    owner_rows: Optional[torch.Tensor]  # [H] int32, or None
    owner_ptr: Optional[torch.Tensor]   # [H + 1] int32, or None
    tickets: Optional[torch.Tensor]     # [H] int32, or None
    num_rows: int
    num_virtual: int


def _build_side(rows, cols, vals, eids, num_rows: int, split_width: int,
                device) -> CsrSide:
    """Host-side CSR build with hub rows split into virtual rows."""
    order = np.argsort(rows, kind="stable")
    r, c, v, e = rows[order], cols[order], vals[order], eids[order]
    deg = np.bincount(r, minlength=num_rows).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(deg)[:-1]]).astype(np.int64)
    pos = np.arange(len(r), dtype=np.int64) - starts[r]
    chunks = np.where(deg > split_width, -(-deg // split_width), 0)
    num_virtual = int(chunks.sum())
    v_start = np.concatenate([[0], np.cumsum(chunks)[:-1]]).astype(np.int64)
    # an edge of a hub goes to virtual row num_rows + v_start[row] + pos // w;
    # both keys keep the stable within-row edge order
    is_hub = chunks[r] > 0
    new_row = np.where(is_hub, num_rows + v_start[r] + pos // split_width, r)
    order2 = np.argsort(new_row, kind="stable")
    new_row, c, v, e = new_row[order2], c[order2], v[order2], e[order2]
    counts = np.bincount(new_row, minlength=num_rows + num_virtual)
    row_ptr = np.concatenate([[0], np.cumsum(counts)])
    owner_rows = owner_ptr = tickets = None
    if num_virtual:
        hubs = np.nonzero(chunks)[0]
        count("hubs.split", len(hubs))
        count("hubs.virtual_rows", num_virtual)
        owner_rows = torch.as_tensor(hubs.astype(np.int32), device=device)
        owner_ptr = torch.as_tensor(
            np.concatenate([[0], np.cumsum(chunks[hubs])]).astype(np.int32), device=device)
        tickets = torch.zeros(len(hubs), dtype=torch.int32, device=device)
    return CsrSide(
        row_ptr=torch.as_tensor(row_ptr.astype(np.int32), device=device),
        col=torch.as_tensor(c.astype(np.int32), device=device),
        val=torch.as_tensor(v.astype(np.float32), device=device),
        eid=torch.as_tensor(e.astype(np.int64), device=device),
        owner_rows=owner_rows, owner_ptr=owner_ptr, tickets=tickets, num_rows=num_rows,
        num_virtual=num_virtual)


# ---------------------------------------------------------------------------
# Kernel A: plain version and wrapper
# ---------------------------------------------------------------------------

def csr_spmm_plain(row_ptr, col, val, h, diag, num_rows: int):
    """Plain PyTorch version of Kernel A without the hub merge, same
    contract: returns ``(out, partial)`` with ``out`` [num_rows, F] in
    ``h``'s dtype (ordinary rows, plus ``diag·h``) and ``partial``
    [num_virtual, F] float32 (virtual rows). Sums run in float32 by
    ``index_add_``."""
    out, partial = _csr_spmm_plain_f32(row_ptr, col, val, h, diag, num_rows)
    return out.to(h.dtype), partial


def _csr_spmm_plain_f32(row_ptr, col, val, h, diag, num_rows: int):
    """``csr_spmm_plain`` with ``out`` left in float32."""
    total_rows = row_ptr.shape[0] - 1
    ptr = row_ptr.long()
    row_of_edge = torch.repeat_interleave(
        torch.arange(total_rows, device=h.device), ptr[1:] - ptr[:-1])
    msg = h.index_select(0, col.long()).float() * val[:, None]
    acc = torch.zeros((total_rows, h.shape[1]), dtype=torch.float32, device=h.device)
    acc.index_add_(0, row_of_edge, msg)
    out = acc[:num_rows]
    if diag is not None:
        out = out + diag[:, None] * h[:num_rows].float()
    return out, acc[num_rows:]


def serial_walks(side: CsrSide):
    """The longest serial walks of one product direction: the most edges
    one lane group of Kernel A reads (its longest stored row) and the most
    partials its hub merge adds into one hub row."""
    edges = int(side.row_ptr.diff().max()) if side.row_ptr.shape[0] > 1 else 0
    partials = int(side.owner_ptr.diff().max()) if side.num_virtual else 0
    return edges, partials


def launch_csr_spmm(row_ptr, col, val, h, diag, num_rows: int, hubs=None):
    """Launch Kernel A. ``row_ptr`` int32 [R' + 1], ``col`` int32 and ``val``
    float32 [nnz], ``h`` [n_src, F] float32 or bfloat16, ``diag`` float32
    [num_rows] or None; all contiguous CUDA tensors on one device. Allocates
    ``out`` [num_rows, F] (h's dtype) and ``partial`` [R' - num_rows, F]
    (float32) and returns both. With ``hubs`` = ``(owner_rows, owner_ptr,
    tickets)`` of the side (int32; tickets all 0, and no other launch using
    them meanwhile) the launch also merges each hub's partials into its row
    of ``out``, as ``side_matmul_plain`` does; without, a hub row holds
    ``diag·h`` only. Counts each launch (``launches.csr_spmm``) and the
    hubs it merges (``hubs.merged``)."""
    tensors = [("row_ptr", row_ptr), ("col", col), ("val", val), ("h", h)]
    if diag is not None:
        tensors.append(("diag", diag))
    if hubs is not None:
        tensors += list(zip(("owner_rows", "owner_ptr", "tickets"), hubs))
    for name, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if h.dtype not in _DTYPE_CODES:
        raise TypeError(f"h must be float32 or bfloat16, got {h.dtype}")
    if row_ptr.dtype != torch.int32 or col.dtype != torch.int32:
        raise TypeError("row_ptr and col must be int32")
    if val.dtype != torch.float32 or (diag is not None and diag.dtype != torch.float32):
        raise TypeError("val and diag must be float32")
    if h.dim() != 2:
        raise ValueError(f"h must be [n_src, F], got shape {tuple(h.shape)}")
    if row_ptr.dim() != 1 or col.shape != val.shape or col.dim() != 1:
        raise ValueError("row_ptr, col and val must be 1-D, col and val of one length")
    total_rows = row_ptr.shape[0] - 1
    num_virtual = total_rows - num_rows
    if num_virtual < 0:
        raise ValueError(f"row_ptr covers {total_rows} rows, fewer than {num_rows}")
    if diag is not None and (diag.shape != (num_rows,) or h.shape[0] < num_rows):
        raise ValueError("diag must be [num_rows] and h must have num_rows rows")
    if hubs is not None:
        owner_rows, owner_ptr, tickets = hubs
        num_hubs = owner_rows.shape[0]
        if any(t.dtype != torch.int32 for t in hubs):
            raise TypeError("owner_rows, owner_ptr and tickets must be int32")
        if (num_virtual == 0 or num_hubs == 0 or owner_rows.shape != (num_hubs,)
                or owner_ptr.shape != (num_hubs + 1,) or tickets.shape != (num_hubs,)):
            raise ValueError("hubs must be owner_rows [H], owner_ptr [H + 1] and tickets [H] "
                             "of a side with virtual rows")
    num_features = h.shape[1]
    out = torch.empty((num_rows, num_features), dtype=h.dtype, device=h.device)
    partial = torch.empty((num_virtual, num_features), dtype=torch.float32,
                          device=h.device)
    if total_rows == 0 or num_features == 0:
        return out, partial
    fn = _build.kernel_function(
        "csr_spmm.cu", "tfg_csr_spmm",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    hub_ptrs = (None, None, None, 0) if hubs is None else (
        *(t.data_ptr() for t in hubs), hubs[0].shape[0])
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = fn(row_ptr.data_ptr(), col.data_ptr(), val.data_ptr(), h.data_ptr(),
                _DTYPE_CODES[h.dtype], None if diag is None else diag.data_ptr(),
                out.data_ptr(), partial.data_ptr() if num_virtual else None,
                *hub_ptrs, num_rows, num_virtual, num_features,
                _vec_elements(num_features, [h], [out, partial]), stream)
    if rc != 0:
        raise RuntimeError(f"csr_spmm kernel launch failed: cudaError {rc}")
    count("launches.csr_spmm")
    if hubs is not None:
        count("hubs.merged", num_hubs)
    return out, partial


def side_matmul(side: CsrSide, h, diag):
    """``A_side · h`` (+ ``diag·h``): one launch of Kernel A, hub merge
    included, on a CUDA ``h``; the plain version on a CPU ``h``."""
    if h.is_cuda:
        hubs = (side.owner_rows, side.owner_ptr, side.tickets) if side.num_virtual else None
        return launch_csr_spmm(side.row_ptr, side.col, side.val, h.contiguous(), diag,
                               side.num_rows, hubs)[0]
    if h.device.type != "cpu":
        raise NotImplementedError(f"no CSR SpMM for device {h.device}")
    return side_matmul_plain(side, h, diag)


def side_matmul_plain(side: CsrSide, h, diag):
    """``side_matmul`` in plain PyTorch, on any device, in the kernel's
    order: every row's float32 sum (``diag·h`` after its edges), a hub row's
    partials summed in order and added to its ``diag·h``, then one cast to
    ``h``'s dtype (in bfloat16 a hub row rounds once)."""
    out, partial = _csr_spmm_plain_f32(side.row_ptr, side.col, side.val, h, diag,
                                       side.num_rows)
    if side.num_virtual:
        sorted_segment_sum_plain(partial, side.owner_ptr, out, side.owner_rows)
    return out.to(h.dtype)


class _CsrSpmm(torch.autograd.Function):
    """``A·h`` forward on the fwd side, ``dh = Aᵀ·dy`` backward on the bwd
    side with the same diagonal. Edge values are constants: no value grad."""

    @staticmethod
    @span("tfg.ops.csr_spmm.forward")
    def forward(ctx, h, adj, side_fn):
        ctx.adj, ctx.side_fn = adj, side_fn
        return side_fn(adj.fwd, h, adj.diag_val)

    @staticmethod
    @span("tfg.ops.csr_spmm.backward")
    def backward(ctx, dy):
        return ctx.side_fn(ctx.adj.bwd, dy.contiguous(), ctx.adj.diag_val), None, None


def csr_spmm(adj: "CsrAdj", h, compute_dtype=None):
    """``A @ h`` for a ``CsrAdj``. Values are constants for autograd.

    ``h`` is cast to ``compute_dtype`` (default ``ops.config.ell_compute_dtype``)
    for the product and the result is cast back, as ``bucketed_spmm`` does;
    so in bfloat16 mode the backward's ``dy`` is bfloat16 as well. Inside
    ``ops.config.use_plain_versions()`` both directions run
    ``side_matmul_plain`` on any device (the on-card reference).
    """
    from . import config as _config
    if h.dim() != 2 or h.shape[0] != adj.shape[1]:
        raise ValueError(f"h must be [{adj.shape[1]}, F], got {tuple(h.shape)}")
    cd = compute_dtype if compute_dtype is not None else _config.ell_compute_dtype
    orig_dtype = h.dtype
    if cd is not None and orig_dtype != cd:
        h = h.to(cd)
    side_fn = side_matmul_plain if _config.plain_versions else side_matmul
    out = _CsrSpmm.apply(h, adj, side_fn)
    if cd is not None and orig_dtype != cd:
        out = out.to(orig_dtype)
    return out


class CsrAdj:
    """Dual-direction CSR adjacency for the SpMM and its transpose.

    Duck-types the JAX ``BucketedEllAdj`` surface: ``matmul`` / ``@`` /
    ``with_edge_values`` / ``dropout`` / ``shape`` / ``num_edges``.
    ``edge_values`` is None, or the [num_edges] tensor that
    ``ops.ell.with_edge_values`` re-skinned the layout with, for the value
    gradient of ``ops.ell.ell_spmm(..., diff_values=True)``.
    """

    __slots__ = ("fwd", "bwd", "diag_val", "diag_eid", "_shape", "_num_edges", "edge_values")

    def __init__(self, fwd: CsrSide, bwd: CsrSide, diag_val, diag_eid, shape,
                 num_edges: int, edge_values=None):
        self.fwd = fwd
        self.bwd = bwd
        self.diag_val = diag_val
        self.diag_eid = diag_eid
        self._shape = (int(shape[0]), int(shape[1]))
        self._num_edges = int(num_edges)
        self.edge_values = edge_values

    @property
    def shape(self):
        return self._shape

    @property
    def num_edges(self):
        return self._num_edges

    @classmethod
    @span("tfg.setup.csr_layout")
    def from_coo(cls, index, value, shape, split_diag: bool = False,
                 split_width: int = SPLIT_WIDTH, device="cuda") -> "CsrAdj":
        """Host-side build from COO ``index`` [2, E] (row = destination) and
        ``value`` [E] (ones if None). Out-of-range entries are dropped.
        ``split_diag`` moves the first diagonal entry of each row into a
        dense ``diag_val``. Rows with more than ``split_width`` edges are
        split into virtual rows."""
        if split_width < 1:
            raise ValueError(f"split_width must be >= 1, got {split_width}")
        index = convert_union_to_numpy(index, np.int64)
        value = convert_union_to_numpy(value, np.float32)
        if index.ndim != 2 or index.shape[0] != 2:
            raise ValueError(f"index must be [2, nnz], got shape {index.shape}")
        num_edges = index.shape[1]
        if value is None:
            value = np.ones(num_edges, np.float32)
        if value.shape != (num_edges,):
            raise ValueError(f"value must be [{num_edges}], got {value.shape}")
        if num_edges >= 2 ** 31 - 1:
            raise ValueError("the CSR kernels index edges with int32")
        num_rows, num_cols = int(shape[0]), int(shape[1])
        ok = ((index[0] >= 0) & (index[0] < num_rows)
              & (index[1] >= 0) & (index[1] < num_cols))
        diag_val = diag_eid = None
        if split_diag:
            if num_rows != num_cols:
                raise ValueError("split_diag requires a square matrix")
            d_idx = np.nonzero(ok & (index[0] == index[1]))[0]
            if len(d_idx):
                uniq_rows, first_pos = np.unique(index[0][d_idx], return_index=True)
                chosen = d_idx[first_pos]
                dv = np.zeros(num_rows, np.float32)
                de = np.full(num_rows, num_edges, np.int64)
                dv[uniq_rows] = value[chosen]
                de[uniq_rows] = chosen
                diag_val = torch.as_tensor(dv, device=device)
                diag_eid = torch.as_tensor(de, device=device)
                ok = ok.copy()
                ok[chosen] = False
        rows, cols, vals = index[0][ok], index[1][ok], value[ok]
        eids = np.nonzero(ok)[0].astype(np.int64)
        fwd = _build_side(rows, cols, vals, eids, num_rows, split_width, device)
        bwd = _build_side(cols, rows, vals, eids, num_cols, split_width, device)
        return cls(fwd, bwd, diag_val, diag_eid, (num_rows, num_cols), num_edges)

    def with_edge_values(self, edge_values) -> "CsrAdj":
        """Re-skin per-edge values (both directions and the diagonal) through
        the edge-id maps; the sentinel id ``num_edges`` reads 0. The sides
        share their layout, tickets included, with this adjacency's (its
        launches and theirs run on one stream)."""
        edge_values = torch.as_tensor(edge_values, device=self.fwd.val.device)
        if edge_values.shape != (self._num_edges,):
            raise ValueError(f"edge_values must be [{self._num_edges}], "
                             f"got {tuple(edge_values.shape)}")
        padded = torch.cat([edge_values.detach().float(),
                            edge_values.new_zeros(1, dtype=torch.float32)])

        def reskin(side: CsrSide) -> CsrSide:
            return side._replace(val=padded[side.eid])

        diag_val = None if self.diag_val is None else padded[self.diag_eid]
        return CsrAdj(reskin(self.fwd), reskin(self.bwd), diag_val, self.diag_eid,
                      self._shape, self._num_edges)

    def to(self, device) -> "CsrAdj":
        """The same adjacency with its tensors on ``device``."""
        def move(side: CsrSide) -> CsrSide:
            return side._replace(**{f: None if getattr(side, f) is None
                                    else getattr(side, f).to(device)
                                    for f in ("row_ptr", "col", "val", "eid", "owner_rows",
                                              "owner_ptr", "tickets")})
        def opt(t):
            return None if t is None else t.to(device)
        return CsrAdj(move(self.fwd), move(self.bwd), opt(self.diag_val), opt(self.diag_eid),
                      self._shape, self._num_edges, opt(self.edge_values))

    def matmul(self, h, num_or_size_splits=None):
        from ..sparse.matrix import chunked_feature_matmul
        return chunked_feature_matmul(lambda c: csr_spmm(self, c), h,
                                      num_or_size_splits)

    def __matmul__(self, h):
        return csr_spmm(self, h)

    def dropout(self, rate: float, generator=None, training: bool = True):
        if not training or rate <= 0.0 or generator is None:
            return self
        raise NotImplementedError(
            "edge dropout on CsrAdj: use with_edge_values "
            "(nn/conv/gcn.py does this) or the COO SparseMatrix path")

    def __repr__(self):
        return (f"CsrAdj(shape={self._shape}, nnz={self.fwd.col.shape[0]}, "
                f"diag={self.diag_val is not None}, "
                f"virtual=({self.fwd.num_virtual}, {self.bwd.num_virtual}))")
