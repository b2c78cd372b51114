"""Block-sparse SpMM over occupied [t, t] tiles: the packing, the plain
pass, the kernel wrapper (``csrc/tiled_spmm.cu``) and the autograd function.

Counterpart of ``tf_geometric_tpu/ops/tiled_spmm.py`` (X7, the "one-hot
MXU" formulation). The packing finds the occupied (row tile, column tile)
pairs of A, sorts them by row tile and keeps one dense [t, t] block of A
per pair, in float32 or bfloat16, and the same for Aᵀ. A pass computes
``A·h`` over the blocks with float32 accumulation; ``dh = Aᵀ·dy`` is the
same pass over the transpose packing, and the blocks are constants.

Nothing in the JAX package dispatches X7: it exists to be measured against
the CSR path (``benchmarks/tiled_spmm_ab.py``; the port's twin is
``python -m tf_geometric_tpu_torch.bench --tiled-ab``). Nothing in the port
dispatches it either.

Per pass (B occupied tiles, tile t, width F) the least traffic is the tiles
(B·t² elements), the operand rows and the output: bytes bound it on the
H100 (see ``csrc/tiled_spmm.cu``).

``tiled_pass`` dispatches on the device of ``h`` (``_launch.use_kernel``):
a CPU tensor takes the plain version, a CUDA tensor launches the kernel,
and a failed launch raises; ``tiled_spmm`` reads
``ops.config.use_plain_versions()`` once a call, and both its passes then
run the plain version on any device inside it.

bf16 tiles run on the tensor cores: the wrapper casts ``h`` to bf16 once
per call (padded to whole tiles of rows and a multiple of 8 columns), and
the kernel feeds ``wgmma`` from a TMA ring; ``mma_plan`` is its host-side
plan (F chunks, stages, shared memory), a pure function of ``t`` and F.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import span
from ..utils.union_utils import convert_union_to_numpy
from . import _build
from . import config as _config
from ._launch import DTYPE_CODES, launch, query, require_cuda, use_kernel

__all__ = ["TiledSpmm", "build_tiled_spmm", "tiled_spmm", "tiled_pass", "tiled_spmm_plain",
           "launch_tiled_spmm", "count_occupied_tiles", "tiled_pass_bytes", "MAX_TILE",
           "MmaPlan", "mma_plan", "cast_operand", "launch_order", "kernel_info"]

_P, _I = ctypes.c_void_p, ctypes.c_int
MAX_TILE = 256  # the kernel's largest tile; t must also be a multiple of 16

# the bf16-tile kernel (csrc/tiled_spmm.cu): 64-row wgmma slices, 64-column
# atoms, 64-deep stages of one 8 KiB box per slice and per atom, at most two
# consumer warpgroups and 128 float32 accumulators a thread
SLICE = _build.header_constant("tiled_spmm.cu", "kSlice")
ATOM = _build.header_constant("tiled_spmm.cu", "kAtomN")
MAX_STAGES = _build.header_constant("tiled_spmm.cu", "kMaxStages")
BOX_BYTES, MAX_ACC = SLICE * ATOM * 2, 128
SMEM_PER_BLOCK = 232_448   # an H100 block's shared memory (opt-in)
SMEM_PER_SM = 233_472      # an SM's, 1 KiB of it reserved per resident block


class MmaPlan(NamedTuple):
    """How the bf16-tile kernel covers a pass at tile ``t`` and width F.

    ``wgs`` consumer warpgroups own the tile's ``slices`` 64-row slices,
    ``slices_per_wg`` each; a block holds ``atoms`` 64-column atoms (its
    accumulators: ``slices_per_wg · atoms · 32`` floats a thread, at most
    128) and ``chunks`` blocks cover F; ``f_pad`` is F rounded up to 8 (the
    cast operand's 16-byte row stride). A stage holds one 8 KiB box per
    slice and per atom; ``stages`` of them fit the shared memory of
    ``blocks_per_sm`` blocks an SM, ``smem_bytes`` a block with the 1 KiB
    alignment slack and the barriers."""
    slices: int
    wgs: int
    slices_per_wg: int
    atoms: int
    chunks: int
    f_pad: int
    threads: int
    stage_bytes: int
    stages: int
    smem_bytes: int
    blocks_per_sm: int


def mma_plan(tile: int, width: int) -> MmaPlan:
    """The bf16-tile kernel's plan (see ``MmaPlan``); the kernel checks the
    same rule. Raises for a tile the kernel does not take."""
    if tile % 16 or not 0 < tile <= MAX_TILE or width < 1:
        raise ValueError(f"the tiled SpMM kernel takes tiles that are a multiple of 16 up to "
                         f"{MAX_TILE} and a width of at least 1, got t = {tile}, F = {width}")
    slices = -(-tile // SLICE)
    wgs = min(2, slices)
    per_wg = -(-slices // wgs)
    max_atoms = MAX_ACC // (32 * per_wg)
    need = -(-width // ATOM)
    chunks = -(-need // max_atoms)
    atoms = -(-need // chunks)
    stage = (slices + atoms) * BOX_BYTES

    def fit(budget):
        return min(MAX_STAGES, (budget - 1024) // (stage + 16))

    # two blocks an SM where their accumulators (the kernel's launch bound)
    # and three stages each fit, else one
    blocks = 2 if per_wg * atoms <= 2 and fit(SMEM_PER_SM // 2 - 1024) >= 3 else 1
    stages = fit(SMEM_PER_BLOCK if blocks == 1 else SMEM_PER_SM // 2 - 1024)
    return MmaPlan(slices, wgs, per_wg, atoms, chunks, -(-width // 8) * 8, wgs * 128 + 32,
                   stage, stages, 1024 + stages * (stage + 16), blocks)


def launch_order(row_ptr):
    """The row tiles by their number of tiles, most first (ties in id
    order), int32: the bf16-tile kernel's blocks take them in this order,
    so the shortest start last."""
    return torch.argsort(row_ptr[1:] - row_ptr[:-1], descending=True, stable=True).to(
        torch.int32)


def cast_operand(h, tile: int, dtype=torch.bfloat16):
    """``h`` [n, F] in ``dtype``, padded with zero rows to whole tiles and
    zero columns to a multiple of 8: the operand the bf16-tile kernel reads
    (the rounding ``cast()`` of the contract, done once per call)."""
    n, width = h.shape
    n_pad, f_pad = -(-n // tile) * tile, -(-width // 8) * 8
    hc = torch.empty((n_pad, f_pad), dtype=dtype, device=h.device)
    hc[:n, :width].copy_(h)
    if n_pad > n:
        hc[n:].zero_()
    if f_pad > width:
        hc[:n, width:].zero_()
    return hc


class TiledSpmm(NamedTuple):
    """Occupied-tile packing of a sparse matrix and of its transpose.

    ``row_ptr`` [num_row_tiles + 1] gives row tile r the tiles
    ``row_ptr[r]:row_ptr[r + 1]`` (``t_row_ptr`` [num_col_tiles + 1] the
    same for the transpose); computed once at pack time."""
    row_tile: torch.Tensor    # [B] int32, sorted: destination tile ids
    col_tile: torch.Tensor    # [B] int32: source tile ids
    a_tiles: torch.Tensor     # [B, t, t]: dense blocks of A
    row_ptr: torch.Tensor     # [num_row_tiles + 1] int32
    t_row_tile: torch.Tensor  # [Bt] int32, sorted: the transpose packing
    t_col_tile: torch.Tensor  # [Bt] int32
    t_a_tiles: torch.Tensor   # [Bt, t, t]: dense blocks of Aᵀ
    t_row_ptr: torch.Tensor   # [num_col_tiles + 1] int32
    num_row_tiles: int
    num_col_tiles: int
    tile: int
    shape: tuple
    num_edges: int

    @property
    def occupancy(self) -> float:
        """Real edges / packed tile slots (1.0 = perfectly dense tiles)."""
        return self.num_edges / max(int(self.a_tiles.shape[0]) * self.tile * self.tile, 1)

    def bytes_per_pass(self, feature_width: int) -> int:
        """The JAX module's count: the tiles and one gathered float32
        operand tile per occupied tile."""
        t, b = self.tile, int(self.a_tiles.shape[0])
        return b * t * t * self.a_tiles.element_size() + b * t * feature_width * 4


def _pair_keys(r, c, tile: int, n_r_tiles: int, n_c_tiles: int):
    """The JAX packing's pair key ``rt·(n_r_tiles + Vc + 1) + ct`` and its base."""
    base = np.int64(n_r_tiles + n_c_tiles + 1)
    return (r // tile) * base + c // tile, base


def count_occupied_tiles(index, shape, tile: int) -> int:
    """Occupied (row tile, column tile) pairs of A, out-of-range edges
    dropped, without building any tile."""
    index = convert_union_to_numpy(index, np.int64)
    num_rows, num_cols = int(shape[0]), int(shape[1])
    ok = ((index[0] >= 0) & (index[0] < num_rows) & (index[1] >= 0) & (index[1] < num_cols))
    keys, _ = _pair_keys(index[0][ok], index[1][ok], tile, -(-num_rows // tile),
                         -(-num_cols // tile))
    return int(np.unique(keys).shape[0])


def build_tiled_spmm(index, value, shape, tile: int = 256, dtype=torch.float32,
                     device="cuda", max_bytes: Optional[int] = None) -> TiledSpmm:
    """Pack ``A`` (COO ``index`` [2, E], ``value`` [E] or None for ones,
    ``shape``) into occupied [t, t] tiles, both directions, as the JAX
    ``build_tiled_spmm`` does: edges out of range are dropped, tiles are
    ordered by the JAX pair key and a stable sort by row tile, duplicates
    are summed in float32 and the sum is cast to ``dtype`` once.

    The keys and orders are numpy; the tiles are summed straight into a
    float32 ``[B, t, t]`` tensor on ``device``, so the host never holds
    them. With ``max_bytes``, the occupied tiles are counted first and a
    packing whose tiles (both directions, in ``dtype``) would exceed it
    raises before anything is allocated."""
    index = convert_union_to_numpy(index, np.int64)
    value = convert_union_to_numpy(value, np.float32)
    if value is None:
        value = np.ones(index.shape[1], np.float32)
    num_rows, num_cols = int(shape[0]), int(shape[1])
    ok = ((index[0] >= 0) & (index[0] < num_rows)
          & (index[1] >= 0) & (index[1] < num_cols))
    rows, cols, vals = index[0][ok], index[1][ok], value[ok]
    n_r_tiles = -(-num_rows // tile)
    n_c_tiles = -(-num_cols // tile)

    def keys(r, c, n_out_tiles):
        pair, base = _pair_keys(r, c, tile, n_out_tiles, n_c_tiles)
        uniq, inv = np.unique(pair, return_inverse=True)
        return uniq, inv.reshape(-1), base

    fwd_keys = keys(rows, cols, n_r_tiles)
    bwd_keys = keys(cols, rows, n_c_tiles)
    if max_bytes is not None:
        need = ((fwd_keys[0].shape[0] + bwd_keys[0].shape[0]) * tile * tile
                * torch.empty((), dtype=dtype).element_size())
        if need > max_bytes:
            raise MemoryError(f"the tiles of both directions need {need} bytes, more than "
                              f"max_bytes={max_bytes}")

    def pack(r, c, packed, n_out_tiles):
        uniq, inv, base = packed
        order = np.argsort(uniq // base, kind="stable")
        slot = np.empty_like(order)
        slot[order] = np.arange(order.shape[0])  # a pair's place after the sort
        uniq = uniq[order]
        a = torch.zeros((uniq.shape[0], tile, tile), dtype=torch.float32, device=device)
        flat = (slot[inv] * tile + r % tile) * tile + c % tile
        a.view(-1).index_put_((torch.as_tensor(flat, device=device),),
                              torch.as_tensor(vals, device=device), accumulate=True)
        if dtype != torch.float32:
            a = a.to(dtype)
        row_tile = (uniq // base).astype(np.int32)
        row_ptr = np.searchsorted(row_tile, np.arange(n_out_tiles + 1), side="left")
        return (torch.as_tensor(row_tile, device=device),
                torch.as_tensor((uniq % base).astype(np.int32), device=device), a,
                torch.as_tensor(row_ptr.astype(np.int32), device=device))

    row_tile, col_tile, a, row_ptr = pack(rows, cols, fwd_keys, n_r_tiles)
    t_row_tile, t_col_tile, t_a, t_row_ptr = pack(cols, rows, bwd_keys, n_c_tiles)
    return TiledSpmm(row_tile, col_tile, a, row_ptr, t_row_tile, t_col_tile, t_a, t_row_ptr,
                     n_r_tiles, n_c_tiles, tile, (num_rows, num_cols), int(rows.shape[0]))


def tiled_spmm_plain(row_tile, col_tile, a_tiles, h, num_out_tiles: int, num_out_rows: int,
                     tile: int):
    """Plain PyTorch version of one pass, the JAX ``_tiled_pass``: ``h``
    padded to whole tiles and viewed [n_tiles, t, F], the operand tiles
    gathered by ``col_tile`` and cast to the tiles' dtype, ``torch.bmm`` in
    float32, ``index_add_`` of the partials into the output tiles by
    ``row_tile``, cut to ``num_out_rows`` rows in ``h``'s dtype."""
    n, width = h.shape
    n_pad = -(-n // tile) * tile
    hc = F.pad(h, (0, 0, 0, n_pad - n)).view(-1, tile, width)
    hb = hc.index_select(0, col_tile.long()).to(a_tiles.dtype)
    partial = torch.bmm(a_tiles.float(), hb.float())
    out = torch.zeros((num_out_tiles, tile * width), dtype=torch.float32, device=h.device)
    out.index_add_(0, row_tile.long(), partial.reshape(partial.shape[0], tile * width))
    return out.reshape(num_out_tiles * tile, width)[:num_out_rows].to(h.dtype)


def launch_tiled_spmm(row_ptr, col_tile, a_tiles, h, num_out_rows: int):
    """Launch the kernel for one pass. ``row_ptr`` int32 [num_out_tiles + 1],
    ``col_tile`` int32 [B], ``a_tiles`` [B, t, t] float32 or bfloat16 with t a
    multiple of 16 up to ``MAX_TILE``, ``h`` [n_src, F] float32 or bfloat16;
    all contiguous CUDA tensors on one device. Allocates and returns ``out``
    [num_out_rows, F] in ``h``'s dtype; with bf16 tiles, ``h`` is first cast
    (``cast_operand``). Counts each launch (``launches.tiled_spmm``). Refuses, before
    anything runs: a non-contiguous tensor, a tile that is not a multiple of
    16 up to ``MAX_TILE``, wrong dtypes or shapes, then CPU tensors."""
    tensors = (("row_ptr", row_ptr), ("col_tile", col_tile), ("a_tiles", a_tiles), ("h", h))
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if row_ptr.dtype != torch.int32 or col_tile.dtype != torch.int32:
        raise TypeError("row_ptr and col_tile must be int32")
    if a_tiles.dtype not in DTYPE_CODES or h.dtype not in DTYPE_CODES:
        raise TypeError(f"a_tiles and h must be float32 or bfloat16, got {a_tiles.dtype} "
                        f"and {h.dtype}")
    if a_tiles.dim() != 3 or a_tiles.shape[1] != a_tiles.shape[2]:
        raise ValueError(f"a_tiles must be [B, t, t], got {tuple(a_tiles.shape)}")
    tile = int(a_tiles.shape[1])
    if tile % 16 or not 0 < tile <= MAX_TILE:
        raise ValueError(f"the tiled SpMM kernel takes tiles that are a multiple of 16 up to "
                         f"{MAX_TILE}, got t = {tile}")
    if col_tile.shape != (a_tiles.shape[0],) or row_ptr.dim() != 1:
        raise ValueError("col_tile must be [B] and row_ptr 1-D")
    if h.dim() != 2:
        raise ValueError(f"h must be [n_src, F], got shape {tuple(h.shape)}")
    num_out_tiles = row_ptr.shape[0] - 1
    if num_out_rows > num_out_tiles * tile or num_out_rows < 0:
        raise ValueError(f"{num_out_rows} output rows do not fit {num_out_tiles} tiles of {tile}")
    require_cuda(tensors, h.device)
    if a_tiles.data_ptr() % 16:
        raise ValueError("a_tiles must be 16-byte aligned")
    out = torch.empty((num_out_rows, h.shape[1]), dtype=h.dtype, device=h.device)
    if num_out_rows == 0 or h.shape[1] == 0:
        return out
    n_src, width = h.shape
    if a_tiles.dtype == torch.bfloat16:
        plan = mma_plan(tile, width)
        hc = cast_operand(h, tile)
        order = launch_order(row_ptr)
        launch("tiled_spmm.cu", "tfg_tiled_spmm_tma",
               [_P, _P, _P, _P, _I, _P, _I, _I, _P] + [_I] * 10,
               (order.data_ptr(), row_ptr.data_ptr(), col_tile.data_ptr(), a_tiles.data_ptr(),
                a_tiles.shape[0], hc.data_ptr(), hc.shape[0] // tile, plan.f_pad, out.data_ptr(),
                DTYPE_CODES[h.dtype], num_out_tiles, tile, num_out_rows, width, plan.slices_per_wg,
                plan.atoms, plan.chunks, plan.wgs, plan.stages), h.device, "tiled_spmm")
    else:
        launch("tiled_spmm.cu", "tfg_tiled_spmm_fma", [_P, _P, _P, _P, _I, _P] + [_I] * 5,
               (row_ptr.data_ptr(), col_tile.data_ptr(), a_tiles.data_ptr(), h.data_ptr(),
                DTYPE_CODES[h.dtype], out.data_ptr(), num_out_tiles, tile, n_src, num_out_rows,
                width), h.device, "tiled_spmm")
    return out


def kernel_info(tile: int, width: int, a_dtype, h_dtype) -> dict:
    """The kernel a pass at ``(tile, width)`` launches: its plan and, for
    bf16 tiles, its registers, static shared memory and resident blocks per
    SM on the current card (``cudaFuncGetAttributes``, the occupancy API)."""
    if a_dtype != torch.bfloat16:
        return {"kernel": "tiled_spmm_fma_kernel", "threads": 256}
    plan = mma_plan(tile, width)
    regs, static, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    query("tiled_spmm.cu", "tfg_tiled_spmm_tma_info", [_I] * 6 + [_P] * 3,
          (DTYPE_CODES[h_dtype], plan.slices_per_wg, plan.atoms, tile, plan.wgs, plan.stages,
           ctypes.byref(regs), ctypes.byref(static), ctypes.byref(blocks)))
    return {"kernel": "tiled_spmm_tma_kernel", "threads": plan.threads, "registers": regs.value,
            "static_smem": static.value, "dynamic_smem": plan.smem_bytes,
            "stages": plan.stages, "atoms": plan.atoms, "chunks": plan.chunks,
            "blocks_per_sm": blocks.value}


def tiled_pass(ts: TiledSpmm, h, transpose: bool = False, plain: bool = False):
    """``A·h`` (or ``Aᵀ·h`` with ``transpose``) over the packing: the
    kernel on a CUDA ``h``, the plain version on a CPU ``h`` or under
    ``plain``."""
    if transpose:
        rt, ct, a, ptr, n_tiles, n_rows = (ts.t_row_tile, ts.t_col_tile, ts.t_a_tiles,
                                           ts.t_row_ptr, ts.num_col_tiles, ts.shape[1])
    else:
        rt, ct, a, ptr, n_tiles, n_rows = (ts.row_tile, ts.col_tile, ts.a_tiles, ts.row_ptr,
                                           ts.num_row_tiles, ts.shape[0])
    if use_kernel(h, plain, "tiled SpMM"):
        return launch_tiled_spmm(ptr, ct, a, h.contiguous(), n_rows)
    return tiled_spmm_plain(rt, ct, a, h, n_tiles, n_rows, ts.tile)


class _TiledSpmm(torch.autograd.Function):
    """Forward on the packing, ``dh`` on the transpose packing; the tiles
    are constants and get no gradient."""

    @staticmethod
    @span("tfg.ops.tiled_spmm.forward")
    def forward(ctx, h, ts, plain):
        ctx.ts, ctx.plain = ts, plain
        return tiled_pass(ts, h, plain=plain)

    @staticmethod
    @span("tfg.ops.tiled_spmm.backward")
    def backward(ctx, dy):
        return tiled_pass(ctx.ts, dy, transpose=True, plain=ctx.plain), None, None


def tiled_spmm(ts: TiledSpmm, h):
    """``A @ h`` on the occupied-tile packing (values constant, as the
    cached normalized adjacency); the backward gives ``dh`` alone, by the
    transpose packing. ``h`` is [num_cols, F]; the result takes its dtype."""
    if ts.a_tiles.requires_grad or ts.t_a_tiles.requires_grad:
        raise ValueError("the tiles are constants: tiled_spmm gives no gradient to a_tiles")
    if h.dim() != 2 or h.shape[0] != ts.shape[1]:
        raise ValueError(f"h must be [{ts.shape[1]}, F], got {tuple(h.shape)}")
    return _TiledSpmm.apply(h, ts, _config.plain_versions)


def tiled_pass_bytes(ts: TiledSpmm, width: int, h_bytes: int, transpose: bool = False) -> int:
    """Least bytes of one pass: the tiles, the operand rows inside the
    occupied column tiles read once, the output written once, the row
    pointers and tile ids."""
    if transpose:
        ct, ptr, n_src, n_out = ts.t_col_tile, ts.t_row_ptr, ts.shape[0], ts.shape[1]
        b = int(ts.t_a_tiles.shape[0])
    else:
        ct, ptr, n_src, n_out = ts.col_tile, ts.row_ptr, ts.shape[1], ts.shape[0]
        b = int(ts.a_tiles.shape[0])
    t = ts.tile
    src_tiles = torch.unique(ct.long())
    src_rows = int(torch.clamp(n_src - src_tiles * t, 0, t).sum())
    return (b * t * t * ts.a_tiles.element_size() + (src_rows + n_out) * width * h_bytes
            + 4 * (ptr.shape[0] + b))
