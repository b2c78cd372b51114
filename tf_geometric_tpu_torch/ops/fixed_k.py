"""Fixed-k neighbour sampling and aggregation: the draw and the fixed-k
aggregation, their plain versions, their kernel wrappers and the autograd
function (kernels in ``csrc/fixed_k.cu``).

Counterparts in the JAX package:
- the draw: ``draw_fixed_k`` (``tf_geometric_tpu/nn/sampling/device_sampler.py``)
  after its ``jax.random.randint``: per row ``s`` and slot ``j``,
  ``pick = row_start[s] + r[j, s] % max(deg[s], 1)`` clipped to the column
  table, ``idx = sorted_col[pick]`` and ``w = sorted_weight[pick]`` (or 1),
  and for a row without edges ``idx = self_ids[s]`` and ``w = 0``;
- the aggregation: the slot loop of ``_fixed_k_reduce``
  (``tf_geometric_tpu/nn/conv/graph_sage.py``), ``out[s] = Σ_j w[j, s] ·
  src[clip(idx[j, s])]`` over a slot-major ``[k, S]`` draw, whose gradient
  is ``d_src[clip(idx[j, s])] += w[j, s] · dy[s]``.

The draw's random integers come from ``torch.randint`` (the caller's
``torch.Generator``), the counterpart of ``jax.random.randint``; the kernel
takes them as input, so a kernel and its plain version given the same
integers agree exactly. The JAX function's weights can be differentiated;
here they are the sampler's constants: the autograd function returns no
gradient for ``idx`` and ``w``, and ``fixed_k_aggregate`` raises when ``w``
requires grad rather than drop that gradient.

Each op has a plain PyTorch version with the same contract. A CPU tensor
takes the plain version, a CUDA tensor launches the kernel, and a failed
launch raises; inside ``ops.config.use_plain_versions()`` the plain
versions run on any device (the on-card reference of ``chip_smoke.py``).

The backward gathers too (no float atomics): on the card it buckets the
draw's slots by source tile (source ``c`` in tile ``c % tiles``) in one
stable radix pass, then sorts each tile's run by source in shared memory,
stably, and gathers ``w · dy`` rows into each source row as the forward
gathers source rows into each destination. A source with more than
``SPLIT`` slots is cut into ``SPLIT``-slot segments whose partials are
added in order. ``backward_plan`` sizes the tiles and the shared memory.

Every order is fixed, so both directions are bitwise reproducible. The
forward sums each row's slots in slot order, as ``fixed_k_forward_plain``
does; ``fixed_k_backward_order_plain`` emulates the backward's order.

Bound on the H100: bytes (``draw_pass_bytes``, ``aggregate_pass_bytes``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..utils.profiling import count, span
from . import _build
from . import config as _config

__all__ = ["draw_fixed_k_plain", "launch_draw_fixed_k", "draw_fixed_k_from_ints",
           "row_divisor", "reciprocal_remainder",
           "fixed_k_aggregate", "fixed_k_forward_plain", "fixed_k_backward_plain",
           "fixed_k_backward_order_plain",
           "launch_fixed_k_forward", "launch_fixed_k_backward", "draw_pass_bytes",
           "fixed_k_backward_launches", "aggregate_pass_bytes", "aggregate_pass_flops",
           "BackwardPlan", "backward_plan", "serial_walks",
           "SPLIT"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int

# the backward (csrc/fixed_k.cu): slots one lane group sums before a hub's
# partials are added, tiles of at most 512 sources, radix digits of at most
# 10 bits; the tile kernel's block: 1024 threads (32 warps) holding up to 8
# slots each (8,192 a chunk), one block an SM of the H100's 132 (a wave)
SPLIT = 64
MAX_TILE, MAX_DIGIT_BITS = 512, 10
TILE_THREADS, TILE_WARPS, TILE_CAP = 1024, 32, 8192
TILE_SMEM_BYTES = 231_424     # of the 232,448 an H100 block may use
H100_SMS = 132
PART_FLOATS = 4096            # shared floats for a round of hub partials


# ---------------------------------------------------------------------------
# the draw
# ---------------------------------------------------------------------------

def draw_fixed_k_plain(r, row_start, degree, sorted_col, sorted_weight=None, self_ids=None):
    """Plain version of the draw kernel: ``(idx int32 [k, S], weight
    float32 [k, S])`` from the random integers ``r`` int32 [k, S] (``r ≥
    0``; a remainder keeps the divisor's sign, as ``jnp``'s ``%`` does) and
    the CSR arrays: ``row_start``, ``degree`` int32 [S], ``sorted_col``
    int32 [nnz], ``sorted_weight`` float32 [nnz] or None, ``self_ids`` int32
    [S] or None (``arange(S)``)."""
    k, n = r.shape
    nnz = sorted_col.shape[0]
    isolated = degree == 0
    pick = (row_start.long()[None, :]
            + torch.remainder(r.long(), degree.long().clamp_min(1)[None, :]))
    pick = pick.clamp(0, max(nnz - 1, 0))
    if self_ids is None:
        self_ids = torch.arange(n, dtype=torch.int32, device=r.device)
    gathered = (sorted_col[pick] if nnz
                else torch.zeros((k, n), dtype=torch.int32, device=r.device))
    idx = torch.where(isolated[None, :], self_ids.int()[None, :], gathered)
    if sorted_weight is None:
        weight = (~isolated).float()[None, :].expand(k, n).contiguous()
    else:
        weight = torch.where(isolated[None, :], torch.zeros((), device=r.device),
                             sorted_weight[pick] if nnz else torch.zeros((k, n), device=r.device))
    return idx.int(), weight.float()


def row_divisor(degree):
    """The draw kernel's per-row reciprocal of ``degree`` (int, 1 ≤ d <
    2³¹, numpy arrays elementwise): ``(m, shift)`` with ``l = ceil(log2
    d)``, ``m = ceil(2^(31 + l) / d)`` (below 2³²) and ``shift = 31 + l``
    (``csrc/fixed_k.cu`` ``row_divisor``)."""
    d = np.asarray(degree, dtype=np.uint64)
    lg = np.array([int(x - 1).bit_length() for x in d.reshape(-1)],
                  dtype=np.uint64).reshape(d.shape)
    return ((np.uint64(1) << (np.uint64(31) + lg)) + d - np.uint64(1)) // d, np.uint64(31) + lg


def reciprocal_remainder(r, degree):
    """``r mod degree`` with the divisor's sign (``torch.remainder``) for
    int32 ``r`` and ``1 ≤ degree < 2³¹``, by the draw kernel's arithmetic:
    ``u = r`` or ``~r = -r - 1`` for a negative ``r``, ``q = (u·m) >>
    shift``, ``ρ = u - q·d``, and ``d - 1 - ρ`` for a negative ``r``. Its
    numpy mirror, held against ``torch.remainder`` by the tests."""
    r = np.asarray(r, dtype=np.int32)
    d = np.broadcast_to(np.asarray(degree, dtype=np.int64), r.shape)
    m, shift = row_divisor(d)
    u = (r ^ (r >> 31)).astype(np.uint64)          # below 2^31
    q = (u * m) >> shift                           # u·m < 2^63: no overflow
    rho = (u - q * d.astype(np.uint64)).astype(np.int64)
    return np.where(r < 0, d - 1 - rho, rho).astype(np.int32)


def _check_cuda(tensors, device):
    for name, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launch_draw_fixed_k(r, row_start, degree, sorted_col, sorted_weight=None, self_ids=None):
    """Launch the draw kernel; returns ``(idx, weight)`` as
    ``draw_fixed_k_plain`` does. Counts each launch (``launches.fixed_k_draw``)."""
    tensors = [("r", r), ("row_start", row_start), ("degree", degree),
               ("sorted_col", sorted_col)]
    if sorted_weight is not None:
        tensors.append(("sorted_weight", sorted_weight))
    if self_ids is not None:
        tensors.append(("self_ids", self_ids))
    _check_cuda(tensors, r.device)
    for name, t in tensors:
        want = torch.float32 if name == "sorted_weight" else torch.int32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if r.dim() != 2:
        raise ValueError(f"r must be [k, S], got shape {tuple(r.shape)}")
    k, n = r.shape
    for name, t in tensors[1:]:
        length = sorted_col.shape[0] if name == "sorted_weight" else n
        if t.dim() != 1 or (name != "sorted_col" and t.shape[0] != length):
            raise ValueError(f"{name} must be 1-D of length {length}, got {tuple(t.shape)}")
    idx = torch.empty((k, n), dtype=torch.int32, device=r.device)
    weight = torch.empty((k, n), dtype=torch.float32, device=r.device)
    if k == 0 or n == 0:
        return idx, weight
    fn = _build.kernel_function("fixed_k.cu", "tfg_fixed_k_draw", [_P] * 8 + [_I] * 3 + [_P])
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = fn(r.data_ptr(), row_start.data_ptr(), degree.data_ptr(), sorted_col.data_ptr(),
                None if sorted_weight is None else sorted_weight.data_ptr(),
                None if self_ids is None else self_ids.data_ptr(),
                idx.data_ptr(), weight.data_ptr(), k, n, sorted_col.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"fixed_k draw kernel launch failed: cudaError {rc}")
    count("launches.fixed_k_draw")
    return idx, weight




def draw_fixed_k_from_ints(r, csr, self_ids=None):
    """The draw from given random integers ``r`` [k, S] over a CSR dict
    (``row_start``, ``degree``, ``sorted_col``, optional ``sorted_weight``):
    the kernel on CUDA tensors, the plain version on CPU tensors or inside
    ``use_plain_versions()``."""
    args = (r, csr["row_start"], csr["degree"], csr["sorted_col"], csr.get("sorted_weight"),
            self_ids)
    if r.is_cuda and not _config.plain_versions:
        return launch_draw_fixed_k(*args)
    if not _config.plain_versions and r.device.type != "cpu":
        raise NotImplementedError(f"no fixed-k draw kernel for device {r.device}")
    return draw_fixed_k_plain(*args)


# ---------------------------------------------------------------------------
# the aggregation
# ---------------------------------------------------------------------------

def fixed_k_forward_plain(src, idx, w):
    """Plain version of the forward kernel: ``out [S, F]`` in ``src``'s
    dtype, ``out[s] = Σ_j w[j, s] · src[clip(idx[j, s], 0, n - 1)]``,
    summed in float32 slot by slot."""
    n = src.shape[0]
    acc = torch.zeros((idx.shape[1], src.shape[1]), dtype=torch.float32, device=src.device)
    for j in range(idx.shape[0]):
        acc += src[idx[j].long().clamp(0, n - 1)].float() * w[j][:, None]
    return acc.to(src.dtype)


def fixed_k_backward_plain(dy, idx, w, num_src: int):
    """Plain version of the backward kernel: ``d_src`` float32 [num_src, F],
    ``d_src[clip(idx[j, s])] += w[j, s] · dy[s]``."""
    d_src = torch.zeros((num_src, dy.shape[1]), dtype=torch.float32, device=dy.device)
    g = dy.float()
    for j in range(idx.shape[0]):
        d_src.index_add_(0, idx[j].long().clamp(0, num_src - 1), g * w[j][:, None])
    return d_src


def _lanes(nvec: int):
    """(lanes_log2, vectors per lane and pass) of a row of ``nvec`` lane
    vectors: csrc/common.cuh's ``pick_lanes_log2`` and ``pick_nv``."""
    ll = 0
    while ll < 5 and (1 << ll) < nvec:
        ll += 1
    lanes = 1 << ll
    return ll, 1 if nvec <= lanes else 2 if nvec <= 2 * lanes else 4


def _sum_in_segments(terms):
    """A hub's sum as the kernels take it: ``SPLIT``-slot segments, each
    from zero slot by slot, added in order; a shorter list slot by slot."""
    step = SPLIT if terms.shape[0] > SPLIT else terms.shape[0]
    total = None
    for s0 in range(0, terms.shape[0], max(step, 1)):
        part = torch.zeros_like(terms[0])
        for x in terms[s0:s0 + step]:
            part = part + x
        total = part if total is None else total + part
    return total


def fixed_k_backward_order_plain(dy, idx, w, num_src: int, plan):
    """Plain emulation of the backward kernel's order, float32: each
    source's slots in slot order, cut where its tile's run (the slots of
    sources ``c`` with one ``c % tiles``) is cut into chunks of ``plan.cap``
    slots. Within a chunk a source of more than ``SPLIT`` slots sums
    ``SPLIT``-slot segments from zero and adds them in order, a shorter one
    its slots one by one; the first chunk's sum is stored and later chunks'
    sums are added to it. ``plan``: ``backward_plan``'s for the shapes."""
    k, S = idx.shape
    ids = idx.long().clamp(0, num_src - 1).reshape(-1)
    rows = torch.arange(k * S, device=dy.device) % S
    wf = w.reshape(-1)
    g = dy.float()
    d_src = torch.zeros((num_src, dy.shape[1]), dtype=torch.float32, device=dy.device)
    num_tiles = -(-num_src // plan.tile)     # source c in tile c % num_tiles
    order = torch.sort(ids % num_tiles, stable=True).indices   # the tiles' runs
    starts = torch.searchsorted(ids[order] % num_tiles,
                                torch.arange(num_tiles + 1, device=dy.device))
    for t in range(num_tiles):
        run = order[starts[t]:starts[t + 1]]
        for a0 in range(0, run.shape[0], plan.cap):
            chunk = run[a0:a0 + plan.cap]
            for c in torch.unique(ids[chunk]).tolist():
                mine = chunk[ids[chunk] == c]
                terms = g[rows[mine]] * wf[mine][:, None]
                if a0 > 0:
                    d_src[c] = d_src[c] + _sum_in_segments(terms)
                else:
                    d_src[c] = _sum_in_segments(terms)
    return d_src


class BackwardPlan(NamedTuple):
    tile: int           # sources per tile (at most; tile t: t, t + tiles, ...)
    passes: int         # radix passes over the tile ids
    digit_bits: int     # bits of a pass's digit
    cap: int            # slots of a tile's run sorted in shared memory at a time
    part_groups: int    # lane groups of a round of hub segments
    smem: int           # shared bytes of the tile kernel's block


def backward_plan(num_src: int, width: int, elt_bytes: int, vec: int) -> BackwardPlan:
    """The backward's tiles and shared memory for ``num_src`` sources and
    rows of ``width`` elements of ``elt_bytes`` loaded ``vec`` at a time:
    as many tiles as whole waves of the tile kernel's blocks fill within one
    10-bit radix digit (924), of at most ``MAX_TILE`` sources each (more
    tiles, and radix passes, beyond); as many slots of a run in shared
    memory as its budget leaves beside the kernel's other arrays (its
    carving)."""
    wave_tiles = H100_SMS * max(1, (1 << MAX_DIGIT_BITS) // H100_SMS)
    tile = min(MAX_TILE, max(1, -(-num_src // wave_tiles)))
    key_bits = max(-(-num_src // tile) - 1, 0).bit_length()
    passes = 1 if key_bits <= MAX_DIGIT_BITS else -(-key_bits // MAX_DIGIT_BITS)
    digit_bits = max(1, -(-key_bits // passes))
    nvec = width // vec
    ll, nv = _lanes(nvec)
    pw = (1 << ll) * nv * vec
    fpad = -(-nvec // ((1 << ll) * nv)) * pw
    part_groups = max(1, min(TILE_THREADS >> ll, PART_FLOATS // pw))
    fixed = 4 * (tile * (TILE_WARPS + 1) + 2 * (tile + 1)) + 4 * part_groups * pw + 8 * fpad
    cap = min(TILE_CAP, (TILE_SMEM_BYTES - fixed) // 8 // 2 * 2)
    if cap < TILE_THREADS:
        raise ValueError(f"rows of {width} elements leave no room for the backward's "
                         f"slots in {TILE_SMEM_BYTES} bytes of shared memory")
    return BackwardPlan(tile, passes, digit_bits, cap, part_groups, fixed + 8 * cap)


def serial_walks(idx, num_src: int):
    """(longest serial walk, partials) of the backward on this draw: the
    most slots one lane group sums (a source's, up to ``SPLIT``) and the
    segment partials added into the source with the most slots."""
    most = int(torch.bincount(idx.reshape(-1).long().clamp(0, num_src - 1),
                              minlength=num_src).max()) if idx.numel() else 0
    return min(most, SPLIT), (-(-most // SPLIT) if most > SPLIT else 0)


def _vec_elements(width: int, elt_bytes: int, tensors) -> int:
    """Elements per lane vector: the largest power of two that divides
    ``width``, spans at most 16 bytes and keeps every base address aligned."""
    vec = 1
    while 2 * vec * elt_bytes <= 16 and width % (2 * vec) == 0 and all(
            t.data_ptr() % (2 * vec * t.element_size()) == 0 for t in tensors):
        vec *= 2
    return vec


def _check_aggregate(dense, idx, w):
    _check_cuda([dense, ("idx", idx), ("w", w)], dense[1].device)
    name, t = dense
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if t.dim() != 2 or t.shape[1] < 1:
        raise ValueError(f"{name} must be [rows, F] with F >= 1, got {tuple(t.shape)}")
    if idx.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError("idx must be int32 and w float32")
    if idx.dim() != 2 or w.shape != idx.shape:
        raise ValueError(f"idx and w must be one [k, S] shape: {tuple(idx.shape)}, "
                         f"{tuple(w.shape)}")
    if w.requires_grad:
        raise ValueError("the fixed-k kernels take w as a constant (sampler weights); "
                         "w.requires_grad is set")
    if idx.numel() >= 2 ** 31:
        raise ValueError(f"the fixed-k kernels index the {tuple(idx.shape)} draw with int32")


def _launch_aggregate(symbol: str, dense, idx, w, out, num_src: int, extra=None):
    """Call ``symbol`` with the arguments every aggregation entry takes, then
    ``extra(vec)`` where given: the entry's own ``(ctypes type, value)``
    pairs for the lane-vector width ``vec``."""
    k, S = idx.shape
    F = dense.shape[1]
    vec = _vec_elements(F, dense.element_size(), [dense, out])
    pairs = extra(vec) if extra is not None else []
    types, values = [t for t, _ in pairs], [v for _, v in pairs]
    fn = _build.kernel_function("fixed_k.cu", symbol,
                                [_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, *types, _P])
    with torch.cuda.device(dense.device):
        stream = torch.cuda.current_stream(dense.device).cuda_stream
        rc = fn(dense.data_ptr(), _DTYPE_CODES[dense.dtype], vec, idx.data_ptr(), w.data_ptr(),
                out.data_ptr(), num_src, S, k, F, *values, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: cudaError {rc}")


def launch_fixed_k_forward(src, idx, w):
    """Launch the forward kernel; returns ``out`` as ``fixed_k_forward_plain``
    does. Counts each launch (``launches.fixed_k_forward``)."""
    _check_aggregate(("src", src), idx, w)
    n, S = src.shape[0], idx.shape[1]
    out = torch.empty((S, src.shape[1]), dtype=src.dtype, device=src.device)
    if S == 0:
        return out
    if n == 0:
        raise ValueError("src has no rows to gather")
    _launch_aggregate("tfg_fixed_k_forward", src, idx, w, out, n)
    count("launches.fixed_k_forward")
    return out


def launch_fixed_k_backward(dy, idx, w, num_src: int):
    """Launch the backward: the draw bucketed by source tile (a stable
    radix pass: a digit count, a three-launch scan and a scatter), then the
    tile kernel's gather of the tiles' runs (``backward_plan`` sizes it).
    Returns ``d_src`` float32 [num_src, F] as ``fixed_k_backward_plain``
    does. Adds each kernel it launches to ``launches.fixed_k_backward``
    (``fixed_k_backward_launches(num_src)`` per call) and each call to
    ``calls.fixed_k_backward``."""
    _check_aggregate(("dy", dy), idx, w)
    if dy.shape[0] != idx.shape[1]:
        raise ValueError(f"dy must have {idx.shape[1]} rows, got {dy.shape[0]}")
    if idx.shape[1] == 0 or idx.shape[0] == 0:
        return torch.zeros((num_src, dy.shape[1]), dtype=torch.float32, device=dy.device)
    if num_src == 0:
        raise ValueError("no source rows to scatter into")
    d_src = torch.empty((num_src, dy.shape[1]), dtype=torch.float32, device=dy.device)
    nbytes = _build.kernel_function("fixed_k.cu", "tfg_fixed_k_backward_scratch_bytes",
                                    [_I, ctypes.c_longlong], restype=ctypes.c_longlong)
    scratch = torch.empty(nbytes(num_src, idx.numel()), dtype=torch.uint8, device=dy.device)
    launched = ctypes.c_int(0)

    def extra(vec):
        plan = backward_plan(num_src, dy.shape[1], dy.element_size(), vec)
        return [(_I, plan.tile), (_I, plan.cap), (_I, plan.part_groups),
                (_P, scratch.data_ptr()), (_P, ctypes.addressof(launched))]
    _launch_aggregate("tfg_fixed_k_backward", dy, idx, w, d_src, num_src, extra)
    count("launches.fixed_k_backward", launched.value)
    count("calls.fixed_k_backward")
    return d_src


def fixed_k_backward_launches(num_src: int) -> int:
    """Kernels one backward call launches for ``num_src`` sources: five per
    radix pass over the tile ids (count, three scan launches, scatter; one
    pass up to 1,024 tiles: 524,288 sources), the tiles' run starts when
    there are several passes, then the tile kernel: 6 in one pass."""
    passes = backward_plan(num_src, 1, 4, 1).passes
    return 5 * passes + (passes > 1) + 1




def _run(backward: bool, plain: bool, dense, *args):
    if dense.is_cuda and not plain:
        return (launch_fixed_k_backward if backward else launch_fixed_k_forward)(dense, *args)
    if not plain and dense.device.type != "cpu":
        raise NotImplementedError(f"no fixed-k aggregation kernel for device {dense.device}")
    return (fixed_k_backward_plain if backward else fixed_k_forward_plain)(dense, *args)


class _FixedKAggregate(torch.autograd.Function):
    """``out = Σ_j w[j]·src[idx[j]]``; the backward gives ``d_src`` only:
    ``idx`` and ``w`` are the sampler's constants."""

    @staticmethod
    @span("tfg.ops.fixed_k.forward")
    def forward(ctx, src, idx, w, plain):
        ctx.save_for_backward(idx, w)
        ctx.num_src, ctx.src_dtype, ctx.plain = src.shape[0], src.dtype, plain
        return _run(False, plain, src, idx, w)

    @staticmethod
    @span("tfg.ops.fixed_k.backward")
    def backward(ctx, dy):
        idx, w = ctx.saved_tensors
        d_src = _run(True, ctx.plain, dy.contiguous(), idx, w, ctx.num_src)
        return d_src.to(ctx.src_dtype), None, None, None


def fixed_k_aggregate(src, idx, w):
    """``out[s] = Σ_j w[j, s] · src[clip(idx[j, s], 0, n - 1)]`` over a
    slot-major draw (``idx`` int32 and ``w`` float32 [k, S]), in ``src``'s
    dtype (float32 or bfloat16), summed in float32; differentiable in
    ``src``. Raises if ``w`` requires grad: the sampler's weights are
    constants here."""
    if w.requires_grad:
        raise ValueError("fixed_k_aggregate does not differentiate the sampler's weights; "
                         "pass w detached")
    if src.dim() != 2 or idx.dim() != 2 or w.shape != idx.shape:
        raise ValueError(f"src must be [n, F] and idx, w one [k, S] shape: "
                         f"{tuple(src.shape)}, {tuple(idx.shape)}, {tuple(w.shape)}")
    return _FixedKAggregate.apply(src.contiguous(), idx.int().contiguous(),
                                  w.float().contiguous(), _config.plain_versions)


# ---------------------------------------------------------------------------
# least traffic and work, for the bounds of chip_smoke.py and the bench
# ---------------------------------------------------------------------------

def draw_pass_bytes(k: int, num_rows: int, nnz: int, weighted: bool) -> int:
    """Least bytes of one draw: the integers read and idx, w written (4
    bytes each per slot), row_start and degree read, and the column (and
    weight) entries the slots pick, at most the whole table."""
    slots = k * num_rows
    return 12 * slots + 8 * num_rows + 4 * min(slots, nnz) * (2 if weighted else 1)


def aggregate_pass_bytes(num_src: int, k: int, num_rows: int, width: int, elt_bytes: int,
                         backward: bool = False) -> int:
    """Least bytes of one aggregation pass: idx and w read (8 bytes per
    slot); forward: src [num_src, F] read and out [S, F] written in the
    dtype; backward: dy [S, F] read in the dtype and d_src [num_src, F]
    written in float32."""
    slots = k * num_rows
    if backward:
        return 8 * slots + num_rows * width * elt_bytes + num_src * width * 4
    return 8 * slots + (num_src + num_rows) * width * elt_bytes


def aggregate_pass_flops(k: int, num_rows: int, width: int) -> int:
    """Flops of one aggregation pass: a multiply-add per slot and feature."""
    return 2 * k * num_rows * width
