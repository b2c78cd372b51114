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

The backward gathers too: it sorts the draw by source id (on the card a
stable radix sort, so each source's slots keep their slot order), then
gathers ``w · dy`` rows into each source row, as the forward gathers source
rows into each destination, with no float atomics: the kernel's sums run in
one order in every run, so the backward is bitwise reproducible.

Bound on the H100: bytes (``draw_pass_bytes``, ``aggregate_pass_bytes``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import config as _config

__all__ = ["draw_fixed_k_plain", "launch_draw_fixed_k", "draw_fixed_k_from_ints",
           "fixed_k_aggregate", "fixed_k_forward_plain", "fixed_k_backward_plain",
           "launch_fixed_k_forward", "launch_fixed_k_backward", "draw_pass_bytes",
           "fixed_k_backward_launches", "aggregate_pass_bytes", "aggregate_pass_flops"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


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
    ``draw_fixed_k_plain`` does. Counts each launch in ``.launches``."""
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
    launch_draw_fixed_k.launches += 1
    return idx, weight


launch_draw_fixed_k.launches = 0


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


def _launch_aggregate(symbol: str, dense, idx, w, out, num_src: int, *extra):
    k, S = idx.shape
    F = dense.shape[1]
    if k * S >= 2 ** 31:
        raise ValueError(f"the fixed-k kernels index the {k} x {S} draw with int32")
    vec = _vec_elements(F, dense.element_size(), [dense, out])
    fn = _build.kernel_function("fixed_k.cu", symbol,
                                [_P, _I, _I, _P, _P, _P, _I, _I, _I, _I] + [_P] * (len(extra) + 1))
    with torch.cuda.device(dense.device):
        stream = torch.cuda.current_stream(dense.device).cuda_stream
        rc = fn(dense.data_ptr(), _DTYPE_CODES[dense.dtype], vec, idx.data_ptr(), w.data_ptr(),
                out.data_ptr(), num_src, S, k, F, *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: cudaError {rc}")


def launch_fixed_k_forward(src, idx, w):
    """Launch the forward kernel; returns ``out`` as ``fixed_k_forward_plain``
    does. Counts each launch in ``.launches``."""
    _check_aggregate(("src", src), idx, w)
    n, S = src.shape[0], idx.shape[1]
    out = torch.empty((S, src.shape[1]), dtype=src.dtype, device=src.device)
    if S == 0:
        return out
    if n == 0:
        raise ValueError("src has no rows to gather")
    _launch_aggregate("tfg_fixed_k_forward", src, idx, w, out, n)
    launch_fixed_k_forward.launches += 1
    return out


def launch_fixed_k_backward(dy, idx, w, num_src: int):
    """Launch the backward: the draw transposed by source (a stable radix
    sort: per pass a digit count, a three-launch scan and a scatter; then
    the row pointers) and a gather through it. Returns ``d_src`` float32
    [num_src, F] as ``fixed_k_backward_plain`` does. Adds each kernel it
    launches to ``.launches`` (``fixed_k_backward_launches(num_src)`` per
    call) and each call to ``.calls``."""
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
    _launch_aggregate("tfg_fixed_k_backward", dy, idx, w, d_src, num_src, scratch.data_ptr(),
                      ctypes.addressof(launched))
    launch_fixed_k_backward.launches += launched.value
    launch_fixed_k_backward.calls += 1
    return d_src


def fixed_k_backward_launches(num_src: int) -> int:
    """Kernels one backward call launches for ``num_src`` sources: five per
    radix pass (count, three scan launches, scatter), one pass per 9 bits of
    ``num_src - 1`` (at least one), then the row pointers and the gather."""
    bits = max(num_src - 1, 0).bit_length()
    return 5 * max(1, -(-bits // 9)) + 2


launch_fixed_k_forward.launches = 0
launch_fixed_k_backward.launches = 0
launch_fixed_k_backward.calls = 0


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
    def forward(ctx, src, idx, w, plain):
        ctx.save_for_backward(idx, w)
        ctx.num_src, ctx.src_dtype, ctx.plain = src.shape[0], src.dtype, plain
        return _run(False, plain, src, idx, w)

    @staticmethod
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
