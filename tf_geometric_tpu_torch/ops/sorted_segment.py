"""Sorted segment sum: Kernel B, its plain version and its wrapper.

Counterpart of ``tf_geometric_tpu/ops/pallas_segment.py``:
``pallas_sorted_segment_sum`` (the JAX package's only ``pl.pallas_call``) and
its entry ``sorted_segment_sum_mxu``. The CSR SpMM's hub merge, the job of
the sorted ``segment_sum`` in ``tf_geometric_tpu/ops/ell_bucketed.py``
(``_side_matmul``), runs in Kernel A's launch (``ops/csr_spmm.py``); Kernel
B keeps the same sum as a kernel of its own, with ``rows`` for sums into
listed rows of an existing output.

The TPU kernel planned 512-edge chunks on the host, reduced each chunk with a
one-hot 512 x 512 MXU contraction and folded the chunk partials with a
second segment sum. None of that plan carries over to Hopper: the segment
pointer already says where each segment starts, one warp sums one segment in
float32 (``csrc/sorted_segment.cu``), and there is neither a fold nor an
atomic. The kernel is bound by bytes: each message element is read once for
one add. Segments that name their output rows (``rows``) need a grid of
only as many warps as segments, however many rows the output has.

``segment_sum_csr`` dispatches on the device of its input: a CPU tensor takes
the plain PyTorch version, a CUDA tensor launches the kernel, and a failed
launch raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import count, span
from . import _build

__all__ = ["sorted_segment_sum", "segment_sum_csr", "sorted_segment_sum_plain",
           "launch_sorted_segment_sum"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_seg_ptr(msg, seg_ptr, out, rows):
    if msg.dim() != 2:
        raise ValueError(f"msg must be [M, F], got shape {tuple(msg.shape)}")
    if seg_ptr.dim() != 1 or seg_ptr.shape[0] < 1:
        raise ValueError("seg_ptr must be a non-empty 1-D tensor [S + 1]")
    num_segments = seg_ptr.shape[0] - 1
    if rows is None:
        if out.dim() != 2 or out.shape != (num_segments, msg.shape[1]):
            raise ValueError(f"out must be [{num_segments}, {msg.shape[1]}], "
                             f"got {tuple(out.shape)}")
    else:
        if rows.shape != (num_segments,):
            raise ValueError(f"rows must be [{num_segments}], got {tuple(rows.shape)}")
        if out.dim() != 2 or out.shape[1] != msg.shape[1]:
            raise ValueError(f"out must be [R, {msg.shape[1]}], got {tuple(out.shape)}")


def sorted_segment_sum_plain(msg, seg_ptr, out=None, rows=None):
    """Plain PyTorch version of Kernel B.

    ``out[r_s] (+)= Σ msg[seg_ptr[s]:seg_ptr[s + 1]]`` for each segment
    ``s``, summed in float32, where ``r_s = rows[s]`` (distinct rows) or
    ``s`` when ``rows`` is None. With ``out`` given, the sums are added into
    it in place (and it is returned); otherwise a new tensor of ``msg``'s
    dtype with one row per segment is returned (``rows`` then must be None).
    """
    num_segments = seg_ptr.shape[0] - 1
    ptr = seg_ptr.long()
    lengths = ptr[1:] - ptr[:-1]
    seg_of_msg = torch.repeat_interleave(
        torch.arange(num_segments, device=msg.device), lengths)
    n = seg_of_msg.shape[0]
    sums = torch.zeros((num_segments, msg.shape[1]), dtype=torch.float32,
                       device=msg.device)
    sums.index_add_(0, seg_of_msg, msg[ptr[0]:ptr[0] + n].float())
    if out is None:
        if rows is not None:
            raise ValueError("rows needs out")
        return sums.to(msg.dtype)
    _check_seg_ptr(msg, seg_ptr, out, rows)
    if rows is None:
        out.copy_(out.float() + sums)
    else:
        idx = rows.long()
        out.index_copy_(0, idx, (out.index_select(0, idx).float() + sums).to(out.dtype))
    return out


def launch_sorted_segment_sum(msg, seg_ptr, out, accumulate: bool, rows=None):
    """Launch Kernel B on ``msg`` [M, F] (float32 or bfloat16), ``seg_ptr``
    [S + 1] int32, ``out`` [R, F] (float32 or bfloat16) and, optionally,
    ``rows`` [S] int32 (distinct rows of ``out``, in ``[0, R)``; without
    them R = S and segment s writes row s). All are contiguous CUDA tensors
    on one device. Counts each launch (``launches.sorted_segment_sum``)."""
    tensors = [("msg", msg), ("seg_ptr", seg_ptr), ("out", out)]
    if rows is not None:
        tensors.append(("rows", rows))
    for name, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != msg.device:
            raise ValueError(f"{name} is on {t.device}, msg on {msg.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if msg.dtype not in _DTYPE_CODES or out.dtype not in _DTYPE_CODES:
        raise TypeError(f"msg/out dtypes must be float32 or bfloat16, got "
                        f"{msg.dtype}/{out.dtype}")
    if seg_ptr.dtype != torch.int32 or (rows is not None and rows.dtype != torch.int32):
        raise TypeError("seg_ptr and rows must be int32")
    _check_seg_ptr(msg, seg_ptr, out, rows)
    num_segments, num_features = seg_ptr.shape[0] - 1, out.shape[1]
    if num_segments == 0 or num_features == 0:
        return out
    fn = _build.kernel_function(
        "sorted_segment.cu", "tfg_sorted_segment_sum",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p])
    with torch.cuda.device(msg.device):
        stream = torch.cuda.current_stream(msg.device).cuda_stream
        rc = fn(msg.data_ptr(), _DTYPE_CODES[msg.dtype], seg_ptr.data_ptr(),
                None if rows is None else rows.data_ptr(), out.data_ptr(),
                _DTYPE_CODES[out.dtype], num_segments, num_features,
                int(accumulate), stream)
    if rc != 0:
        raise RuntimeError(f"sorted_segment_sum kernel launch failed: cudaError {rc}")
    count("launches.sorted_segment_sum")
    return out


@span("tfg.ops.sorted_segment.forward")
def segment_sum_csr(msg, seg_ptr, out=None, rows=None):
    """``out[r_s] (+)= Σ msg[seg_ptr[s]:seg_ptr[s + 1]]`` (``r_s = rows[s]``,
    or ``s``): Kernel B for CUDA tensors, the plain version for CPU tensors.
    ``out`` given: accumulate into it in place; otherwise return a new
    tensor of ``msg``'s dtype."""
    if msg.is_cuda:
        if out is None:
            if rows is not None:
                raise ValueError("rows needs out")
            out = torch.empty((seg_ptr.shape[0] - 1, msg.shape[1]),
                              dtype=msg.dtype, device=msg.device)
            return launch_sorted_segment_sum(msg.contiguous(), seg_ptr, out, False)
        return launch_sorted_segment_sum(msg.contiguous(), seg_ptr, out, True, rows)
    if msg.device.type != "cpu":
        raise NotImplementedError(f"no sorted segment sum for device {msg.device}")
    return sorted_segment_sum_plain(msg, seg_ptr, out, rows)


def sorted_segment_sum(msg, rows_sorted, num_rows: int):
    """``out[r] = Σ_{i: rows_sorted[i] = r} msg[i]`` for a row-sorted stream.

    Same semantics as JAX ``sorted_segment_sum_mxu``: rows equal to
    ``num_rows`` (padding sentinels, sorted last) are dropped.
    """
    rows = torch.as_tensor(rows_sorted, device=msg.device)
    bounds = torch.arange(num_rows + 1, device=msg.device, dtype=rows.dtype)
    seg_ptr = torch.searchsorted(rows, bounds).to(torch.int32)
    return segment_sum_csr(msg, seg_ptr)
