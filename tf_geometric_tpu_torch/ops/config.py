"""Global kernel-policy knob (JAX counterpart: ``tf_geometric_tpu/ops/config.py``).

``ell_compute_dtype``: when set (e.g. ``torch.bfloat16``), the CSR SpMM casts
the dense operand to this dtype for the gather and casts the result back.
The kernel accumulates in float32 whatever the operand dtype. None preserves
the operand dtype exactly. The JAX module's other knobs tune its TPU kernels
and have no counterpart here.
"""
from __future__ import annotations

ell_compute_dtype = None


def set_ell_compute_dtype(dtype) -> None:
    global ell_compute_dtype
    ell_compute_dtype = dtype
