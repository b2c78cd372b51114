"""Global kernel-policy knobs (JAX counterpart: ``tf_geometric_tpu/ops/config.py``).

``ell_compute_dtype``: when set (e.g. ``torch.bfloat16``), the CSR SpMM casts
the dense operand to this dtype for the gather and casts the result back.
The kernel accumulates in float32 whatever the operand dtype. None preserves
the operand dtype exactly. The JAX module's other knobs tune its TPU kernels
and have no counterpart here.

``plain_versions``: while true (inside ``use_plain_versions()``), the ops
run their kernels' plain PyTorch versions on CUDA tensors too, with the
same autograd structure: the on-card reference that ``chip_smoke.py`` holds
the kernels' training steps against. Each op reads it when it is called,
so a backward follows its forward's choice.
"""
from __future__ import annotations

import contextlib

ell_compute_dtype = None
plain_versions = False


def set_ell_compute_dtype(dtype) -> None:
    global ell_compute_dtype
    ell_compute_dtype = dtype


@contextlib.contextmanager
def use_plain_versions():
    """Run the ops' plain versions on every device within the block."""
    global plain_versions
    prev, plain_versions = plain_versions, True
    try:
        yield
    finally:
        plain_versions = prev
