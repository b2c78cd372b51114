"""Device ms per step of the fixed-k aggregation (``csrc/fixed_k.cu``): the
forward's ``fixed_k_gather_kernel``, and the backward's radix transpose of
the draw (``fixed_k_radix_count_kernel``, ``fixed_k_radix_scatter_kernel``,
the three ``fixed_k_scan_*`` launches, ``fixed_k_tile_ptr_kernel``) and its
``fixed_k_tile_kernel``."""

KERNELS = ("fixed_k_gather_kernel", "fixed_k_radix_", "fixed_k_scan_",
           "fixed_k_tile_ptr_kernel", "fixed_k_tile_kernel")


def read(rec):
    return rec.profile.device_ms_per_step(KERNELS) if rec.profile is not None else None
