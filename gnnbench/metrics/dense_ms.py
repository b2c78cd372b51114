"""Device ms per step of the dense products (cuBLAS GEMM kernels and their
split-K reductions)."""

KERNELS = ("gemm", "gemv", "splitkreduce")


def read(rec):
    return rec.profile.device_ms_per_step(KERNELS) if rec.profile is not None else None
