"""Device ms per step of the CSR aggregation: Kernel A
(``csrc/csr_spmm.cu``, its hub merge in the launch) and Kernel B
(``csrc/sorted_segment.cu``) where a path launches it apart."""

KERNELS = ("csr_spmm_kernel", "sorted_segment_sum_kernel")


def read(rec):
    return rec.profile.device_ms_per_step(KERNELS) if rec.profile is not None else None
