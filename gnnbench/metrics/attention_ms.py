"""Device ms per step of the three attention passes (``csrc/gat_attention.cu``:
forward, backward on the destination side, backward on the source side)."""

KERNELS = ("gat_forward_kernel", "gat_backward_dst_kernel", "gat_backward_src_kernel")


def read(rec):
    return rec.profile.device_ms_per_step(KERNELS) if rec.profile is not None else None
