"""Device ms per step of the neighbour draws: ``fixed_k_draw_kernel``
(``csrc/fixed_k.cu``) and the ``torch.randint`` kernel before it, whose
name holds ``random_from_to_kernel`` (PyTorch's
``distribution_elementwise_grid_stride_kernel`` instance for
``random_from_to``). A configuration that draws no keep masks launches no
other kernel of that name in a step."""

KERNELS = ("fixed_k_draw_kernel", "random_from_to_kernel")


def read(rec):
    return rec.profile.device_ms_per_step(KERNELS) if rec.profile is not None else None
