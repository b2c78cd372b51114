"""Set-up: from the start of the process to the first timed step (imports,
the device's context, the graph and weights, the model and its cache, the
kernels' build where none is found, the checked first steps and warm-up)."""


def read(rec):
    return rec.setup_s
