"""Device operations (kernels, copies, fills) per step in the traced span."""


def read(rec):
    p = rec.profile
    return len(p.ops) / p.steps if p is not None and p.ops else None
