"""The fixed-k aggregation's least time (``counts/<model>.py``, kind
``fixed_k``) over its measured device time ``fixed_k_ms``, in %."""
from gnnbench.harness.counts import least_seconds


def read(rec):
    ms = rec.read("fixed_k_ms")
    ops = [o for o in rec.work() if o["kind"] == "fixed_k"]
    if not ms or not ops:
        return None
    return 100.0 * least_seconds(ops) * 1e3 / ms
