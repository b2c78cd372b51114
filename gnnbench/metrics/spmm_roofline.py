"""The aggregation passes' least time (``counts/<model>.py``, kind
``aggregation``) over their measured device time ``spmm_ms``, in %."""
from gnnbench.harness.counts import least_seconds


def read(rec):
    ms = rec.read("spmm_ms")
    ops = [o for o in rec.work() if o["kind"] == "aggregation"]
    if not ms or not ops:
        return None
    return 100.0 * least_seconds(ops) * 1e3 / ms
