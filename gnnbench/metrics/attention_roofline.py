"""The attention passes' least time (``counts/<model>.py``, kind
``attention``) over their measured device time ``attention_ms``, in %."""
from gnnbench.harness.counts import least_seconds


def read(rec):
    ms = rec.read("attention_ms")
    ops = [o for o in rec.work() if o["kind"] == "attention"]
    if not ms or not ops:
        return None
    return 100.0 * least_seconds(ops) * 1e3 / ms
