"""The whole step's least time (every operation of ``counts/<model>.py``:
the larger of its flops at each dtype's peak and its bytes at the memory's
rate) over the measured time per step of the run's window (``step_ms``), in
%. The window is timed without the profiler, whose host overhead would
lengthen a step that the host paces. Read only where the trace saw the
device work (a run on the card)."""
from gnnbench.harness.counts import least_seconds


def read(rec):
    ops, step_ms = rec.work(), rec.read("step_ms")
    if rec.profile is None or not rec.profile.ops or not ops or not step_ms:
        return None
    return 100.0 * least_seconds(ops) * 1e3 / step_ms
