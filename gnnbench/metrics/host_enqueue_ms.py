"""Host dispatch: the host clock around one step's call, started on an idle
device queue so that no launch waits for room; the mean over the steps
measured after the traced span."""
import statistics


def read(rec):
    return statistics.fmean(rec.host_enqueue_ms) if rec.host_enqueue_ms else None
