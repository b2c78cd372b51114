"""The 95th percentile of the window's per-step times, each the device time
between the events recorded after consecutive steps (linear interpolation
between the order statistics)."""
import statistics


def read(rec):
    t = rec.step_times_ms
    if len(t) < 20:
        return None
    return statistics.quantiles(t, n=20, method="inclusive")[18]
