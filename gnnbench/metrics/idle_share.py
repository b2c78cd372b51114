"""The share of the traced span in which no operation ran on the device, in %."""


def read(rec):
    p = rec.profile
    if p is None or not p.ops or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
