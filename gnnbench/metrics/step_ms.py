"""Time per training step: the window's host-clock length, from the first
step's dispatch to the synchronization after the last, over the steps it
completed."""


def read(rec):
    return rec.window_s * 1e3 / rec.steps if rec.steps else None
