"""The window's wall time over the simulated instructions retired in it."""


def read(rec):
    return rec.window_s / rec.instrs * 1e9 if rec.instrs else None
