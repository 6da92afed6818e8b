"""Simulation jobs finished in the window over the window's length."""


def read(rec):
    return rec.attempted / rec.window_s if rec.window_s > 0 else None
