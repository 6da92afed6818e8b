"""The window's wall time over the rounds the program ran in it (a bucket's
rounds are those of its longest job; a simulation's its ``rounds_run``)."""


def read(rec):
    return rec.window_s / rec.rounds * 1e6 if rec.rounds else None
