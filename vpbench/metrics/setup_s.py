"""Process start to the window's start: imports, the kernels' build or load,
the jobs made and built, and the warm-up."""


def read(rec):
    return rec.setup_s
