"""The mean of each job's ``Controller.capture_seconds``: the warm-up round
and the capture of its dispatch graph."""


def read(rec):
    if not rec.capture_s:
        return None
    return sum(rec.capture_s) / len(rec.capture_s) * 1e3
