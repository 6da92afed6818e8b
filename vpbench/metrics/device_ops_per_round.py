"""Operations the device ran in the traced stretch (kernels, copies, fills),
over the rounds the program ran in it."""


def read(rec):
    if rec.trace is None or not rec.trace_rounds or not rec.trace.device_ops:
        return None
    return len(rec.trace.device_ops) / rec.trace_rounds
