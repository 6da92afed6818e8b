"""100 minus the share of the traced stretch in which some operation ran on
the device (the union of their intervals)."""
from vpbench import devtrace


def read(rec):
    if rec.trace is None or not rec.trace.device_ops or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - devtrace.union_s(rec.trace.device_ops) / rec.trace.window_s)
