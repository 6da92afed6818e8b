"""The instruction-slot scan's device time in the traced stretch over the
simulated instructions retired there."""


def read(rec):
    if rec.trace is None or not rec.trace_instrs:
        return None
    scans = rec.trace.ops("slot_scan")
    if len(scans) < rec.trace_rounds:  # one launch a round, or the trace is incomplete
        return None
    busy = sum(e - s for _, s, e in scans)
    return busy / rec.trace_instrs * 1e9 if busy > 0 else None
