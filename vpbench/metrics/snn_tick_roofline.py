"""The fused LIF tick's bound over its device time in the traced stretch:
bytes at peak bandwidth, each input read once and each output written once,
the weights of the units that fire (``bounds.tick_bytes``; the fire count
is every unit tick the stretch's jobs need)."""


def read(rec):
    if rec.trace is None or rec.tick_bound_s is None:
        return None
    ticks = rec.trace.ops("snn_tick")
    if len(ticks) != rec.trace_rounds:  # one launch a round, or the trace is incomplete
        return None
    busy = sum(e - s for _, s, e in ticks)
    return 100.0 * rec.tick_bound_s / busy if busy > 0 else None
