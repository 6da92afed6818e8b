"""The whole round's share of the card's peak: the least time the window's
finished jobs need (each unit's tick of int8 MACs at peak rate or of its
weights and state at peak bandwidth, whichever is larger, counted from the
jobs' inputs) over the window's time."""


def read(rec):
    if not rec.bound_s or rec.window_s <= 0:
        return None
    return 100.0 * rec.bound_s / rec.window_s
