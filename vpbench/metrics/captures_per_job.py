"""Dispatch graphs captured in the traced stretch (its
``repro_torch.graph.capture`` spans) over its jobs (``hostspans.jobs``)."""
from vpbench import hostspans


def read(rec):
    d, n = hostspans.durations(rec, hostspans.CAPTURE), hostspans.jobs(rec)
    return len(d) / n if n else None
