"""The traced stretch's ``repro_torch.dispatch.fetch`` spans (the host
blocked until a dispatch's flags are on the host, which waits for the
dispatch) over its simulations."""
from vpbench import hostspans


def read(rec):
    d, n = hostspans.durations(rec, hostspans.FETCH), hostspans.jobs(rec)
    return sum(d) / n * 1e3 if n else None
